"""``repro.core.partition`` — the balanced graph-partitioning subsystem.

One protocol (``Partitioner``), one artifact (``PartitionPlan``), one
registry (``PARTITIONERS``), and an explicit cached pipeline
(``PartitionPipeline``: partition -> reorder -> materialize).  Registered
entries::

    adadne / dne            lockstep-vectorized neighbor expansion (paper §III-B)
    adadne_loop / dne_loop  sequential reference implementations (benchmarks,
                            statistical-equivalence gate for the vectorized path)
    ldg                     chunked streaming edge-cut baseline (vertex owners)
    hash2d / random         hash baselines

The legacy free functions (``adadne``, ``distributed_ne``, ``ldg_edge_cut``,
...) remain as shims returning raw assignments; see docs/api.md for the
migration table.
"""
from repro_torch.core.partition.base import (
    PARTITIONERS,
    Partitioner,
    PartitionerBase,
    PartitionPlan,
    hosted_vertex_counts,
)
from repro_torch.core.partition.hash_part import (
    Hash2DPartitioner,
    RandomEdgePartitioner,
    hash2d_partition,
    random_edge_partition,
    vertex_hash_partition,
)
from repro_torch.core.partition.ldg import (
    LDGPartitioner,
    edge_cut_to_edge_assignment,
    ldg_edge_cut,
)
from repro_torch.core.partition.dne import (
    NEConfig,
    NeighborExpansionPartitioner,
    adadne,
    distributed_ne,
)
from repro_torch.core.partition.pipeline import (
    PartitionPipeline,
    PipelineResult,
    graph_fingerprint,
)

# -- registry population (one configured instance per entry) ----------------
for _p in (
    NeighborExpansionPartitioner(adaptive=True),
    NeighborExpansionPartitioner(adaptive=True, mode="loop"),
    NeighborExpansionPartitioner(adaptive=False),
    NeighborExpansionPartitioner(adaptive=False, mode="loop"),
    LDGPartitioner(),
    Hash2DPartitioner(),
    RandomEdgePartitioner(),
):
    if _p.name not in PARTITIONERS:  # idempotent under module reload
        PARTITIONERS.register(_p.name, _p)
del _p

__all__ = [
    "PARTITIONERS",
    "Partitioner",
    "PartitionerBase",
    "PartitionPlan",
    "PartitionPipeline",
    "PipelineResult",
    "NEConfig",
    "NeighborExpansionPartitioner",
    "LDGPartitioner",
    "Hash2DPartitioner",
    "RandomEdgePartitioner",
    "graph_fingerprint",
    "hosted_vertex_counts",
    "random_edge_partition",
    "hash2d_partition",
    "vertex_hash_partition",
    "ldg_edge_cut",
    "edge_cut_to_edge_assignment",
    "adadne",
    "distributed_ne",
]
