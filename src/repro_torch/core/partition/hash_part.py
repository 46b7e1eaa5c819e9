"""Hash-based partitioners: random edge hash, 2D grid hash (vertex-cut) and
vertex hash (edge-cut).  These are the cheap baselines (GraphLearn uses hash
partitioning; DistributedNE uses 2D hash for its initial placement).

``RandomEdgePartitioner`` / ``Hash2DPartitioner`` wrap the free functions
behind the ``Partitioner`` protocol for the registry; the functions stay the
supported functional surface (they were always one-liners)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.partition.base import (
    DEFAULT_DIRECTION,
    PartitionerBase,
    PartitionPlan,
)
from repro_torch.graph.graph import HeteroGraph
from repro_torch.utils import stable_hash64

__all__ = [
    "random_edge_partition",
    "hash2d_partition",
    "vertex_hash_partition",
    "RandomEdgePartitioner",
    "Hash2DPartitioner",
]


def random_edge_partition(g: HeteroGraph, num_parts: int, seed: int = 0) -> np.ndarray:
    eid = np.arange(g.num_edges, dtype=np.int64)
    return (stable_hash64(eid, salt=seed) % np.uint64(num_parts)).astype(np.int16)


def _factor_grid(p: int) -> tuple[int, int]:
    r = int(np.sqrt(p))
    while p % r:
        r -= 1
    return r, p // r


def hash2d_partition(g: HeteroGraph, num_parts: int, seed: int = 0) -> np.ndarray:
    """Classic 2D grid: partition = (hash(src) mod R, hash(dst) mod C).

    Bounds the replication factor at R + C - 1 per vertex."""
    rows, cols = _factor_grid(num_parts)
    hs = stable_hash64(g.src, salt=seed) % np.uint64(rows)
    hd = stable_hash64(g.dst, salt=seed + 1) % np.uint64(cols)
    return (hs.astype(np.int64) * cols + hd.astype(np.int64)).astype(np.int16)


def vertex_hash_partition(g: HeteroGraph, num_parts: int, seed: int = 0) -> np.ndarray:
    """Edge-cut by vertex hash: returns a VERTEX assignment [N]."""
    vid = np.arange(g.num_vertices, dtype=np.int64)
    return (stable_hash64(vid, salt=seed) % np.uint64(num_parts)).astype(np.int16)


class _HashPartitioner(PartitionerBase):
    """Shared protocol adapter over a (g, num_parts, seed) -> edge_parts fn."""

    _fn = staticmethod(random_edge_partition)

    def partition(
        self,
        g: HeteroGraph,
        num_parts: int,
        *,
        seed: int = 0,
        direction: str = DEFAULT_DIRECTION,
    ) -> PartitionPlan:
        ep = self._fn(g, num_parts, seed=seed)
        return PartitionPlan.from_assignment(
            g, ep, num_parts, partitioner=self.name, seed=seed
        )


class RandomEdgePartitioner(_HashPartitioner):
    name = "random"
    _fn = staticmethod(random_edge_partition)


class Hash2DPartitioner(_HashPartitioner):
    name = "hash2d"
    _fn = staticmethod(hash2d_partition)
