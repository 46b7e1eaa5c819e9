"""Hopper kernels (``csrc/``: GNN aggregation, segment max, flash attention,
the SSD scan, and the backwards of GNN aggregation, flash attention and the
SSD scan), their wrappers and plain versions.

Nothing is built at import: :mod:`repro_torch.kernels.build` compiles the
CUDA sources at the first launch. The GNN entry points and
``mha_attention`` are exported here, as ``repro.kernels`` exports its
ops; the SSD scan is ``ops.ssd_scan``, since ``ssd_scan`` here names the
kernel's module."""
from repro_torch.kernels.ops import (
    gnn_aggregate,
    gnn_gat_aggregate,
    gnn_gather_aggregate,
    gnn_segment_max,
    mha_attention,
)

__all__ = [
    "gnn_aggregate",
    "gnn_gather_aggregate",
    "gnn_gat_aggregate",
    "gnn_segment_max",
    "mha_attention",
]
