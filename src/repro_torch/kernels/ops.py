"""The GNN aggregation entry points the models call.

Counterparts of ``gnn_aggregate`` and ``gnn_gat_aggregate`` in
``repro/kernels/ops.py``, with the same names and argument order. A CUDA
tensor goes to the Hopper kernel, a CPU tensor to its plain version; there
is no switch to pick either, and no block sizes to tune.
``gnn_aggregate_and_count`` gives gcn/sage the sum and the degree from one
CSR index, where the JAX models call ``gnn_aggregate`` twice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gnn import (
    gat_softmax_aggregate,
    segment_spmm_ragged,
    segment_sum_and_count,
)

__all__ = ["gnn_aggregate", "gnn_aggregate_and_count", "gnn_gat_aggregate"]


def gnn_aggregate(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment-sum of gathered neighbor messages (GNN aggregation hotspot)."""
    return segment_spmm_ragged(msg, seg, num_segments)


def gnn_aggregate_and_count(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gnn_aggregate` and the valid edges per segment as an [n, 1]
    float32 column (the degree gcn/sage divide by), from one CSR index."""
    return segment_sum_and_count(msg, seg, num_segments)


def gnn_gat_aggregate(
    logits: torch.Tensor, msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """One-pass edge-softmax + weighted aggregate (GAT/HGT inner loop), for
    one head or for all heads at once (see :func:`gat_softmax_aggregate`)."""
    return gat_softmax_aggregate(logits, msg, seg, num_segments)
