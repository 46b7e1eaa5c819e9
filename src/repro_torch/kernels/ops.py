"""The kernel entry points the models call.

Counterparts of ``gnn_aggregate``, ``gnn_gather_aggregate``,
``gnn_gat_aggregate``, ``gnn_segment_max``, ``mha_attention`` and
``ssd_scan`` in ``repro/kernels/ops.py``, with the same names and
argument order. A CUDA tensor goes to the Hopper kernel, a CPU tensor to
its plain version. So there is no ``use_kernel`` (the tensors' device is
the switch), and no block sizes: the reference tiles edges for the MXU
and tunes the tiles (``repro/kernels/autotune.py``), where each kernel here
gives a destination row one thread group and sizes it from the row width.
``ragged=`` picks the call form, as in the reference: ids sorted with the
padding at the tail (the default), or in any order (``ragged=False``, the
dense forms: a stable radix sort of the ids on the card, then the same
CSR kernel).
``gnn_aggregate_and_count`` gives gcn/sage the sum and the degree from one
CSR index, where the JAX models call ``gnn_aggregate`` twice.
``gather_rows`` is the gather the training layers use where the JAX
models index ``z[src]``: its backward is the gather kernel, not an atomic
scatter-add.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_gnn import (
    gat_softmax_aggregate,
    gather_rows,
    gather_spmm,
    gather_spmm_ragged,
    segment_max,
    segment_spmm,
    segment_spmm_ragged,
    segment_sum_and_count,
)
from repro_torch.kernels.ssd_scan import ssd_scan_fused

__all__ = [
    "gnn_aggregate",
    "gnn_aggregate_and_count",
    "gnn_gather_aggregate",
    "gnn_gat_aggregate",
    "gnn_segment_max",
    "gather_rows",
    "mha_attention",
    "ssd_scan",
]


def gnn_aggregate(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int, *, ragged: bool = True
) -> torch.Tensor:
    """Segment-sum of gathered neighbor messages (GNN aggregation hotspot).

    ``ragged=True``: ``seg`` non-decreasing with its padding (-1) at the
    tail, as the engine and the batches give it (:func:`segment_spmm_ragged`).
    ``ragged=False``: ids in any order (:func:`segment_spmm`). Either way
    ids < 0 or >= num_segments are dropped."""
    if ragged:
        return segment_spmm_ragged(msg, seg, num_segments)
    return segment_spmm(msg, seg, num_segments)


def gnn_aggregate_and_count(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gnn_aggregate` and the valid edges per segment as an [n, 1]
    float32 column (the degree gcn/sage divide by), from one CSR index."""
    return segment_sum_and_count(msg, seg, num_segments)


def gnn_gather_aggregate(
    feats: torch.Tensor,
    idx: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
    idx_order: torch.Tensor | None = None,
    *,
    ragged: bool = True,
) -> torch.Tensor:
    """Fused gather+aggregate: out[s] = sum_{seg[e]==s} feats[idx[e]],
    without materializing the [E, D] message array.

    ``ragged=True``: ``seg`` sorted with the padding at the tail;
    differentiable in ``feats`` (see :func:`gather_spmm_ragged` for
    ``idx_order``). ``ragged=False``: ids in any order
    (:func:`gather_spmm`); takes no ``idx_order`` and, on the card, no
    gradient."""
    if ragged:
        return gather_spmm_ragged(feats, idx, seg, num_segments, idx_order)
    if idx_order is not None:
        raise ValueError("idx_order orders the ragged form's backward; ragged=False takes none")
    return gather_spmm(feats, idx, seg, num_segments)


def gnn_gat_aggregate(
    logits: torch.Tensor, msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """One-pass edge-softmax + weighted aggregate (GAT/HGT inner loop), for
    one head or for all heads at once (see :func:`gat_softmax_aggregate`)."""
    return gat_softmax_aggregate(logits, msg, seg, num_segments)


def gnn_segment_max(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max of x [E] over seg [E] (int32, any order; seg < 0 or
    >= num_segments is padding); empty segments, and segments whose max is
    not finite, give 0.0."""
    return segment_max(x, seg, num_segments)


def mha_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention with grouped KV heads (H a multiple of Hkv):
    one flash-attention launch for all (batch, head) pairs, no repeat of
    the KV heads. v may be narrower than q and k (MLA: Dv 128 under D
    192); the result is [B, Sq, H, Dv]."""
    return flash_attention(q, k, v, causal=causal, window=window, kv_offset=kv_offset)


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    A: torch.Tensor,  # [H]
    B_: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-head SSD scan with B and C in group form. Returns
    (y [B, S, H, P], final_state [B, H, P, N] float32), where the JAX op
    returns y alone: the Mamba-2 prefill hands the state to decode.
    ``init_state`` (default zeros) is the state before the first step."""
    a = dt * A[None, None, :]
    return ssd_scan_fused(x, a, dt, B_, C, chunk=chunk, init_state=init_state)
