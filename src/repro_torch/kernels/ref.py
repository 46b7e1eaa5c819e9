"""Plain PyTorch versions of the GNN kernels on the inference path.

Counterparts of ``repro/kernels/ref.py:20-78``. The tests hold the CUDA
kernels and the JAX package against them, and the kernel wrappers use them
for tensors that lie on the CPU. ``seg == -1`` marks padding, and so does
an id ``>= num_segments`` (dropped, as ``jax.ops.segment_sum`` drops it).
"""
from __future__ import annotations

import torch

__all__ = [
    "segment_spmm_ref",
    "segment_spmm_ragged_ref",
    "segment_max_ref",
    "gat_softmax_aggregate_ref",
]


def _valid(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (seg >= 0) & (seg < num_segments)


def segment_spmm_ref(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum_{e: seg[e]==s} msg[e], summed in float32 and cast to
    msg's dtype, as the kernel does; padding dropped."""
    ok = _valid(seg, num_segments)
    out = msg.new_zeros((num_segments,) + tuple(msg.shape[1:]), dtype=torch.float32)
    return out.index_add_(0, seg[ok].long(), msg[ok].float()).to(msg.dtype)


def segment_spmm_ragged_ref(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The ragged kernel's tile skip changes nothing semantically."""
    return segment_spmm_ref(msg, seg, num_segments)


def segment_max_ref(
    x: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment max (padding excluded); empty segments yield 0.0."""
    ok = _valid(seg, num_segments)
    mx = x.new_full((num_segments,), float("-inf"))
    mx = mx.scatter_reduce(0, seg[ok].long(), x[ok], "amax")
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def gat_softmax_aggregate_ref(
    logits: torch.Tensor, msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """3-pass version of the one-pass kernel for one head: segment max,
    exp/normalize with the ``max(z, 1e-9)`` guard, weighted segment sum in
    float32, cast to msg's dtype. Empty segments return 0."""
    ok = _valid(seg, num_segments)
    seg0 = torch.where(ok, seg, torch.zeros_like(seg)).long()
    lf = logits.float()
    mx = segment_max_ref(lf, seg, num_segments)
    e = torch.where(ok, torch.exp(lf - mx[seg0]), torch.zeros_like(lf))
    z = lf.new_zeros(num_segments).index_add_(0, seg0, e)
    alpha = e / torch.clamp_min(z[seg0], 1e-9)
    weighted = torch.where(ok[:, None], msg.float(), 0.0) * alpha[:, None]
    out = lf.new_zeros((num_segments, msg.shape[1])).index_add_(0, seg0, weighted)
    return out.to(msg.dtype)
