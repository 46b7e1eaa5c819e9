"""Plain PyTorch versions of the GNN kernels and of their backwards.

Counterparts of ``repro/kernels/ref.py:20-78``. The tests hold the CUDA
kernels and the JAX package against them, and the kernel wrappers use them
(with autograd through them) for tensors that lie on the CPU. Their gathers
are ``index_select``, whose CPU backward (``index_add_``) adds in index
order, so a CPU training run repeats bit for bit. ``seg == -1``
marks padding, and so does an id ``>= num_segments`` (dropped, as
``jax.ops.segment_sum`` drops it); ``idx == -1`` marks a padding gather.

The ``*_backward_ref`` functions are the backwards written out from their
formulas, the twins of the backward kernels; the tests hold them against
``torch.autograd`` of the plain forwards.
"""
from __future__ import annotations

import torch

__all__ = [
    "segment_spmm_ref",
    "segment_spmm_ragged_ref",
    "gather_spmm_ref",
    "gather_spmm_ragged_ref",
    "gather_spmm_ragged_backward_ref",
    "segment_max_ref",
    "gat_softmax_aggregate_ref",
    "gat_softmax_aggregate_backward_ref",
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


def gather_spmm_ref(
    feats: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum_{e: seg[e]==s} feats[idx[e]], summed in float32 and cast
    to feats' dtype; edges with idx or seg padding are dropped."""
    ok = _valid(seg, num_segments) & (idx >= 0)
    out = feats.new_zeros((num_segments, feats.shape[1]), dtype=torch.float32)
    msg = feats.index_select(0, idx[ok].long()).float()
    return out.index_add_(0, seg[ok].long(), msg).to(feats.dtype)


def gather_spmm_ragged_ref(
    feats: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The ragged kernel's tile skip changes nothing semantically."""
    return gather_spmm_ref(feats, idx, seg, num_segments)


def gather_spmm_ragged_backward_ref(
    grad: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """d feats of :func:`gather_spmm_ref` for the upstream ``grad`` [n, D]:
    dfeats[f] = sum_{e: idx[e]==f} grad[seg[e]], the same function with the
    roles of ``idx`` and ``seg`` swapped."""
    n = grad.shape[0]
    seg_ok = torch.where(_valid(seg, n), seg, torch.full_like(seg, -1))
    return gather_spmm_ref(grad, seg_ok, idx, num_rows)


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
    float32, cast to msg's dtype. Empty segments return 0. The max is a
    shift the softmax does not depend on, so no gradient flows through it."""
    ok = _valid(seg, num_segments)
    seg0 = torch.where(ok, seg, torch.zeros_like(seg)).long()
    lf = logits.float()
    mx = segment_max_ref(lf.detach(), seg, num_segments)
    e = torch.where(ok, torch.exp(lf - mx.index_select(0, seg0)), torch.zeros_like(lf))
    z = lf.new_zeros(num_segments).index_add_(0, seg0, e)
    alpha = e / torch.clamp_min(z.index_select(0, seg0), 1e-9)
    weighted = torch.where(ok[:, None], msg.float(), 0.0) * alpha[:, None]
    out = lf.new_zeros((num_segments, msg.shape[1])).index_add_(0, seg0, weighted)
    return out.to(msg.dtype)


def gat_softmax_aggregate_backward_ref(
    grad: torch.Tensor,
    logits: torch.Tensor,
    msg: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d logits, d msg) of :func:`gat_softmax_aggregate_ref` for one head
    and the upstream ``grad`` [n, D], in float32. With
    alpha_e = exp(l_e - M_s) / max(Z_s, 1e-9) for the row s of edge e:
    dmsg[e] = alpha_e * g_s and dlogit[e] = alpha_e * (g_s . msg[e] - g_s . out_s).
    Padding edges get 0."""
    ok = _valid(seg, num_segments)
    seg0 = torch.where(ok, seg, torch.zeros_like(seg)).long()
    lf = logits.float()
    mx = segment_max_ref(lf, seg, num_segments)
    e = torch.where(ok, torch.exp(lf - mx[seg0]), torch.zeros_like(lf))
    z = lf.new_zeros(num_segments).index_add_(0, seg0, e)
    alpha = e / torch.clamp_min(z[seg0], 1e-9)
    out = gat_softmax_aggregate_ref(logits, msg, seg, num_segments).float()
    g = grad.float()
    g_e = torch.where(ok[:, None], g[seg0], 0.0)
    g_out = (g * out).sum(1)[seg0]
    dmsg = alpha[:, None] * g_e
    dlogit = torch.where(ok, alpha * ((g_e * msg.float()).sum(1) - g_out), 0.0)
    return dlogit, dmsg
