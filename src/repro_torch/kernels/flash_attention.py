"""The flash-attention kernels' wrappers (``csrc/flash_attention.cu`` and
``csrc/flash_attention_backward.cu``).

:func:`flash_attention` replaces ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (``:91``) together with the ``vmap`` over (batch,
head) and the repeat of the KV heads around it in ``repro/kernels/ops.py::
mha_attention``: one launch covers every (batch, head) pair, and query
head h reads KV head h // (H / Hkv) in place. v's head width may differ
from q's and k's, as MLA's does (q and k 192 wide, v 128).

Dispatch follows the tensors' device: CPU tensors go to the plain version
(``ref.attention_ref``, differentiable); CUDA tensors launch the kernel or
raise. Under autograd (grad mode on, an input requiring grad) the CUDA
call goes through an autograd Function: the forward kernel also writes
each row's log-sum-exp, which the Function saves beside q, k, v and the
output, and the backward is :func:`flash_attention_backward`, a kernel of
its own (dQ, dK, dV; no TPU counterpart: the JAX package trains through
the plain attention, whose gradients these are). Under
``torch.utils.checkpoint`` the forward runs again before the backward and
saves its state anew. Each forward launch adds one to
``LAUNCHES["flash_attention"]``, each backward launch one to
``LAUNCHES["flash_attention_backward"]``.

On the card the forward's route is a static choice by dtype (the source's
header note has the details): bfloat16 runs the warp-specialised Hopper
kernel (TMA loads into a ring of mbarrier-guarded K and V stages, ``wgmma``
for Q.K^T and for P.V with P in registers, a producer warpgroup and two or
three consumer warpgroups, a persistent grid); float32 runs the scalar
kernel in the ``mma.sync`` accumulator layout, so it stays float32. The
bfloat16 kernel encodes its TMA tensor maps on the host at every launch
(host work only, so a launch can be captured in a CUDA graph). The
backward runs one SIMT design for both dtypes, accumulating in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library, on_cpu, wants_grad
from repro_torch.kernels.ref import attention_ref

__all__ = ["LAUNCHES", "reset_launches", "HEAD_DIMS", "launch_flash_attention", "flash_attention",
           "launch_flash_attention_backward", "flash_attention_backward"]

LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0}
# the (q/k, v) head widths the kernel is compiled for
HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128), (96, 64), (32, 32))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda_args(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(
            f"need q [B, Sq, H, D], k [B, Skv, Hkv, D] and v [B, Skv, Hkv, Dv], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair (Hkv | H)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    if (d, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head widths (q/k {d}, v {v.shape[3]}) not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if max(q.numel(), k.numel(), v.numel()) >= _INT_MAX or b > 65535 or h > 65535:
        raise ValueError(f"sizes out of the kernel's range: q {tuple(q.shape)} k {tuple(k.shape)}")


def launch_flash_attention(q, k, v, out, lse=None, *, causal: bool, window: int,
                           kv_offset: int) -> None:
    """Launch the kernel on checked CUDA tensors (``lse``: float32 [B, H,
    Sq], or None not to write it); counts nothing."""
    b, sq, h, d = q.shape
    code = library("flash_attention").flash_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b,
        sq,
        k.shape[1],
        h,
        k.shape[2],
        d,
        v.shape[3],
        _DTYPE_CODE[q.dtype],
        int(bool(causal)),
        int(window),
        int(kv_offset),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "flash_attention")


def launch_flash_attention_backward(q, k, v, o, dout, lse, dq, dk, dv, *, causal: bool,
                                    window: int, kv_offset: int) -> None:
    """Launch the backward kernels on checked CUDA tensors, with their
    float32 scratch allocated here (D = rowsum(dO o) [B, H, Sq], and dK, dV
    per query head [B, H, Skv, D / Dv] before the group sum); counts
    nothing."""
    b, sq, h, d = q.shape
    skv, hkv, dv_w = k.shape[1], k.shape[2], v.shape[3]
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, sq), **f32)
    dk_part = torch.empty((b, h, skv, d), **f32)
    dv_part = torch.empty((b, h, skv, dv_w), **f32)
    code = library("flash_attention_backward").flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), b, sq, skv, h, hkv, d, dv_w, _DTYPE_CODE[q.dtype],
        int(bool(causal)), int(window), int(kv_offset), torch.cuda.current_stream().cuda_stream,
    )
    check(code, "flash_attention_backward")


def _forward(q, k, v, lse, mask: dict) -> torch.Tensor:
    out = q.new_empty(q.shape[:3] + (v.shape[3],))
    with torch.cuda.device(q.device):
        launch_flash_attention(q, k, v, out, lse, **mask)
    LAUNCHES["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_offset):
        mask = dict(causal=causal, window=window, kv_offset=kv_offset)
        b, sq, h, _ = q.shape
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, lse, mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, dout, lse, **ctx.mask), None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Attention of q [B, Sq, H, D] over k [B, Skv, Hkv, D] and v [B, Skv,
    Hkv, Dv] (Hkv divides H): out [B, Sq, H, Dv] in q's dtype, with the
    masks and the 1/sqrt(D) scale of ``attention_ref``: query i at
    absolute position ``kv_offset + i``, causal, and a sliding window when
    ``window > 0``. On the card: float32 or bfloat16, (D, Dv) in
    ``HEAD_DIMS``, contiguous tensors; differentiable through the backward
    kernel."""
    if on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, kv_offset=kv_offset)
    _check_cuda_args(q, k, v)
    if wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, kv_offset)
    return _forward(q, k, v, None, dict(causal=causal, window=window, kv_offset=kv_offset))


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    kv_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each in its input's dtype and shape, of
    :func:`flash_attention`'s output o for its gradient ``dout``, with
    ``lse`` [B, H, Sq] float32 the forward kernel's log-sum-exp: the
    backward kernels, deterministic (no atomics). CUDA tensors only: on
    the CPU autograd differentiates the plain forward, and the plain twin
    is ``ref.attention_backward_ref``."""
    mask = dict(causal=causal, window=window, kv_offset=kv_offset)
    if on_cpu(q, k, v, o, dout, lse):
        raise ValueError("flash_attention_backward runs on the card; on the CPU autograd "
                         "differentiates the plain forward")
    _check_cuda_args(q, k, v)
    dout = dout.contiguous()
    if (o.shape != dout.shape or o.shape != q.shape[:3] + (v.shape[3],) or o.dtype != q.dtype
            or dout.dtype != q.dtype or not o.is_contiguous()):
        raise ValueError(f"o and dout must be {q.dtype} {q.shape[:3] + (v.shape[3],)}, got "
                         f"{o.dtype} {tuple(o.shape)} and {dout.dtype} {tuple(dout.shape)}")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [B, H, Sq], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        launch_flash_attention_backward(q, k, v, o, dout, lse, dq, dk, dv, **mask)
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv
