"""The flash-attention kernel's wrapper (``csrc/flash_attention.cu``).

:func:`flash_attention` replaces ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (``:91``) together with the ``vmap`` over (batch,
head) and the repeat of the KV heads around it in ``repro/kernels/ops.py::
mha_attention``: one launch covers every (batch, head) pair, and query
head h reads KV head h // (H / Hkv) in place. v's head width may differ
from q's and k's, as MLA's does (q and k 192 wide, v 128).

Dispatch follows the tensors' device: CPU tensors go to the plain version
(``ref.attention_ref``, differentiable); CUDA tensors launch the kernel or
raise, and raise under autograd (no backward kernel yet). Each launch adds
one to ``LAUNCHES["flash_attention"]``.

On the card the route is a static choice by dtype (the source's header
note has the details): bfloat16 runs the warp-specialised Hopper kernel
(TMA loads into a ring of mbarrier-guarded K and V stages, ``wgmma`` for
Q.K^T and for P.V with P in registers, a producer warpgroup and two or
three consumer warpgroups, a persistent grid); float32 runs the scalar
kernel in the ``mma.sync`` accumulator layout, so it stays float32. The
bfloat16 kernel encodes its TMA tensor maps on the host at every launch
(host work only, so a launch can be captured in a CUDA graph).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, forbid_grad, library, on_cpu
from repro_torch.kernels.ref import attention_ref

__all__ = ["LAUNCHES", "reset_launches", "HEAD_DIMS", "launch_flash_attention", "flash_attention"]

LAUNCHES = {"flash_attention": 0}
# the (q/k, v) head widths the kernel is compiled for
HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128), (96, 64), (32, 32))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


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


def launch_flash_attention(q, k, v, out, *, causal: bool, window: int, kv_offset: int) -> None:
    """Launch the kernel on checked CUDA tensors; counts nothing."""
    b, sq, h, d = q.shape
    code = library("flash_attention").flash_attention(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
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
    ``HEAD_DIMS``, contiguous tensors."""
    if on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, kv_offset=kv_offset)
    _check_cuda_args(q, k, v)
    forbid_grad("flash_attention", q, k, v)
    out = q.new_empty(q.shape[:3] + (v.shape[3],))
    with torch.cuda.device(q.device):
        launch_flash_attention(q, k, v, out, causal=causal, window=window, kv_offset=kv_offset)
    LAUNCHES["flash_attention"] += 1
    return out
