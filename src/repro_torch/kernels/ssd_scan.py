"""The SSD-scan kernel's wrapper (``csrc/ssd_scan.cu``).

:func:`ssd_scan_fused` replaces ``repro/kernels/ssd_scan.py::
ssd_scan_pallas`` (``:65``) together with the ``vmap`` over (batch, head)
around it, and takes the place of ``repro/models/transformer/ssm.py::
ssd_chunked_jnp`` (``:33``), which computes the same function: B and C in
group form, an optional initial state, and the final state returned.

Dispatch follows the tensors' device: CPU tensors go to the plain version
(``ref.ssd_chunked_ref``, differentiable); CUDA tensors launch the kernels
or raise, and raise under autograd (no backward kernel yet). A call runs
three CUDA kernels (chunk states, state passing, chunk output; see the
source's header) on float32 scratch the wrapper allocates, and adds one
to ``LAUNCHES["ssd_scan"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, forbid_grad, library, on_cpu
from repro_torch.kernels.ref import ssd_chunked_ref

__all__ = ["LAUNCHES", "reset_launches", "HEAD_DIMS", "STATE_DIMS", "kernel_chunk",
           "launch_ssd_scan", "ssd_scan_fused"]

LAUNCHES = {"ssd_scan": 0}
HEAD_DIMS = (16, 32, 64)  # P values the kernel is compiled for
STATE_DIMS = (32, 64, 128)  # N values

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


def _inner_contiguous(t: torch.Tensor, name: str) -> None:
    """[B, S, groups, width] with the last two dims packed (steps and
    batches may have any stride, as slices of a wider projection do); an
    empty tensor, whose strides may be anything, holds nothing to read."""
    if t.numel() and (t.stride(3) != 1 or t.stride(2) != t.shape[3]):
        raise ValueError(f"{name} must have its last two dims contiguous, strides {t.stride()}")


def _check_cuda_args(x, a, dt, B, C, init_state) -> None:
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"need x [B, S, H, P] and B, C [B, S, G, N], got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    bz, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if B.shape[:2] != (bz, s) or g == 0 or h % g:
        raise ValueError(f"x {tuple(x.shape)} and B {tuple(B.shape)} do not pair (G | H)")
    if a.shape != (bz, s, h) or dt.shape != (bz, s, h):
        raise ValueError(f"a and dt must be [B, S, H] = {(bz, s, h)}, got {tuple(a.shape)}")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"a and dt must be float32, got {a.dtype} {dt.dtype}")
    if not (a.is_contiguous() and dt.is_contiguous()):
        raise ValueError("a and dt must be contiguous")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got {x.dtype} {B.dtype} {C.dtype}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"P={p} must be in {HEAD_DIMS} and N={n} in {STATE_DIMS}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        _inner_contiguous(t, name)
    if init_state is not None and (
        init_state.shape != (bz, h, p, n) or init_state.dtype != torch.float32
        or not init_state.is_contiguous()
    ):
        raise ValueError(f"init_state must be a contiguous float32 {(bz, h, p, n)}, got "
                         f"{init_state.dtype} {tuple(init_state.shape)}")
    if bz * h >= _INT_MAX or s >= _INT_MAX:
        raise ValueError(f"sizes out of the kernel's range: x {tuple(x.shape)}")


def kernel_chunk(dtype: torch.dtype) -> int:
    """The kernels' own chunk length L for ``dtype`` (builds the library):
    float32 64, bf16 the length chosen by ``tools/ssd_sweep.py``."""
    return library("ssd_scan").ssd_scan_chunk(_DTYPE_CODE[dtype])


def launch_ssd_scan(x, a, dt, B, C, init_state, y, final_state) -> None:
    """Launch the kernels on checked CUDA tensors, with their float32
    scratch allocated here (each chunk's state [Bz, H, S / L, P, N] and
    decay [Bz, H, S / L]); counts nothing."""
    bz, s, h, p = x.shape
    n = B.shape[3]
    lib = library("ssd_scan")
    code = _DTYPE_CODE[x.dtype]
    nc = -(-s // lib.ssd_scan_chunk(code))
    states = torch.empty((bz, h, nc, p, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((bz, h, nc), dtype=torch.float32, device=x.device)
    err = lib.ssd_scan(
        x.data_ptr(), x.stride(0), x.stride(1),
        a.data_ptr(), dt.data_ptr(),
        B.data_ptr(), B.stride(0), B.stride(1),
        C.data_ptr(), C.stride(0), C.stride(1),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final_state.data_ptr(), states.data_ptr(), decay.data_ptr(),
        bz, s, h, B.shape[2], p, n, code,
        torch.cuda.current_stream().cuda_stream,
    )
    check(err, "ssd_scan")


def ssd_scan_fused(
    x: torch.Tensor,
    a: torch.Tensor,
    dt: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of x [Bz, S, H, P] with a = dt * A and dt [Bz, S, H]
    (float32, a <= 0), B and C [Bz, S, G, N] in group form (G divides H),
    from ``init_state`` [Bz, H, P, N] float32 (None: zeros). Returns
    (y [Bz, S, H, P] in x's dtype, final_state [Bz, H, P, N] float32).

    ``chunk`` is the plain version's chunk length. The kernels cut the
    sequence into chunks of their own length (:func:`kernel_chunk`), which
    computes the same function: the result does not depend on ``chunk``.
    On the card: x, B, C float32 or bfloat16 with their last two dims
    contiguous, P in ``HEAD_DIMS``, N in ``STATE_DIMS``; a ragged S needs
    no padding copy."""
    if on_cpu(x, a, dt, B, C):
        return ssd_chunked_ref(x, a, dt, B, C, chunk=chunk, init_state=init_state)
    _check_cuda_args(x, a, dt, B, C, init_state)
    forbid_grad("ssd_scan_fused", x, a, dt, B, C, init_state)
    bz, s, h, p = x.shape
    y = torch.empty((bz, s, h, p), dtype=x.dtype, device=x.device)
    final_state = torch.empty((bz, h, p, B.shape[3]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        launch_ssd_scan(x, a, dt, B, C, init_state, y, final_state)
    LAUNCHES["ssd_scan"] += 1
    return y, final_state
