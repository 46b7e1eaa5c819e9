"""Hopper kernels of the GNN inference path and their wrappers.

* :func:`segment_spmm_ragged` replaces
  ``repro/kernels/fused_gnn.py::segment_spmm_ragged_pallas`` (``:220``);
  kernel in ``csrc/segment_sum.cu``. :func:`segment_sum_and_count` runs it
  twice over one CSR index: the sum, and the edges per row (D = 1).
* :func:`gat_softmax_aggregate` replaces
  ``repro/kernels/fused_gnn.py::gat_softmax_aggregate_pallas`` (``:285``);
  kernel in ``csrc/gat_softmax_aggregate.cu``. It takes one head (logits
  [E], msg [E, D]) as the TPU kernel does, or all heads at once (logits
  [E, H], msg [E, H, dh]) in one launch.

Both are bound by the bytes of the messages: a sum adds one float per
element read, and the softmax adds one exp per edge and head. The TPU
kernels multiply one-hot tiles on the MXU because a scatter is slow there;
on Hopper each destination row is a contiguous run of edges (a CSR row),
reduced by a small thread group with 16-byte loads, float accumulation
and no atomics. That keeps every row's sum order fixed by its own edges,
so a batched row equals the same row computed alone.

Sorted input. The engine and the server pass ``seg`` non-decreasing with
the padding (-1) at the tail. A first kernel derives the CSR row offsets
from ``seg`` on the card and flags a decrease in device memory; with the
flag up, the reduction visits each row's edges by scanning all of them
(O(n*E), never taken on the main path) in index order, the order a stable
sort gives. So any ``seg`` gives what the TPU kernel gives, and the
wrappers never wait for the card.

Dispatch follows the tensors' device: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor launches the kernel or raises. Each
kernel launch adds one to ``LAUNCHES[name]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library
from repro_torch.kernels.ref import gat_softmax_aggregate_ref, segment_spmm_ref

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "segment_index",
    "launch_segment_sum",
    "launch_gat_softmax_aggregate",
    "segment_spmm_ragged",
    "segment_sum_and_count",
    "gat_softmax_aggregate",
]

LAUNCHES = {"segment_spmm_ragged": 0, "gat_softmax_aggregate": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _is_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, got {devs}")
    return False


def _vec_tpr(row: int, t: torch.Tensor) -> tuple[int, int]:
    """Elements per load (16 bytes at most, dividing the row and the base
    address) and threads per row (a power of two up to a warp)."""
    esize = t.element_size()
    vec = 16 // esize
    while vec > 1 and (row % vec or t.data_ptr() % (vec * esize)):
        vec //= 2
    tpr = 1
    while tpr < 32 and tpr * vec < row:
        tpr *= 2
    return vec, tpr


def _check_cuda_args(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> None:
    if msg.dtype not in _DTYPE_CODE:
        raise TypeError(f"msg dtype must be float32 or bfloat16, got {msg.dtype}")
    if seg.dtype != torch.int32 or seg.dim() != 1:
        raise TypeError(f"seg must be a 1-D int32 tensor, got {seg.dtype} {tuple(seg.shape)}")
    if seg.shape[0] != msg.shape[0]:
        raise ValueError(f"seg has {seg.shape[0]} edges, msg {msg.shape[0]}")
    if not (msg.is_contiguous() and seg.is_contiguous()):
        raise ValueError("msg and seg must be contiguous")
    if not 0 <= num_segments < _INT_MAX or msg.shape[0] >= _INT_MAX:
        raise ValueError(f"sizes out of int32 range: E={msg.shape[0]} n={num_segments}")


def segment_index(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The CSR index of ``seg`` on the card: int32 [n + 2] with the row
    offsets in [0, n] and the unsorted flag at [n + 1]."""
    n = num_segments
    index = torch.zeros(n + 2, dtype=torch.int32, device=seg.device)
    code = library("segment_sum").segment_offsets(
        seg.data_ptr(), seg.shape[0], n, index.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "segment_offsets")
    return index


def launch_segment_sum(msg, seg, index, out) -> None:
    """Launch ``csrc/segment_sum.cu`` on checked CUDA tensors (msg [E, D],
    seg [E], out [n, D]) and the index from :func:`segment_index`. Counts
    nothing: the wrapper counts its launches."""
    n, d = out.shape
    vec, tpr = _vec_tpr(d, msg)
    code = library("segment_sum").segment_sum(
        msg.data_ptr(),
        seg.data_ptr(),
        seg.shape[0],
        index.data_ptr(),
        n,
        d,
        _DTYPE_CODE[msg.dtype],
        vec,
        tpr,
        out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "segment_sum")


def launch_gat_softmax_aggregate(logits, msg, seg, index, out) -> None:
    """Launch ``csrc/gat_softmax_aggregate.cu`` on checked CUDA tensors
    (float32 logits [E, H], msg [E, H, dh], seg [E], out [n, H, dh]) and the
    index from :func:`segment_index`. Counts nothing."""
    n, h, dh = out.shape
    vec, tpr = _vec_tpr(dh, msg)
    code = library("gat_softmax_aggregate").gat_softmax_aggregate(
        logits.data_ptr(),
        msg.data_ptr(),
        seg.data_ptr(),
        seg.shape[0],
        index.data_ptr(),
        n,
        h,
        dh,
        _DTYPE_CODE[msg.dtype],
        vec,
        tpr,
        out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "gat_softmax_aggregate")


def _sum_on_card(msg, seg, num_segments, index) -> torch.Tensor:
    """Checked CUDA tensors through the sum kernel; ``index`` from
    :func:`segment_index`, or None to build it here."""
    d = msg.shape[1]
    out = torch.empty((num_segments, d), dtype=msg.dtype, device=msg.device)
    if num_segments == 0 or d == 0:
        return out
    if index is None:
        index = segment_index(seg, num_segments)
    launch_segment_sum(msg, seg, index, out)
    LAUNCHES["segment_spmm_ragged"] += 1
    return out


def _check_sum_args(msg, seg, num_segments) -> bool:
    """True for CPU tensors; raises on CUDA tensors the kernel does not take."""
    if _is_cpu(msg, seg):
        return True
    if msg.dim() != 2:
        raise ValueError(f"msg must be [E, D], got {tuple(msg.shape)}")
    _check_cuda_args(msg, seg, num_segments)
    return False


def segment_spmm_ragged(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum over edges e with seg[e] == s of msg[e], in msg's dtype
    (float32 accumulation). msg [E, D] float32/bfloat16, seg [E] int32 with
    -1 padding."""
    if _check_sum_args(msg, seg, num_segments):
        return segment_spmm_ref(msg, seg, num_segments)
    with torch.cuda.device(msg.device):
        return _sum_on_card(msg, seg, num_segments, None)


def segment_sum_and_count(
    msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_spmm_ragged` of ``msg`` and of a column of ones over
    the valid edges: the sum and the edges per row ([n, 1] float32). On the
    card both are launches of the sum kernel over one CSR index."""
    ones = (seg >= 0).to(torch.float32)[:, None]
    if _check_sum_args(msg, seg, num_segments):
        return (
            segment_spmm_ref(msg, seg, num_segments),
            segment_spmm_ref(ones, seg, num_segments),
        )
    with torch.cuda.device(msg.device):
        index = segment_index(seg, num_segments) if num_segments else None
        return (
            _sum_on_card(msg, seg, num_segments, index),
            _sum_on_card(ones, seg, num_segments, index),
        )


def gat_softmax_aggregate(
    logits: torch.Tensor, msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum_e softmax_{seg==s}(logits)[e] * msg[e] per head, with
    ``max(z, 1e-9)`` so empty segments give 0, in msg's dtype.

    One head: logits [E], msg [E, D] -> [n, D]. All heads: logits [E, H],
    msg [E, H, dh] -> [n, H, dh]. Logits are taken as float32."""
    heads = logits.dim() == 2
    if logits.dim() != msg.dim() - 1 or logits.shape != msg.shape[:-1] or msg.dim() not in (2, 3):
        raise ValueError(
            f"expected logits [E] with msg [E, D], or logits [E, H] with msg [E, H, dh]; "
            f"got {tuple(logits.shape)} and {tuple(msg.shape)}"
        )
    if _is_cpu(logits, msg, seg):
        if not heads:
            return gat_softmax_aggregate_ref(logits, msg, seg, num_segments)
        return torch.stack(
            [
                gat_softmax_aggregate_ref(logits[:, h], msg[:, h], seg, num_segments)
                for h in range(msg.shape[1])
            ],
            dim=1,
        )
    _check_cuda_args(msg, seg, num_segments)
    h, dh = (msg.shape[1], msg.shape[2]) if heads else (1, msg.shape[1])
    out_shape = (num_segments, h, dh) if heads else (num_segments, dh)
    out = torch.empty(out_shape, dtype=msg.dtype, device=msg.device)
    if num_segments == 0 or h == 0 or dh == 0:
        return out
    lf = logits.to(torch.float32).contiguous()
    with torch.cuda.device(msg.device):
        e = msg.shape[0]
        launch_gat_softmax_aggregate(
            lf.view(e, h),
            msg.view(e, h, dh),
            seg,
            segment_index(seg, num_segments),
            out.view(num_segments, h, dh),
        )
    LAUNCHES["gat_softmax_aggregate"] += 1
    return out
