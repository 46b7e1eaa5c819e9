"""Hopper kernels of the GNN path, their wrappers and their backwards.

* :func:`segment_spmm_ragged` replaces
  ``repro/kernels/fused_gnn.py::segment_spmm_ragged_pallas`` (``:220``);
  kernel in ``csrc/segment_sum.cu``. :func:`segment_sum_and_count` runs it
  twice over one CSR index: the sum, and the edges per row (D = 1).
* :func:`gather_spmm_ragged` replaces
  ``repro/kernels/fused_gnn.py::gather_spmm_ragged_pallas`` (``:159``):
  ``out[s] = sum_{seg[e]==s} feats[idx[e]]`` with the gather done in the
  load of the same kernel (``gather_segment_sum``), so no [E, D] message
  array is written. It is differentiable in ``feats``: the backward is the
  same kernel over the edges sorted by ``idx``, with ``idx`` and ``seg``
  swapped (``dfeats[f] = sum_{idx[e]==f} grad[seg[e]]``).
* :func:`gather_rows` is the plain gather ``x[idx]`` (zero rows where
  ``idx < 0``) whose backward, a scatter-add, is that kernel again over the
  idx-sorted order: no float atomics, so the gradient has the same bits on
  every run.
* :func:`gat_softmax_aggregate` replaces
  ``repro/kernels/fused_gnn.py::gat_softmax_aggregate_pallas`` (``:285``);
  kernel in ``csrc/gat_softmax_aggregate.cu``. It takes one head (logits
  [E], msg [E, D]) as the TPU kernel does, or all heads at once (logits
  [E, H], msg [E, H, dh]) in one launch. When autograd needs it, the
  forward keeps each (row, head)'s max and denominator, and the backward
  is one kernel (``csrc/gat_softmax_backward.cu``).
* :func:`segment_spmm` and :func:`gather_spmm` replace the dense call
  forms ``repro/kernels/segment_spmm.py::segment_spmm_pallas`` (``:57``)
  and ``repro/kernels/fused_gnn.py::gather_spmm_pallas`` (``:122``), whose
  ids come in any order (padding anywhere, ids >= n dropped): a stable
  radix sort of the ids on the card (:func:`segment_sort`,
  ``csrc/segment_sort.cu``), then the gather kernel above over the sorted
  edges, gathering the messages through the permutation (or ``feats``
  through ``idx[perm]``). A row sums its edges in index order, so the
  result has the bits of the sorted-input kernels over the host's
  stable-sorted input. The same sort gives :func:`sort_order` on the card.
* :func:`segment_max` replaces
  ``repro/kernels/fused_gnn.py::segment_max_pallas`` (``:348``); kernel in
  ``csrc/segment_max.cu``. The ids come in any order: each value maps to
  an order-preserving integer key; a thread folds equal ids among the 16
  edges it loads, a warp whose lanes share one id sends one key, and each
  block keeps a cache in shared memory of the (id, key) pairs it has sent,
  so an ``atomicMax`` goes out only where that cache does not already
  hold a key at least as large. A segment's key slot is spread over the
  128-byte lines (slot (s mod r) * 32 + s / r, r = ceil(n / 32)) so
  neighbouring hub ids hit different L2 slices. An integer max gives the
  same bits in any order (no float atomics), and a second pass decodes.

All are bound by bytes: a sum adds one float per element read, and the
softmax adds one exp per edge and head. The TPU kernels multiply one-hot
tiles on the MXU because a scatter is slow there; on Hopper each
destination row is a contiguous run of edges (a CSR row), reduced by a
small thread group with 16-byte loads, float accumulation and no float
atomics. The sums cut a row of more than ``SUM_CHUNK`` edges into chunks
of that many edge slots counted from the row's first slot, sum the chunks
in parallel and add their partial sums in chunk order
(``ref.chunked_segment_sum_ref`` is that order in plain PyTorch); a row of
at most ``SUM_CHUNK`` edges is one plain sum in edge order. That keeps
every row's sum order fixed by its own edges, so a batched row equals the
same row computed alone, and a training run repeats bit for bit.

Sorted input (the ragged sums and the softmax aggregate). The engine and
the server pass ``seg`` non-decreasing with the padding (-1) at the tail. A
first kernel derives the CSR row offsets from ``seg`` on the card and flags
a decrease in device memory; with the flag up, the reduction visits each
row's edges by scanning all of them (O(n*E), taken only by a caller that
breaks the contract; the dense forms sort first) in index order, the order
a stable sort gives. So any ``seg`` gives what the TPU kernel gives, and
the wrappers never wait for the card.

Dispatch follows the tensors' device: a CPU tensor goes to the plain
version in ``ref.py`` (autograd runs through it); a CUDA tensor launches
the kernel or raises. A kernel without a backward raises on CUDA tensors
that require grad while grad mode is on (``build.forbid_grad``). Each
kernel launch adds one to ``LAUNCHES[name]``, under the name of the call
form: the gather kernel counts under ``gather_spmm_ragged`` (forward),
``gather_spmm_ragged_backward`` (the backwards of both the gather
aggregate and :func:`gather_rows`), ``segment_spmm`` and ``gather_spmm``
(the dense forms); ``segment_sort`` counts the sort's kernels (three a
pass: count, scan, scatter), those of :func:`sort_order` included.

Launch shapes. The sums and the softmax aggregate take three launch
choices (elements per load, threads per row group, and for the sums
which of two builds runs). A forward launch reads the autotuner's winner
for its (op, shape bucket, dtype) under the reference's name of the
wrapper that called it (``autotune.get_tuned``), else a heuristic; the
backwards keep the heuristic. Every choice adds in the same order, so the
tuner moves time and never bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.autotune import TUNED_OPS, get_tuned
from repro_torch.kernels.build import check, forbid_grad, library, on_cpu
from repro_torch.kernels.ref import (
    SUM_CHUNK,
    gat_softmax_aggregate_ref,
    gather_spmm_ragged_backward_ref,
    gather_spmm_ref,
    segment_max_ref,
    segment_sort_ref,
    segment_spmm_ref,
)

__all__ = [
    "LAUNCHES",
    "SUM_CHUNK",
    "reset_launches",
    "segment_index",
    "sort_passes",
    "sort_digit_bits",
    "launch_segment_sort",
    "segment_sort",
    "sort_order",
    "launch_segment_sum",
    "launch_gather_sum",
    "launch_gat_softmax_aggregate",
    "launch_gat_softmax_aggregate_backward",
    "launch_segment_max",
    "segment_max_keys",
    "segment_spmm_ragged",
    "segment_sum_and_count",
    "gather_spmm_ragged",
    "gather_spmm_ragged_backward",
    "gather_rows",
    "segment_spmm",
    "gather_spmm",
    "gat_softmax_aggregate",
    "gat_softmax_aggregate_backward",
    "segment_max",
]

LAUNCHES = {
    "segment_spmm_ragged": 0,
    "gat_softmax_aggregate": 0,
    "gather_spmm_ragged": 0,
    "gather_spmm_ragged_backward": 0,
    "gat_softmax_aggregate_backward": 0,
    "segment_max": 0,
    "segment_spmm": 0,
    "gather_spmm": 0,
    "segment_sort": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
_SORT_TILE = 4096  # keys per block of csrc/segment_sort.cu (kSortTile)
_SORT_KERNELS_PER_PASS = 3  # count, scan, scatter


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cap_vec(vec: int, row: int, esize: int, ts=()) -> int:
    """``vec`` halved until it divides the row and every base address of
    ``ts`` (16 bytes a load at most)."""
    vec = min(vec, 16 // esize)
    while vec > 1 and (row % vec or any(t.data_ptr() % (vec * esize) for t in ts)):
        vec //= 2
    return vec


def heuristic_vec_tpr(row: int, esize: int, ts=()) -> tuple[int, int]:
    """The untuned launch: elements per load (16 bytes at most, dividing the
    row and every base address of ``ts``) and threads per row (a power of
    two up to a warp, enough for one load of the row each)."""
    vec = _cap_vec(16 // esize, row, esize, ts)
    tpr = 1
    while tpr < 32 and tpr * vec < row:
        tpr *= 2
    return vec, tpr


def _vec_tpr(row: int, *ts: torch.Tensor) -> tuple[int, int]:
    """:func:`heuristic_vec_tpr` for the tensors ``ts`` of a launch."""
    return heuristic_vec_tpr(row, ts[0].element_size(), ts)


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
    """The CSR index of ``seg`` on the card, int32 and zeroed before the
    offsets are written: the row offsets in [0, n], the unsorted flag at
    [n + 1], then the sums' counters of long rows' chunks (each sum leaves
    them at zero). ``csrc/segment_sum.cu`` owns the length."""
    n, e = num_segments, seg.shape[0]
    lib = library("segment_sum")
    index = torch.zeros(lib.segment_index_words(e, n), dtype=torch.int32, device=seg.device)
    code = lib.segment_offsets(
        seg.data_ptr(), e, n, index.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    check(code, "segment_offsets")
    return index


def _partials(e: int, d: int, device) -> torch.Tensor:
    """The sums' float32 scratch for the partial sums of long rows' chunks,
    sized by ``csrc/segment_sum.cu``."""
    rows = library("segment_sum").segment_sum_scratch_rows(e)
    return torch.empty((rows, d), dtype=torch.float32, device=device)


# Edges a row, on average, from which the batched build of the sum kernel
# runs, by dtype; float32 always runs the lean one, which measured at or
# below the batched one at 1-8 edges a row (tools/chunk_sweep.py, PERF.md).
_BATCH_FROM = {torch.bfloat16: 4}


def _lean(e: int, n: int, dtype: torch.dtype) -> int:
    """Which build of the sum kernel runs (``csrc/segment_sum.cu``): the
    lean one (one edge at a time, more rows in flight) for float32, and for
    bf16 rows of under ``_BATCH_FROM[dtype]`` edges on average; else the
    batched one. Both add in one order: the choice moves time, never
    bits."""
    cut = _BATCH_FROM.get(dtype)
    return int(cut is None or e < cut * n)


def _launch_shape(op, config, e: int, n: int, row: int, *ts) -> tuple[int, int, int]:
    """(vec, tpr, lean) of a forward launch of E = ``e`` edges into ``n``
    rows of width ``row`` over the tensors ``ts`` it loads and stores (the
    first gives the element size): ``config`` when given (the tuner's
    candidates), else the tuner's winner for ``op``'s bucket
    (``autotune.get_tuned``; ``op`` None: never), else the heuristic. A
    tuned ``vec`` is capped by the row and the base addresses as the
    heuristic's is: a bucket's shape does not fix the pointers."""
    if config is None and op is not None:
        config = get_tuned(op, (e, n, row), ts[0].dtype)
    if config is None:
        vec, tpr = _vec_tpr(row, *ts)
        return vec, tpr, _lean(e, n, ts[0].dtype)
    return _cap_vec(config.vec, row, ts[0].element_size(), ts), config.tpr, config.lean


def launch_segment_sum(msg, seg, index, out, op=None, config=None) -> None:
    """Launch ``csrc/segment_sum.cu`` on checked CUDA tensors (msg [E, D],
    seg [E], out [n, D]) and the index from :func:`segment_index`, with
    the launch shape of :func:`_launch_shape` (``op``: the tuned op name of
    the calling wrapper; ``config``: a forced one). Counts nothing: the
    wrapper counts its launches."""
    n, d = out.shape
    e = seg.shape[0]
    vec, tpr, lean = _launch_shape(op, config, e, n, d, msg)
    partial = _partials(e, d, out.device)
    code = library("segment_sum").segment_sum(
        msg.data_ptr(),
        seg.data_ptr(),
        e,
        index.data_ptr(),
        index.shape[0],
        n,
        d,
        _DTYPE_CODE[msg.dtype],
        vec,
        tpr,
        lean,
        partial.data_ptr(),
        partial.shape[0],
        out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "segment_sum")


def launch_gather_sum(feats, idx, seg, index, out, op=None, config=None) -> None:
    """Launch ``gather_segment_sum`` (``csrc/segment_sum.cu``) on checked
    CUDA tensors (feats [F, D], idx and seg [E], out [n, D]) and the index
    of ``seg`` from :func:`segment_index`; ``op`` and ``config`` as for
    :func:`launch_segment_sum`. Counts nothing."""
    n, d = out.shape
    e = seg.shape[0]
    vec, tpr, lean = _launch_shape(op, config, e, n, d, feats, out)
    partial = _partials(e, d, out.device)
    code = library("segment_sum").gather_segment_sum(
        feats.data_ptr(),
        idx.data_ptr(),
        seg.data_ptr(),
        e,
        index.data_ptr(),
        index.shape[0],
        n,
        d,
        _DTYPE_CODE[feats.dtype],
        vec,
        tpr,
        lean,
        partial.data_ptr(),
        partial.shape[0],
        out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "gather_segment_sum")


def launch_gat_softmax_aggregate(logits, msg, seg, index, out, stats=None, op=None,
                                 config=None) -> None:
    """Launch ``csrc/gat_softmax_aggregate.cu`` on checked CUDA tensors
    (float32 logits [E, H], msg [E, H, dh], seg [E], out [n, H, dh]) and the
    index from :func:`segment_index`; ``stats``, when given, float32
    [2, n, H], receives each (row, head)'s max and denominator. ``op`` and
    ``config`` as for :func:`launch_segment_sum` (the kernel has one
    build: ``lean`` is not read). Counts nothing."""
    n, h, dh = out.shape
    vec, tpr, _ = _launch_shape(op, config, seg.shape[0], n, dh, msg, out)
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
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "gat_softmax_aggregate")


def launch_gat_softmax_aggregate_backward(
    logits, msg, out, grad, stats, seg, index, dmsg, dlogit
) -> None:
    """Launch ``csrc/gat_softmax_backward.cu`` on checked CUDA tensors: the
    forward's float32 logits [E, H], msg [E, H, dh], out [n, H, dh] and
    stats [2, n, H], the upstream grad [n, H, dh], seg [E] and its index;
    writes dmsg [E, H, dh] and float32 dlogit [E, H]. Needs n * H > 0.
    Counts nothing."""
    n, h, dh = out.shape
    vec, tpr = _vec_tpr(dh, msg, out, grad, dmsg)
    code = library("gat_softmax_backward").gat_softmax_aggregate_backward(
        logits.data_ptr(),
        msg.data_ptr(),
        out.data_ptr(),
        grad.data_ptr(),
        stats.data_ptr(),
        seg.data_ptr(),
        seg.shape[0],
        index.data_ptr(),
        n,
        h,
        dh,
        _DTYPE_CODE[msg.dtype],
        vec,
        tpr,
        dmsg.data_ptr(),
        dlogit.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "gat_softmax_aggregate_backward")


def _sum_on_card(msg, seg, num_segments, index) -> torch.Tensor:
    """Checked CUDA tensors through the sum kernel; ``index`` from
    :func:`segment_index`, or None to build it here."""
    d = msg.shape[1]
    out = torch.empty((num_segments, d), dtype=msg.dtype, device=msg.device)
    if num_segments == 0 or d == 0:
        return out
    if index is None:
        index = segment_index(seg, num_segments)
    launch_segment_sum(msg, seg, index, out, op="segment_spmm_ragged")
    LAUNCHES["segment_spmm_ragged"] += 1
    return out


def _check_sum_args(msg, seg, num_segments) -> bool:
    """True for CPU tensors; raises on CUDA tensors the kernel does not take."""
    if on_cpu(msg, seg):
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
    forbid_grad("segment_spmm_ragged", msg)
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
    forbid_grad("segment_sum_and_count", msg)
    with torch.cuda.device(msg.device):
        index = segment_index(seg, num_segments) if num_segments else None
        return (
            _sum_on_card(msg, seg, num_segments, index),
            _sum_on_card(ones, seg, num_segments, index),
        )


def sort_passes(num_segments: int) -> int:
    """Passes of digits of at most 8 bits that cover the sort's keys [0,
    n]: ceil(bits(n) / 8), at least one (3 at n = 150,000; 4 at 2**31 - 1)."""
    return max(1, -(-int(num_segments).bit_length() // 8))


def sort_digit_bits(num_segments: int) -> int:
    """The digit width of every pass: bits(n) split evenly over
    :func:`sort_passes` (6 at n = 150,000: 64 digits a pass), at least 1."""
    return max(1, -(-int(num_segments).bit_length() // sort_passes(num_segments)))


def launch_segment_sort(seg, num_segments, keys, perm, idx=None, idx_out=None) -> int:
    """Launch the passes of ``csrc/segment_sort.cu`` on checked CUDA
    tensors: seg [E] int32 in, the sorted keys and the permutation out
    (``keys``, ``perm`` int32 [E]); with ``idx`` [E], also ``idx_out =
    idx[perm]``. The passes alternate between the outputs and a scratch
    pair so that the last lands on the outputs. Returns the kernels
    launched, three a pass (none for E = 0); counts nothing."""
    e = seg.shape[0]
    if e == 0:
        return 0
    passes = sort_passes(num_segments)
    bits = sort_digit_bits(num_segments)
    # the digit-major counts of every tile, then the digit totals
    table = torch.empty((1 << bits) * (-(-e // _SORT_TILE) + 1), dtype=torch.int32,
                        device=seg.device)
    scratch = torch.empty((2, e), dtype=torch.int32, device=seg.device) if passes > 1 else None
    lib = library("segment_sort")
    stream = torch.cuda.current_stream().cuda_stream
    src = (seg, None)
    for p in range(passes):
        last = p == passes - 1
        dst = (keys, perm) if (passes - 1 - p) % 2 == 0 else (scratch[0], scratch[1])
        code = lib.segment_sort_pass(
            src[0].data_ptr(),
            None if src[1] is None else src[1].data_ptr(),
            e,
            num_segments,
            bits * p,
            bits,
            int(p == 0),
            int(last),
            idx.data_ptr() if last and idx is not None else None,
            table.data_ptr(),
            table.numel(),
            dst[0].data_ptr(),
            dst[1].data_ptr(),
            idx_out.data_ptr() if last and idx is not None else None,
            stream,
        )
        check(code, "segment_sort_pass")
        src = dst
    return _SORT_KERNELS_PER_PASS * passes


def _sort_on_card(seg, num_segments, idx=None):
    """(sorted keys, permutation, ``idx[perm]`` or None) of checked CUDA
    tensors, counting the sort's kernels under ``segment_sort``."""
    e = seg.shape[0]
    keys = torch.empty(e, dtype=torch.int32, device=seg.device)
    perm = torch.empty_like(keys)
    gathered = None if idx is None else torch.empty_like(keys)
    LAUNCHES["segment_sort"] += launch_segment_sort(seg, num_segments, keys, perm, idx, gathered)
    return keys, perm, gathered


def segment_sort(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The int32 permutation that stable-sorts ``seg`` [E] int32 by its
    key: the id, or ``num_segments`` for padding (seg < 0) and ids >=
    num_segments, which so come last in index order. On the card: the
    radix sort of ``csrc/segment_sort.cu``; the permutation is unique, so it
    has the bits of ``ref.segment_sort_ref``."""
    if on_cpu(seg):
        return segment_sort_ref(seg, num_segments)
    _check_index(seg, seg.shape[0] if seg.dim() == 1 else -1, "seg")
    if not 0 <= num_segments <= _INT_MAX:
        raise ValueError(f"num_segments out of int32 range: {num_segments}")
    with torch.cuda.device(seg.device):
        return _sort_on_card(seg, num_segments)[1]


def sort_order(idx: torch.Tensor, num_rows: int | None = None) -> torch.Tensor:
    """The int32 permutation that stable-sorts ``idx`` with its padding
    (``idx < 0``) last, on ``idx``'s device: the edge order a gather's
    backward reads. ``num_rows`` bounds the ids: those >= it sort with the
    padding, and the card's sort takes the passes of that bound (None: all
    31 bits, four passes); on ids in [-1, num_rows) both give these bits."""
    bound = _INT_MAX if num_rows is None else num_rows
    return segment_sort(idx.to(torch.int32).contiguous(), bound)


def _check_index(t: torch.Tensor, e: int, what: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != e:
        raise TypeError(
            f"{what} must be a 1-D int32 tensor of {e} edges, got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_gather_args(feats, idx, seg, num_segments, order) -> None:
    if feats.dtype not in _DTYPE_CODE:
        raise TypeError(f"feats dtype must be float32 or bfloat16, got {feats.dtype}")
    if feats.dim() != 2 or not feats.is_contiguous():
        raise ValueError(f"feats must be a contiguous [F, D] tensor, got {tuple(feats.shape)}")
    e = idx.shape[0] if idx.dim() == 1 else -1
    _check_index(idx, e, "idx")
    _check_index(seg, e, "seg")
    if order is not None:
        _check_index(order, e, "idx_order")
    if not 0 <= num_segments < _INT_MAX or max(e, feats.shape[0]) >= _INT_MAX:
        raise ValueError(f"sizes out of int32 range: E={e} F={feats.shape[0]} n={num_segments}")


def _gather_on_card(feats, idx, seg, num_segments, name) -> torch.Tensor:
    """Checked CUDA tensors through the gather kernel, counted under
    ``name``; the forward's launch is tuned under that name, the
    backward's (not a tuned op, as in the reference) never."""
    d = feats.shape[1]
    out = torch.empty((num_segments, d), dtype=feats.dtype, device=feats.device)
    if num_segments == 0 or d == 0:
        return out
    op = name if name in TUNED_OPS else None
    launch_gather_sum(feats, idx, seg, segment_index(seg, num_segments), out, op=op)
    LAUNCHES[name] += 1
    return out


def _swapped(idx, seg, order, num_segments):
    """The backward's (gather index, segment) pairs: the forward's edges
    in ``order`` (idx-sorted), gathering the upstream gradient at ``seg``
    (padding where ``seg`` is out of range) into the rows ``idx``."""
    o = order.long()
    s = seg[o]
    s = torch.where((s >= 0) & (s < num_segments), s, -1)
    return s, idx[o]


def gather_spmm_ragged_backward(
    grad: torch.Tensor,
    idx: torch.Tensor,
    seg: torch.Tensor,
    num_rows: int,
    idx_order: torch.Tensor | None = None,
) -> torch.Tensor:
    """d feats [num_rows, D] of :func:`gather_spmm_ragged` for the upstream
    ``grad`` [n, D]: ``dfeats[f] = sum_{idx[e]==f} grad[seg[e]]``, the gather
    kernel over the edges in ``idx_order`` (None: sorted on the card) with
    idx and seg swapped. CPU tensors take the plain twin."""
    if on_cpu(grad, idx, seg):
        return gather_spmm_ragged_backward_ref(grad, idx, seg, num_rows)
    grad = grad.contiguous()
    _check_gather_args(grad, idx, seg, num_rows, idx_order)
    with torch.cuda.device(grad.device):
        order = sort_order(idx, num_rows) if idx_order is None else idx_order
        g_idx, g_seg = _swapped(idx, seg, order, grad.shape[0])
        return _gather_on_card(grad, g_idx, g_seg, num_rows, "gather_spmm_ragged_backward")


class _GatherSum(torch.autograd.Function):
    """:func:`gather_spmm_ragged` on checked CUDA tensors; the backward is
    the same kernel over the idx-sorted edges, idx and seg swapped."""

    @staticmethod
    def forward(ctx, feats, idx, seg, num_segments, order):
        ctx.save_for_backward(idx, seg, order)
        ctx.num_rows = feats.shape[0]
        return _gather_on_card(feats, idx, seg, num_segments, "gather_spmm_ragged")

    @staticmethod
    def backward(ctx, grad):
        idx, seg, order = ctx.saved_tensors
        dfeats = gather_spmm_ragged_backward(grad, idx, seg, ctx.num_rows, order)
        return dfeats, None, None, None, None


def gather_spmm_ragged(
    feats: torch.Tensor,
    idx: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
    idx_order: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[s] = sum over edges e with seg[e] == s of feats[idx[e]], in
    feats' dtype (float32 accumulation). feats [F, D] float32/bfloat16;
    idx, seg [E] int32 with -1 padding (idx in [-1, F)).

    Differentiable in ``feats``. ``idx_order`` is the int32 permutation
    that stable-sorts ``idx`` with the padding last (:func:`sort_order`);
    the backward reads the edges in that order. Batches carry it; None
    sorts on the card at the backward. The kernel reads CSR rows when
    ``seg`` is sorted (padding last) and scans otherwise (see
    ``segment_index``)."""
    if on_cpu(feats, idx, seg):
        return gather_spmm_ref(feats, idx, seg, num_segments)
    _check_gather_args(feats, idx, seg, num_segments, idx_order)
    with torch.cuda.device(feats.device):
        return _GatherSum.apply(feats, idx, seg, num_segments, idx_order)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with zero rows where idx < 0."""
    if x.shape[0] == 0:
        return x.new_zeros((idx.shape[0],) + tuple(x.shape[1:]))
    ok = (idx >= 0).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(ok, x.index_select(0, idx.clamp_min(0).long()), 0.0)


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows` on checked CUDA tensors; the backward sums the
    gradient rows of each ``idx`` value: the gather aggregate's backward
    with each edge its own segment."""

    @staticmethod
    def forward(ctx, x, idx, order):
        ctx.save_for_backward(idx, order)
        ctx.shape = x.shape
        return _rows(x, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, order = ctx.saved_tensors
        g = grad.reshape(grad.shape[0], math.prod(ctx.shape[1:]))
        each = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
        dx = gather_spmm_ragged_backward(g, idx, each, ctx.shape[0], order)
        return dx.view(ctx.shape), None, None


def gather_rows(
    x: torch.Tensor, idx: torch.Tensor, idx_order: torch.Tensor | None = None
) -> torch.Tensor:
    """out[e] = x[idx[e]], zero where idx[e] < 0; x [N, ...], idx [E]
    int32. Differentiable in ``x``: on the card the backward
    ``dx[f] = sum_{idx[e]==f} grad[e]`` is the gather kernel over
    ``idx_order`` (the int32 permutation that stable-sorts ``idx`` with the
    padding last; None sorts on the card), not an atomic scatter-add, so
    the gradient has the same bits on every run."""
    if on_cpu(x, idx):
        return _rows(x, idx)
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32 or bfloat16, got {x.dtype}")
    _check_index(idx, idx.shape[0] if idx.dim() == 1 else -1, "idx")
    if idx_order is not None:
        _check_index(idx_order, idx.shape[0], "idx_order")
    with torch.cuda.device(x.device):
        return _GatherRows.apply(x, idx, idx_order)


def _dense_on_card(src, idx, seg, num_segments, name) -> torch.Tensor:
    """Checked CUDA tensors through the sort and the gather kernel: rows of
    ``src`` through the permutation (``idx`` None) or ``src[idx[perm]]``,
    summed over the sorted ids; counted under ``name``."""
    d = src.shape[1]
    out = torch.empty((num_segments, d), dtype=src.dtype, device=src.device)
    if num_segments == 0 or d == 0:
        return out
    keys, perm, gathered = _sort_on_card(seg, num_segments, idx)
    launch_gather_sum(src, perm if idx is None else gathered, keys,
                      segment_index(keys, num_segments), out, op=name)
    LAUNCHES[name] += 1
    return out


def segment_spmm(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The dense call form of :func:`segment_spmm_ragged`: out[s] = sum of
    msg[e] over the edges with seg[e] == s, in msg's dtype (float32
    accumulation), for ``seg`` [E] int32 in any order; edges with seg < 0
    or seg >= num_segments are dropped. On the card: the stable radix sort
    of the ids, then the CSR kernel; no backward (see ``forbid_grad``)."""
    if _check_sum_args(msg, seg, num_segments):
        return segment_spmm_ref(msg, seg, num_segments)
    forbid_grad("segment_spmm", msg)
    with torch.cuda.device(msg.device):
        return _dense_on_card(msg, None, seg, num_segments, "segment_spmm")


def gather_spmm(
    feats: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The dense call form of :func:`gather_spmm_ragged`: out[s] = sum of
    feats[idx[e]] over the edges with seg[e] == s, in feats' dtype (float32
    accumulation); ``idx`` (rows of feats, < 0 dropped) and ``seg`` (< 0 or
    >= num_segments dropped) [E] int32 in any order. On the card: the
    stable radix sort of ``seg``, carrying ``idx[perm]``, then the gather
    kernel; no backward (see ``forbid_grad``)."""
    if on_cpu(feats, idx, seg):
        return gather_spmm_ref(feats, idx, seg, num_segments)
    _check_gather_args(feats, idx, seg, num_segments, None)
    forbid_grad("gather_spmm", feats)
    with torch.cuda.device(feats.device):
        return _dense_on_card(feats, idx, seg, num_segments, "gather_spmm")


def _gat_on_card(logits, msg, seg, num_segments, stats):
    """Checked CUDA tensors (logits [E, H] float32, msg [E, H, dh], n, H,
    dh > 0) through the forward kernel: (out, CSR index)."""
    e, h, dh = msg.shape
    out = torch.empty((num_segments, h, dh), dtype=msg.dtype, device=msg.device)
    index = segment_index(seg, num_segments)
    launch_gat_softmax_aggregate(logits, msg, seg, index, out, stats,
                                 op="gat_softmax_aggregate")
    LAUNCHES["gat_softmax_aggregate"] += 1
    return out, index


class _GatSoftmaxAggregate(torch.autograd.Function):
    """The all-heads forward kernel, keeping each (row, head)'s max and
    denominator, and the backward kernel."""

    @staticmethod
    def forward(ctx, logits, msg, seg, num_segments):
        stats = torch.empty((2, num_segments, msg.shape[1]), dtype=torch.float32,
                            device=msg.device)
        out, index = _gat_on_card(logits, msg, seg, num_segments, stats)
        ctx.save_for_backward(logits, msg, seg, index, out, stats)
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, msg, seg, index, out, stats = ctx.saved_tensors
        dlogit, dmsg = gat_softmax_aggregate_backward(grad, logits, msg, seg, index, out, stats)
        return dlogit, dmsg, None, None


def gat_softmax_aggregate_backward(grad, logits, msg, seg, index, out, stats):
    """(d logits [E, H] float32, d msg [E, H, dh]) of the all-heads
    forward on the card, from the tensors it kept (float32 logits [E, H],
    msg, seg and its CSR index, out [n, H, dh], stats [2, n, H]) and the
    upstream ``grad`` [n, H, dh]: one launch of ``csrc/gat_softmax_backward.cu``.
    The plain twin is ``ref.gat_softmax_aggregate_backward_ref`` (one head)."""
    dmsg = torch.empty_like(msg)
    dlogit = torch.empty_like(logits)
    with torch.cuda.device(msg.device):
        launch_gat_softmax_aggregate_backward(
            logits, msg, out, grad.contiguous(), stats, seg, index, dmsg, dlogit
        )
    LAUNCHES["gat_softmax_aggregate_backward"] += 1
    return dlogit, dmsg


def gat_softmax_aggregate(
    logits: torch.Tensor, msg: torch.Tensor, seg: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """out[s] = sum_e softmax_{seg==s}(logits)[e] * msg[e] per head, with
    ``max(z, 1e-9)`` so empty segments give 0, in msg's dtype.

    One head: logits [E], msg [E, D] -> [n, D]. All heads: logits [E, H],
    msg [E, H, dh] -> [n, H, dh]. Logits are taken as float32.
    Differentiable in logits and msg; on the card the backward is one
    kernel launch."""
    heads = logits.dim() == 2
    if logits.dim() != msg.dim() - 1 or logits.shape != msg.shape[:-1] or msg.dim() not in (2, 3):
        raise ValueError(
            f"expected logits [E] with msg [E, D], or logits [E, H] with msg [E, H, dh]; "
            f"got {tuple(logits.shape)} and {tuple(msg.shape)}"
        )
    if on_cpu(logits, msg, seg):
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
    if num_segments == 0 or h == 0 or dh == 0:
        return torch.zeros(out_shape, dtype=msg.dtype, device=msg.device)
    e = msg.shape[0]
    lf = logits.to(torch.float32).contiguous().view(e, h)
    mv = msg.view(e, h, dh)
    with torch.cuda.device(msg.device):
        if torch.is_grad_enabled() and (lf.requires_grad or mv.requires_grad):
            out = _GatSoftmaxAggregate.apply(lf, mv, seg, num_segments)
        else:
            out, _ = _gat_on_card(lf, mv, seg, num_segments, None)
    return out.view(out_shape)


def segment_max_keys(num_segments: int, device) -> torch.Tensor:
    """The 32-bit key scratch of :func:`launch_segment_max` for
    ``num_segments`` segments (the library's ``segment_max_key_words``:
    whole lines of 32 keys)."""
    words = library("segment_max").segment_max_key_words(num_segments)
    return torch.empty(words, dtype=torch.int32, device=device)


def launch_segment_max(x, seg, keys, out) -> None:
    """Launch ``csrc/segment_max.cu`` on checked CUDA tensors (x [E], seg
    [E], the scratch ``keys`` from :func:`segment_max_keys`, out [n] in x's
    dtype; n > 0). Counts nothing."""
    code = library("segment_max").segment_max(
        x.data_ptr(),
        seg.data_ptr(),
        seg.shape[0],
        out.shape[0],
        _DTYPE_CODE[x.dtype],
        keys.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "segment_max")


def segment_max(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """out[s] = max over edges e with seg[e] == s of x[e], in x's dtype;
    0.0 for an empty segment or a max that is not finite. x [E] float32 or
    bfloat16; seg [E] int32 in any order, edges with seg < 0 or
    seg >= num_segments ignored. The semantics of ``ref.segment_max_ref``
    (NaN above +inf, -0.0 below +0.0), bit for bit."""
    if on_cpu(x, seg):
        return segment_max_ref(x, seg, num_segments)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D tensor, got {tuple(x.shape)}")
    _check_index(seg, x.shape[0], "seg")
    if not 0 <= num_segments < _INT_MAX or x.shape[0] >= _INT_MAX:
        raise ValueError(f"sizes out of int32 range: E={x.shape[0]} n={num_segments}")
    forbid_grad("segment_max", x)
    out = torch.empty(num_segments, dtype=x.dtype, device=x.device)
    if num_segments == 0:
        return out
    with torch.cuda.device(x.device):
        launch_segment_max(x, seg, segment_max_keys(num_segments, x.device), out)
    LAUNCHES["segment_max"] += 1
    return out
