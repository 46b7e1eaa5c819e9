"""The kernels that complete a training batch on the card.

A batch producer writes the relabelled batch: the edge lists, the table's
global vertex ids, and the feature rows only where the card cannot read
the matrix (``models/gnn/batching.py``). ``batching.complete_batch``, the
one place a batch's counts and orders are built, turns such a batch,
moved to its device, into the batch the model reads with three wrappers:

* :func:`sort_edges`: the stable radix sort of ``csrc/segment_sort.cu``
  (padding and ids >= n last), which can also gather a second id array in
  the sorted order: one pass gives a layer's ``layer_dst_order`` and
  ``layer_src[by_dst]``, a second sort of that the ``layer_src_order``.
* :func:`sorted_counts`: each row's edges read off the dst-sorted keys
  (``csrc/batch_finish.cu``), no atomics.
* :func:`table_rows`, for a batch without rows: the padded feature table,
  ``table[ids]`` with zero padding rows (``csrc/batch_finish.cu``). The
  table is a float32 tensor in pinned host memory, read in place by the
  card, or on the card; :class:`HostTable` makes such a pinned copy of a
  feature matrix.

A CPU tensor runs the plain version in ``ref.py``. Each kernel launched
adds one to ``LAUNCHES[name]`` here, not to ``fused_gnn.LAUNCHES``, which
counts the model's kernels: ``segment_sort`` counts the sort's kernels
(three a pass) that completing a batch launches.
"""
from __future__ import annotations

import mmap
import os

import numpy as np
import torch

from repro_torch.kernels.build import check, library, on_cpu
from repro_torch.kernels.fused_gnn import launch_segment_sort
from repro_torch.kernels.ref import segment_sort_ref, sorted_counts_ref, table_rows_ref

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "HostTable",
    "launch_table_rows",
    "launch_sorted_counts",
    "table_rows",
    "sort_edges",
    "sorted_counts",
]

LAUNCHES = {"table_rows": 0, "segment_sort": 0, "sorted_counts": 0}

_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class HostTable:
    """A float32 copy of a feature matrix in page-locked host memory, mapped
    into the card's address space: :func:`table_rows` reads its rows in
    place, so the matrix stays in the host tier. It takes the matrix's
    rows times columns times 4 bytes of host memory, page-locked, until
    :meth:`close` unlocks and frees it.

    A copy in a mapping of its own, registered by this process: CUDA may
    keep page-locked ranges out of a process forked later, so neither the
    matrix (a respawned batch producer reads it) nor memory beside the copy
    is locked. A process forked from the owner never unlocks it."""

    def __init__(self, feats: np.ndarray):
        rows, dim = feats.shape
        nbytes = rows * dim * 4
        self._map = mmap.mmap(-1, max(nbytes, 1), flags=mmap.MAP_PRIVATE)
        self._array = np.frombuffer(self._map, np.float32, rows * dim).reshape(rows, dim)
        self._array[...] = feats
        self._owner = os.getpid()
        if nbytes:
            check(library("batch_finish").host_register(self._array.ctypes.data, nbytes),
                  "host_register")
        self.tensor = torch.from_numpy(self._array)

    @property
    def nbytes(self) -> int:
        return 0 if self._array is None else self._array.nbytes

    def close(self) -> None:
        """Unlock and free the copy; the caller has waited for every kernel
        that reads it. Idempotent."""
        array, self._array, self.tensor, self._map = self._array, None, None, None
        if array is not None and array.nbytes and os.getpid() == self._owner:
            check(library("batch_finish").host_unregister(array.ctypes.data), "host_unregister")
        # the mapping goes with the last array or tensor that views it


def _vec(dim: int, *ts: torch.Tensor) -> int:
    """Floats a load: 4, 2 or 1, dividing the row and every base address."""
    vec = 4
    while vec > 1 and (dim % vec or any(t.data_ptr() % (vec * 4) for t in ts)):
        vec //= 2
    return vec


def launch_table_rows(table, ids, out) -> None:
    """Launch ``table_rows`` (``csrc/batch_finish.cu``) on checked tensors:
    table float32 [N, F] pinned on the host or on the card, ids int64 [V]
    and out float32 [V, F] on the card. Counts nothing."""
    n, dim = table.shape
    code = library("batch_finish").table_rows(
        table.data_ptr(), n, dim, ids.data_ptr(), ids.shape[0], _vec(dim, table, out),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    check(code, "table_rows")


def table_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float32 [len(ids), F] on ``ids``' device: row ``ids[r]`` of ``table``
    [N, F], a zero row where ``ids[r]`` is padding (< 0) or >= N. On the
    card the table is float32, contiguous, and pinned on the host (the
    card reads it in place) or on the card."""
    if on_cpu(ids):
        return table_rows_ref(table, ids)
    if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
        raise TypeError(f"ids must be a contiguous 1-D int64 tensor, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise TypeError(f"table must be a contiguous 2-D float32 tensor, got {table.dtype} "
                        f"{tuple(table.shape)}")
    if table.device != ids.device and not (table.device.type == "cpu" and table.is_pinned()):
        raise ValueError(f"table must be pinned host memory or on {ids.device}, "
                         f"got {table.device}")
    if ids.shape[0] > _INT_MAX:
        raise ValueError(f"too many rows for int32: {ids.shape[0]}")
    with torch.cuda.device(ids.device):
        out = torch.empty((ids.shape[0], table.shape[1]), dtype=torch.float32,
                          device=ids.device)
        launch_table_rows(table, ids, out)
        LAUNCHES["table_rows"] += 1
        return out


def _check_ids(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{what} must be a contiguous 1-D int32 tensor, got {t.dtype} "
                        f"{tuple(t.shape)}")


def sort_edges(seg: torch.Tensor, num_rows: int, idx: torch.Tensor | None = None):
    """``(keys, perm, idx[perm])`` of int32 ids ``seg`` [E]: ``perm``
    stable-sorts them by key, the id or ``num_rows`` for padding (< 0) and
    ids >= num_rows, which so come last; ``keys`` are the sorted keys; the
    third is None without ``idx`` [E] int32. On the card: the radix sort of
    ``csrc/segment_sort.cu``, gathering ``idx`` in its last pass."""
    if on_cpu(seg):
        perm = segment_sort_ref(seg, num_rows)
        keys = seg.masked_fill((seg < 0) | (seg >= num_rows), num_rows)[perm.long()]
        return keys, perm, None if idx is None else idx[perm.long()]
    _check_ids(seg, "seg")
    if idx is not None:
        _check_ids(idx, "idx")
        if idx.shape != seg.shape or idx.device != seg.device:
            raise ValueError(f"idx must match seg: {tuple(idx.shape)} on {idx.device}")
    if not 0 <= num_rows <= _INT_MAX:
        raise ValueError(f"num_rows out of int32 range: {num_rows}")
    with torch.cuda.device(seg.device):
        keys = torch.empty_like(seg)
        perm = torch.empty_like(seg)
        gathered = None if idx is None else torch.empty_like(seg)
        LAUNCHES["segment_sort"] += launch_segment_sort(seg, num_rows, keys, perm, idx, gathered)
        return keys, perm, gathered


def launch_sorted_counts(keys, out) -> None:
    """Launch ``sorted_counts`` (``csrc/batch_finish.cu``) on checked card
    tensors: keys int32 [E] ascending, out float32 [n, 1]. Counts nothing."""
    code = library("batch_finish").sorted_counts(
        keys.data_ptr(), keys.shape[0], out.shape[0], out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(code, "sorted_counts")


def sorted_counts(keys: torch.Tensor, num_rows: int) -> torch.Tensor:
    """float32 [num_rows, 1]: how many of ``keys`` (int32 [E], ascending, as
    :func:`sort_edges` gives them) equal each row in [0, num_rows); keys
    out of that range count for none."""
    if on_cpu(keys):
        return sorted_counts_ref(keys, num_rows)
    _check_ids(keys, "keys")
    if not 0 <= num_rows <= _INT_MAX:
        raise ValueError(f"num_rows out of int32 range: {num_rows}")
    with torch.cuda.device(keys.device):
        out = torch.empty((num_rows, 1), dtype=torch.float32, device=keys.device)
        launch_sorted_counts(keys, out)
        LAUNCHES["sorted_counts"] += 1
        return out
