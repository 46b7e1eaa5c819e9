"""The authoritative chunked store — the Zarr-on-DFS stand-in (paper §III-D).

The full embedding/feature matrix of one GNN layer is chunked into fixed-row
files (paper: chunk 32768 rows, Blosclz-compressed, on HDFS).  Here chunks
are .npy files (optionally zlib-compressed .npz) in a local directory, with
explicit read counters and an I/O *cost model* so benchmarks can report
modeled DFS/disk/memory retrieval times without a real HDFS cluster:

    IOCost.dfs_ms    per-chunk read from the remote store (paper: HDFS)
    IOCost.disk_ms   per-chunk read from the worker-local disk tier
    IOCost.mem_ms    per-chunk hit in the in-memory tier

``DFSTier`` is the bottom (authoritative) tier of a ``HybridCache`` stack —
it is never evicted from and always ``contains`` every chunk.  The historic
name ``ChunkedEmbeddingStore`` survives as a deprecation shim in
``repro.core.inference.store``.
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch import tracing
from repro_torch.utils import ceil_div

try:  # xxhash is faster when available; the container may not ship it
    import xxhash  # type: ignore[import-not-found]
except ModuleNotFoundError:  # pragma: no cover - depends on environment
    xxhash = None

__all__ = [
    "ChunkCorruptionError",
    "ChunkReadError",
    "DFSTier",
    "IOCost",
    "StoreStats",
    "block_checksum",
    "chunk_runs",
]


class ChunkReadError(IOError):
    """A chunk could not be read: file missing, truncated, or unparseable.

    Always names the chunk id and file path so a failed tier read is
    actionable from the message alone."""


class ChunkCorruptionError(ChunkReadError):
    """A chunk was read but failed checksum verification."""


def block_checksum(block: np.ndarray) -> int:
    """Content checksum of one chunk block (xxhash64 when available,
    else crc32).  Computed over the raw bytes of the C-contiguous array,
    so any bit flip in the stored payload is detected."""
    with tracing.span("storage.checksum"):
        data = np.ascontiguousarray(block)
        if xxhash is not None:
            return xxhash.xxh64(data.tobytes()).intdigest()
        return zlib.crc32(data.tobytes())


def _corrupt_block(block: np.ndarray) -> np.ndarray:
    """Bit-flipped copy of a block — the injected-corruption payload.
    The shape/dtype are preserved so only checksum verification (not an
    earlier shape check) can catch it, which is the property under test."""
    bad = np.array(block, copy=True)
    flat = bad.view(np.uint8).reshape(-1)
    if flat.shape[0]:
        flat[0] ^= 0xFF
    return bad


def chunk_runs(rows: np.ndarray, chunk_rows: int, *, assume_sorted: bool = False):
    """Group row ids by chunk with one argsort (no O(rows) boolean mask per
    chunk).  Yields ``(chunk_id, positions, chunk_rows_sorted)`` per distinct
    chunk, where ``positions`` indexes the original ``rows`` array and
    ``chunk_rows_sorted`` are the corresponding row ids in stable order
    (ascending when the input is sorted).

    ``assume_sorted=True`` skips the argsort entirely for callers that hand
    in already-ascending rows (positions become contiguous ranges) — the
    write path's pre-sort no longer pays for a second, redundant sort."""
    chunk_ids = rows // chunk_rows
    if assume_sorted:
        uniq, run_starts = np.unique(chunk_ids, return_index=True)
        run_ends = np.append(run_starts[1:], chunk_ids.shape[0])
        for c, a, b in zip(uniq, run_starts, run_ends):
            yield int(c), np.arange(a, b, dtype=np.int64), rows[a:b]
        return
    order = np.argsort(chunk_ids, kind="stable")
    sorted_rows = rows[order]
    sorted_chunks = chunk_ids[order]
    uniq, run_starts = np.unique(sorted_chunks, return_index=True)
    run_ends = np.append(run_starts[1:], sorted_chunks.shape[0])
    for c, a, b in zip(uniq, run_starts, run_ends):
        yield int(c), order[a:b], sorted_rows[a:b]


@dataclass
class IOCost:
    # Defaults modeled on the paper's setting: HDFS round-trip ≫ local SSD ≫
    # memory.  Only *ratios* matter for speedup numbers.
    dfs_ms: float = 20.0
    disk_ms: float = 2.0
    mem_ms: float = 0.05
    # custom STORAGE_TIERS kinds price here (kind -> per-chunk ms); a kind
    # in neither map falls back to disk_ms so a registered extension tier
    # never crashes the stats rollup
    extra_ms: dict = field(default_factory=dict)

    def per_chunk_ms(self, tier_kind: str) -> float:
        """Modeled per-chunk retrieval time for one tier kind."""
        builtin = {
            "memory": self.mem_ms,
            "disk": self.disk_ms,
            "dfs": self.dfs_ms,
        }
        if tier_kind in builtin:
            return builtin[tier_kind]
        return float(self.extra_ms.get(tier_kind, self.disk_ms))


@dataclass
class StoreStats:
    chunk_writes: int = 0
    chunk_reads: int = 0  # reads that actually hit this store
    rows_read: int = 0


class DFSTier:
    """One [N, D] matrix as fixed-size row chunks — the authoritative tier.

    Rows are indexed by the *reordered* consecutive local id (paper §III-D:
    the reorder algorithm assigns the IDs; chunk = id // chunk_rows)."""

    kind = "dfs"

    def __init__(
        self,
        path: str,
        num_rows: int,
        dim: int,
        chunk_rows: int = 32768,
        compress: bool = False,
        dtype=np.float32,
        *,
        faults=None,
    ):
        """``faults`` is an optional ``FaultInjector``; reads then fire the
        ``dfs.read`` site (transient read error) and the ``dfs.corrupt``
        site (bit-flipped payload, caught by checksum verification)."""
        self.path = path
        self.num_rows = num_rows
        self.dim = dim
        self.chunk_rows = chunk_rows
        self.compress = compress
        self.dtype = dtype
        self.num_chunks = ceil_div(num_rows, chunk_rows)
        self.stats = StoreStats()
        self.faults = faults
        # checksum per chunk, recorded at write and verified at read —
        # in-memory because this process is the only writer (the DFS
        # stand-in); a real deployment would persist them beside the chunk
        self._sums: dict[int, int] = {}
        os.makedirs(path, exist_ok=True)

    # -- chunk addressing ----------------------------------------------------
    def chunk_of(self, rows: np.ndarray) -> np.ndarray:
        return np.asarray(rows) // self.chunk_rows

    def _chunk_file(self, c: int) -> str:
        return os.path.join(
            self.path, f"chunk_{c:06d}.{'npz' if self.compress else 'npy'}"
        )

    def contains(self, chunks: np.ndarray) -> np.ndarray:
        """Authoritative: every valid chunk id is present by definition."""
        chunks = np.asarray(chunks, dtype=np.int64)
        return (chunks >= 0) & (chunks < self.num_chunks)

    # -- IO -------------------------------------------------------------------
    def write_rows(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Write rows (values[i] -> row rows[i]); one argsort groups by chunk
        AND pre-sorts within each chunk (``chunk_runs`` gets the
        ``assume_sorted`` hint, so nothing is sorted twice).  A write that
        covers every row of a chunk skips the read-modify-write and stores
        the values slice directly (workers write disjoint row ranges)."""
        with tracing.span("storage.store_write"):
            rows = np.asarray(rows, dtype=np.int64)
            values = np.asarray(values)
            order = np.argsort(rows, kind="stable")
            rows, values = rows[order], values[order]
            for c, pos, crows in chunk_runs(rows, self.chunk_rows, assume_sorted=True):
                base = c * self.chunk_rows
                nrows = min(self.chunk_rows, self.num_rows - base)
                off = crows - base
                if off.shape[0] == nrows and np.array_equal(
                    off, np.arange(nrows, dtype=np.int64)
                ):
                    block = np.ascontiguousarray(values[pos], dtype=self.dtype)
                else:
                    block = self._read_chunk_raw(c, allow_missing=True)
                    block[off] = values[pos]
                self._write_chunk_raw(c, block)

    def write_chunk(self, c: int, block: np.ndarray) -> None:
        self._write_chunk_raw(c, np.ascontiguousarray(block, dtype=self.dtype))

    def _write_chunk_raw(self, c: int, block: np.ndarray) -> None:
        """Atomic chunk write: tmp in the same directory + fsync +
        ``os.replace``, so a crash mid-write leaves either the old chunk
        or the new one, never a truncated file; the tmp is removed on
        failure so partial writes leave no debris."""
        fn = self._chunk_file(c)
        tmp = fn + ".tmp"
        try:
            with tracing.span("storage.chunk_write"):
                with open(tmp, "wb") as fh:
                    if self.compress:
                        np.savez_compressed(fh, block=block)
                    else:
                        np.save(fh, block)
                    fh.flush()
                    with tracing.span("storage.fsync"):
                        os.fsync(fh.fileno())
                os.replace(tmp, fn)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self._sums[c] = block_checksum(block)
        self.stats.chunk_writes += 1

    def _read_chunk_raw(self, c: int, allow_missing: bool = False) -> np.ndarray:
        fn = self._chunk_file(c)
        nrows = min(self.chunk_rows, self.num_rows - c * self.chunk_rows)
        if not os.path.exists(fn):
            if allow_missing:
                return np.zeros((nrows, self.dim), dtype=self.dtype)
            raise ChunkReadError(
                f"chunk {c} of {type(self).__name__} missing: no file at {fn}"
            )
        try:
            with tracing.span("storage.chunk_read"):
                if self.compress:
                    with np.load(fn) as z:
                        return z["block"]
                return np.load(fn)
        except (ValueError, EOFError, KeyError, OSError) as exc:
            raise ChunkReadError(
                f"chunk {c} of {type(self).__name__} unreadable "
                f"(truncated or corrupt file): {fn}: {exc}"
            ) from exc

    def _verify(self, c: int, block: np.ndarray) -> None:
        want = self._sums.get(c)
        if want is not None and block_checksum(block) != want:
            raise ChunkCorruptionError(
                f"chunk {c} of {type(self).__name__} failed checksum "
                f"verification: {self._chunk_file(c)}"
            )

    def read_chunk(self, c: int) -> np.ndarray:
        """Counted read — a 'remote DFS fetch' in the cost model."""
        if self.faults is not None:
            self.faults.fire("dfs.read")
        block = self._read_chunk_raw(c)
        if self.faults is not None and self.faults.should_fail("dfs.corrupt"):
            block = _corrupt_block(block)
        self._verify(c, block)
        self.stats.chunk_reads += 1
        self.stats.rows_read += block.shape[0]
        return block

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """Uncached row gather (the Fig.-14a baseline: read straight from
        HDFS, one chunk fetch per distinct chunk touched); grouped by chunk
        via one argsort instead of a boolean mask scan per chunk."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.empty((rows.shape[0], self.dim), dtype=self.dtype)
        for c, pos, crows in chunk_runs(rows, self.chunk_rows):
            block = self.read_chunk(c)
            out[pos] = block[crows - c * self.chunk_rows]
        return out

    # historic spelling kept for the Fig.-14a baseline call sites
    read_rows_direct = read_rows
