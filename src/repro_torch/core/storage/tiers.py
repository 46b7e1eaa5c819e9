"""Cache tiers above the authoritative store (paper §III-D hierarchy).

A ``StorageTier`` is chunk-granular bounded storage: the ``HybridCache``
stacks tiers fast→slow (e.g. ``memory`` → ``disk``) over a ``DFSTier`` and
moves whole chunks between them.  Row-level access (``read_rows`` /
``write_rows`` / ``contains``) is batched through the shared ``chunk_runs``
argsort path, so a tier never scans per-row.

``MemoryTier``   chunk blocks held as live ndarrays (the dynamic cache).
``DiskTier``     the worker-local static cache.  By default blocks stay in
                 RAM but are *accounted* at disk cost (the historic
                 ``TwoLevelCache`` static level, and what the engine uses);
                 give it a ``path`` to actually spill chunks to .npy files
                 for out-of-core operation.

New tier kinds register in ``STORAGE_TIERS`` and become available to
``GLISPConfig.storage_tiers`` by name.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch import tracing
from repro_torch.core.storage.store import (
    ChunkReadError,
    _corrupt_block,
    block_checksum,
    chunk_runs,
)
from repro_torch.utils import Registry

__all__ = [
    "STORAGE_TIERS",
    "DiskTier",
    "MemoryTier",
    "StorageTier",
    "TierStats",
]


@dataclass
class TierStats:
    """Per-tier accounting rolled up by ``HybridCache.stats``."""

    kind: str = ""
    hits: int = 0  # chunk reads served by this tier
    admits: int = 0  # chunks written into this tier
    evictions: int = 0  # chunks dropped to stay within capacity
    retries: int = 0  # chunk reads that succeeded only after retry
    failovers: int = 0  # chunks this tier failed to serve (fell through
    # to a slower tier / the authoritative store)


@runtime_checkable
class StorageTier(Protocol):
    """Chunk-granular bounded storage; one level of a ``HybridCache``.

    ``capacity`` is in chunks; ``None`` means unbounded.  Row-level calls
    are batched by chunk via ``chunk_runs`` — implementations must never
    loop per row."""

    kind: str
    chunk_rows: int
    dim: int
    capacity: int | None
    stats: TierStats

    def read_chunk(self, c: int) -> np.ndarray: ...

    def write_chunk(self, c: int, block: np.ndarray) -> None: ...

    def delete_chunk(self, c: int) -> None: ...

    def contains(self, chunks: np.ndarray) -> np.ndarray: ...

    def read_rows(self, rows: np.ndarray) -> np.ndarray: ...

    def write_rows(self, rows: np.ndarray, values: np.ndarray) -> None: ...

    def chunk_ids(self) -> list[int]: ...

    def __len__(self) -> int: ...

    def __contains__(self, c: int) -> bool: ...


class _ChunkTierBase:
    """Shared row-level plumbing: chunk addressing + batched gathers."""

    kind = "base"

    def __init__(
        self,
        chunk_rows: int,
        dim: int,
        *,
        capacity: int | None = None,
        dtype=np.float32,
        faults=None,
    ):
        self.chunk_rows = chunk_rows
        self.dim = dim
        self.capacity = capacity
        self.dtype = dtype
        self.stats = TierStats(kind=self.kind)
        # optional FaultInjector: reads fire "<kind>.read" (transient
        # error) and "<kind>.corrupt" (bit-flipped payload) sites
        self.faults = faults

    def _fire_read(self) -> None:
        if self.faults is not None:
            self.faults.fire(f"{self.kind}.read")

    def _maybe_corrupt(self, block: np.ndarray) -> np.ndarray:
        if self.faults is not None and self.faults.should_fail(
            f"{self.kind}.corrupt"
        ):
            return _corrupt_block(block)
        return block

    # chunk-level interface subclasses fill in -----------------------------
    def read_chunk(self, c: int) -> np.ndarray:
        raise NotImplementedError

    def write_chunk(self, c: int, block: np.ndarray) -> None:
        raise NotImplementedError

    def delete_chunk(self, c: int) -> None:
        raise NotImplementedError

    def chunk_ids(self) -> list[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.chunk_ids())

    def __contains__(self, c: int) -> bool:
        return bool(self.contains(np.asarray([c]))[0])

    # batched row-level interface ------------------------------------------
    def contains(self, chunks: np.ndarray) -> np.ndarray:
        held = set(self.chunk_ids())
        chunks = np.asarray(chunks, dtype=np.int64)
        return np.fromiter(
            (int(c) in held for c in chunks), dtype=bool, count=chunks.shape[0]
        )

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """Gather rows held by this tier (caller guarantees residency),
        grouped by chunk via one argsort."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.empty((rows.shape[0], self.dim), dtype=self.dtype)
        for c, pos, crows in chunk_runs(rows, self.chunk_rows):
            out[pos] = self.read_chunk(c)[crows - c * self.chunk_rows]
        return out

    def write_rows(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Scatter rows into resident chunks (read-modify-write per chunk)."""
        rows = np.asarray(rows, dtype=np.int64)
        values = np.asarray(values)
        for c, pos, crows in chunk_runs(rows, self.chunk_rows):
            block = self.read_chunk(c)
            block[crows - c * self.chunk_rows] = values[pos]
            self.write_chunk(c, block)

    def clear(self) -> None:
        for c in list(self.chunk_ids()):
            self.delete_chunk(c)

    def __repr__(self) -> str:
        cap = "inf" if self.capacity is None else self.capacity
        return f"{type(self).__name__}(chunks={len(self)}, capacity={cap})"


STORAGE_TIERS: Registry = Registry("storage tier")


@STORAGE_TIERS.register("memory")
class MemoryTier(_ChunkTierBase):
    """Chunk blocks as live ndarrays — the dynamic in-memory cache level."""

    kind = "memory"

    def __init__(self, chunk_rows: int, dim: int, **kw):
        super().__init__(chunk_rows, dim, **kw)
        self._blocks: dict[int, np.ndarray] = {}

    def read_chunk(self, c: int) -> np.ndarray:
        self._fire_read()
        return self._blocks[c]

    def write_chunk(self, c: int, block: np.ndarray) -> None:
        self._blocks[c] = block

    def delete_chunk(self, c: int) -> None:
        self._blocks.pop(c, None)

    def chunk_ids(self) -> list[int]:
        return list(self._blocks)

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, c: int) -> bool:
        return c in self._blocks


@STORAGE_TIERS.register("disk")
class DiskTier(_ChunkTierBase):
    """The worker-local static cache level.

    With ``path=None`` (default) blocks live in RAM but are charged at
    ``IOCost.disk_ms`` — the historic ``TwoLevelCache`` static dict, which
    models a local SSD without paying real file I/O in tests.  With a
    ``path`` every chunk is spilled to ``<path>/tier_<c>.npy`` and reads
    load from disk, for genuinely out-of-core feature/embedding serving."""

    kind = "disk"

    def __init__(self, chunk_rows: int, dim: int, *, path: str | None = None, **kw):
        super().__init__(chunk_rows, dim, **kw)
        self.path = path
        self._blocks: dict[int, np.ndarray] = {}  # path=None backing
        self._held: set[int] = set()  # path!=None backing
        # checksums guard the real-file backing only: RAM-backed blocks
        # are shared by reference across tiers (and legitimately mutated
        # through write_rows), so hashing them would false-positive
        self._sums: dict[int, int] = {}
        if path is not None:
            os.makedirs(path, exist_ok=True)

    def _chunk_file(self, c: int) -> str:
        return os.path.join(self.path, f"tier_{c:06d}.npy")

    def read_chunk(self, c: int) -> np.ndarray:
        self._fire_read()
        if self.path is None:
            return self._blocks[c]
        fn = self._chunk_file(c)
        if not os.path.exists(fn):
            raise ChunkReadError(
                f"chunk {c} of DiskTier missing: no file at {fn}"
            )
        try:
            with tracing.span("storage.chunk_read"):
                block = np.load(fn)
        except (ValueError, EOFError, OSError) as exc:
            raise ChunkReadError(
                f"chunk {c} of DiskTier unreadable "
                f"(truncated or corrupt file): {fn}: {exc}"
            ) from exc
        block = self._maybe_corrupt(block)
        want = self._sums.get(c)
        if want is not None and block_checksum(block) != want:
            raise ChunkReadError(
                f"chunk {c} of DiskTier failed checksum verification: {fn}"
            )
        return block

    def write_chunk(self, c: int, block: np.ndarray) -> None:
        if self.path is None:
            self._blocks[c] = block
            return
        # tmp + replace: a failed write never leaves a partial .npy behind
        # (and never clobbers a previously good chunk file)
        fn = self._chunk_file(c)
        tmp = fn + ".tmp"
        try:
            with tracing.span("storage.chunk_write"):
                with open(tmp, "wb") as fh:
                    np.save(fh, block)
                os.replace(tmp, fn)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self._sums[c] = block_checksum(block)
        self._held.add(c)

    def delete_chunk(self, c: int) -> None:
        if self.path is None:
            self._blocks.pop(c, None)
            return
        if c in self._held:
            self._held.discard(c)
            self._sums.pop(c, None)
            try:
                os.remove(self._chunk_file(c))
            except OSError:
                pass

    def chunk_ids(self) -> list[int]:
        return list(self._blocks) if self.path is None else list(self._held)

    def __len__(self) -> int:
        return len(self._blocks) if self.path is None else len(self._held)

    def __contains__(self, c: int) -> bool:
        return c in (self._blocks if self.path is None else self._held)
