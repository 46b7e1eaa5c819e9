"""DEPRECATED module — the caching system moved to ``repro_torch.core.storage``.

Copy of ``repro/core/inference/cache.py`` (imports rewritten).

``TwoLevelCache`` survives as a thin shim over a two-tier
:class:`repro_torch.core.storage.HybridCache` (``memory`` → ``disk`` over the
store), kept for one release of deprecation, mirroring the
``backend.sample()`` playbook.  The accounting contract is unchanged:

    fill_chunks   chunks fetched from DFS (static fill + demand misses)
    static_reads  dynamic misses served by the static disk level
    dynamic_hits  in-memory hits

The historic fill-free bug — ``dynamic_capacity`` stuck at 0 so the dynamic
tier evicted on every insert — is fixed by the hybrid cache's auto-sizing:
capacity grows with the chunks admitted below, so LRU vs FIFO behave
differently even without a ``fill_static`` call.

New code should build a ``HybridCache`` directly (pluggable tiers and
policies, including the PDS-locality-aware one).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from repro_torch.core.storage import HybridCache, IOCost, build_tiers
from repro_torch.core.storage.store import DFSTier

__all__ = ["CachePolicy", "CacheStats", "TwoLevelCache"]


class CachePolicy(str, Enum):
    """Legacy two-policy enum; the full set lives in
    ``repro_torch.core.storage.CACHE_POLICIES`` (fifo, lru, locality, ...)."""

    FIFO = "fifo"
    LRU = "lru"


@dataclass
class CacheStats:
    fill_chunks: int = 0  # DFS fetches during static fill
    static_reads: int = 0  # dynamic misses served by static disk
    dynamic_hits: int = 0
    rows_served: int = 0

    @property
    def total_chunk_reads(self) -> int:
        return self.static_reads

    @property
    def dynamic_hit_ratio(self) -> float:
        tot = self.static_reads + self.dynamic_hits
        return self.dynamic_hits / tot if tot else 0.0

    def modeled_time_ms(self, cost: IOCost) -> float:
        return (
            self.fill_chunks * cost.dfs_ms
            + self.static_reads * cost.disk_ms
            + self.dynamic_hits * cost.mem_ms
        )


class _LiveCacheStats(CacheStats):
    """A ``CacheStats`` whose counters read through to a ``HybridCache``
    live, so legacy code that keeps a reference to ``cache.stats`` and
    reads it later keeps seeing current values."""

    def __init__(self, hybrid: HybridCache):
        self._hybrid = hybrid

    fill_chunks = property(lambda self: self._hybrid.stats.fill_chunks)
    static_reads = property(lambda self: self._hybrid.stats.static_reads)
    dynamic_hits = property(lambda self: self._hybrid.stats.dynamic_hits)
    rows_served = property(lambda self: self._hybrid.stats.rows_served)


class TwoLevelCache:
    """DEPRECATED shim: a ``memory -> disk`` ``HybridCache`` behind the
    historic two-level surface (``fill_static`` + ``read_rows``)."""

    def __init__(
        self,
        store: DFSTier,
        policy: CachePolicy = CachePolicy.FIFO,
        dynamic_frac: float = 0.10,
    ):
        self.store = store
        self.policy = CachePolicy(policy)
        self.dynamic_frac = dynamic_frac
        self.hybrid = HybridCache(
            store,
            build_tiers(
                ("memory", "disk"), store.chunk_rows, store.dim, dtype=store.dtype
            ),
            policy=self.policy.value,
            dynamic_frac=dynamic_frac,
        )
        self.stats = _LiveCacheStats(self.hybrid)

    # -- legacy surface -----------------------------------------------------
    def fill_static(self, rows_needed: np.ndarray) -> None:
        """Fetch from DFS every chunk containing a needed row (now an
        explicit ``plan_fill`` + ``fill`` on the hybrid cache)."""
        self.hybrid.fill(self.hybrid.plan_fill(rows_needed))

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        return self.hybrid.read_rows(rows)

    @property
    def dynamic_capacity(self) -> int:
        return self.hybrid._effective_capacity(0)
