"""``HybridCache`` — the tiered storage composition (paper §III-D).

One ordered tier stack (fast→slow, e.g. ``memory`` → ``disk``) over an
authoritative ``DFSTier``.  Reads walk the stack top-down; a hit at tier i
promotes the chunk into every faster tier (admission), evicting per each
tier's pluggable policy; a full miss is a demand DFS fetch, admitted at the
slowest cache tier and served from there — exactly the historic
``TwoLevelCache`` accounting when configured as ``memory + disk`` with the
``fifo`` policy:

    fill_chunks   = HybridStats.fill_chunks   (DFS fetches: fill + demand)
    static_reads  = slowest cache tier's hits (disk-served reads)
    dynamic_hits  = fastest memory tier's hits

The fill lifecycle is explicit: ``plan_fill(rows)`` computes which chunks a
slice will need (and the fill window that locality-aware eviction keys on)
without touching storage; ``fill(plan)`` executes it; ``evict()`` releases
cache residency.  The implicit ``fill_static`` of the old two-level cache is
a shim over this pair.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch import tracing
from repro_torch.core.faults import InjectedFault, RetryPolicy, as_injector
from repro_torch.core.storage.policies import EvictionPolicy, resolve_policy
from repro_torch.core.storage.store import ChunkReadError, DFSTier, IOCost, chunk_runs
from repro_torch.core.storage.tiers import STORAGE_TIERS, StorageTier, TierStats

__all__ = ["FillPlan", "HybridCache", "HybridStats", "build_tiers"]


@dataclass
class FillPlan:
    """What one ``fill`` will do, computed without touching storage."""

    chunks: np.ndarray  # every chunk the slice will read
    fetch: np.ndarray  # the subset that must come from the DFS tier
    focus_lo: int  # fill window in chunk ids — the locality
    focus_hi: int  # policy's eviction distance reference
    reset: bool = True  # drop current residency before filling

    def modeled_ms(self, cost: IOCost) -> float:
        return self.fetch.shape[0] * cost.dfs_ms

    def __repr__(self) -> str:
        return (
            f"FillPlan(chunks={self.chunks.shape[0]}, "
            f"fetch={self.fetch.shape[0]}, "
            f"focus=[{self.focus_lo}, {self.focus_hi}], reset={self.reset})"
        )


@dataclass
class HybridStats:
    """Rollup over the stack: DFS fetches + per-tier hit accounting."""

    fill_chunks: int = 0  # chunks fetched from the authoritative tier
    demand_reads: int = 0  # the subset of fill_chunks served on-demand
    # (a full cache miss, not a planned fill); NOT counted as tier hits
    rows_served: int = 0
    store_retries: int = 0  # authoritative-store reads retried
    tiers: list = field(default_factory=list)  # TierStats refs, fast→slow

    # -- fault-tolerance rollups ---------------------------------------------
    @property
    def retries(self) -> int:
        """All retried chunk reads, cache tiers + authoritative store."""
        return sum(t.retries for t in self.tiers) + self.store_retries

    @property
    def failovers(self) -> int:
        """Chunks a cache tier failed to serve (fell through to a slower
        tier or the authoritative store)."""
        return sum(t.failovers for t in self.tiers)

    # -- legacy two-level views ---------------------------------------------
    @property
    def dynamic_hits(self) -> int:
        """Hits at the fastest tier when it is a memory tier (level 2)."""
        if self.tiers and self.tiers[0].kind == "memory":
            return self.tiers[0].hits
        return 0

    @property
    def static_reads(self) -> int:
        """Reads NOT served by a leading memory tier: hits at every tier
        below the fastest, plus the fastest tier's own hits when it is not
        memory (e.g. a disk-only stack), plus demand faults.  The historic
        counter also charged demand-faulted chunks to the static level
        after fetching them, so that view is preserved here — but
        ``demand_reads`` stays out of ``TierStats.hits``, which count only
        chunks found resident."""
        reads = sum(t.hits for t in self.tiers[1:]) + self.demand_reads
        if self.tiers and self.tiers[0].kind != "memory":
            reads += self.tiers[0].hits
        return reads

    @property
    def total_chunk_reads(self) -> int:
        return self.static_reads

    @property
    def dynamic_hit_ratio(self) -> float:
        tot = self.static_reads + self.dynamic_hits
        return self.dynamic_hits / tot if tot else 0.0

    # -- tiered views --------------------------------------------------------
    def hit_ratios(self) -> dict[str, float]:
        """Per-tier fraction of all chunk retrievals (incl. DFS fetches)."""
        total = sum(t.hits for t in self.tiers) + self.fill_chunks
        out = {
            f"{i}:{t.kind}": (t.hits / total if total else 0.0)
            for i, t in enumerate(self.tiers)
        }
        out["dfs"] = self.fill_chunks / total if total else 0.0
        return out

    def modeled_time_ms(self, cost: IOCost) -> float:
        ms = self.fill_chunks * cost.dfs_ms
        for t in self.tiers:
            ms += t.hits * cost.per_chunk_ms(t.kind)
        return ms

    def as_dict(self) -> dict:
        return {
            "fill_chunks": self.fill_chunks,
            "demand_reads": self.demand_reads,
            "rows_served": self.rows_served,
            "retries": self.retries,
            "failovers": self.failovers,
            "tiers": [
                {
                    "kind": t.kind,
                    "hits": t.hits,
                    "admits": t.admits,
                    "evictions": t.evictions,
                    "retries": t.retries,
                    "failovers": t.failovers,
                }
                for t in self.tiers
            ],
        }


def build_tiers(
    names,
    chunk_rows: int,
    dim: int,
    *,
    capacities=(),
    dtype=np.float32,
    disk_path: str | None = None,
    faults=None,
) -> list[StorageTier]:
    """Materialize a fast→slow cache tier stack from registry names.

    ``capacities`` aligns with ``names``; missing or ``0`` entries mean
    "auto" (memory: sized from ``dynamic_frac`` by the cache; disk:
    unbounded).  ``disk_path`` makes disk tiers actually spill to files.
    ``faults`` (a ``FaultPlan`` or shared ``FaultInjector``) arms the
    per-tier ``<kind>.read`` / ``<kind>.corrupt`` injection sites."""
    injector = as_injector(faults)
    tiers: list[StorageTier] = []
    for i, name in enumerate(names):
        cls = STORAGE_TIERS.get(name)
        cap = int(capacities[i]) if i < len(capacities) else 0
        kw = {"capacity": None if cap == 0 else cap, "dtype": dtype}
        if injector is not None:
            kw["faults"] = injector
        if getattr(cls, "kind", None) == "disk" and disk_path is not None:
            kw["path"] = f"{disk_path}/tier{i}"
        tiers.append(cls(chunk_rows, dim, **kw))
    return tiers


class HybridCache:
    """An ordered tier stack over an authoritative ``DFSTier``."""

    def __init__(
        self,
        store: DFSTier,
        tiers: list[StorageTier] | None = None,
        *,
        policy="fifo",
        dynamic_frac: float = 0.10,
        retry_policy: RetryPolicy | None = None,
    ):
        """``retry_policy`` bounds per-read attempts against each level;
        a chunk a cache tier cannot serve after retries is dropped from
        that tier and transparently falls through to the next slower
        level (ultimately the authoritative store), recorded in that
        tier's ``TierStats.failovers``."""
        if tiers is None:
            tiers = build_tiers(("memory", "disk"), store.chunk_rows, store.dim,
                                dtype=store.dtype)
        if not tiers:
            raise ValueError("HybridCache needs at least one cache tier")
        for t in tiers:
            if t.chunk_rows != store.chunk_rows or t.dim != store.dim:
                raise ValueError(
                    f"tier {t!r} geometry differs from the store "
                    f"(chunk_rows={store.chunk_rows}, dim={store.dim})"
                )
        self.store = store
        self.tiers = list(tiers)
        self.dynamic_frac = dynamic_frac
        # one fresh policy instance per tier — a policy instance passed in
        # is only a template (its type is instantiated per tier), because a
        # live instance shared across tiers or caches would desynchronize
        # its tracked set from the tier contents and corrupt eviction
        if isinstance(policy, EvictionPolicy):
            policy = type(policy)
        self.policies: list[EvictionPolicy] = [
            resolve_policy(policy) for _ in self.tiers
        ]
        self.retry_policy = retry_policy if retry_policy is not None else RetryPolicy()
        self.retry_policy.validate()
        self.stats = HybridStats(tiers=[t.stats for t in self.tiers])
        self._seen_chunks: set[int] = set()  # distinct chunks ever admitted

    # -- capacity ------------------------------------------------------------
    def _effective_capacity(self, i: int) -> int | None:
        """Tier i's chunk budget.  Explicit capacities win; an unset memory
        tier is auto-sized as ``dynamic_frac`` of the tier below it (the
        fill set after a fill) and GROWS as chunks are admitted in
        fill-free use — the historic zero-capacity bug is gone."""
        t = self.tiers[i]
        if t.capacity is not None:
            return t.capacity
        if t.kind != "memory":
            return None  # disk-like tiers default to unbounded
        base = (
            len(self.tiers[i + 1])
            if i + 1 < len(self.tiers)
            else len(self._seen_chunks)
        )
        return max(1, int(self.dynamic_frac * base))

    # -- fill lifecycle ------------------------------------------------------
    def plan_fill(
        self,
        rows_needed: np.ndarray,
        *,
        focus_rows: np.ndarray | None = None,
        reset: bool = True,
    ) -> FillPlan:
        """Plan the static fill for one slice: every chunk holding a needed
        row, the subset that must be DFS-fetched, and the locality focus
        window (from ``focus_rows`` — e.g. the partition's own vertices —
        or the full fill range)."""
        rows = np.asarray(rows_needed, np.int64)
        chunks = np.unique(rows // self.store.chunk_rows)
        if reset or chunks.shape[0] == 0:
            fetch = chunks
        else:
            resident = np.zeros(chunks.shape[0], dtype=bool)
            for t in self.tiers:
                resident |= t.contains(chunks)
            fetch = chunks[~resident]
        if focus_rows is not None and np.asarray(focus_rows).shape[0]:
            fc = np.asarray(focus_rows, np.int64) // self.store.chunk_rows
            lo, hi = int(fc.min()), int(fc.max())
        elif chunks.shape[0]:
            lo, hi = int(chunks[0]), int(chunks[-1])
        else:
            lo = hi = 0
        return FillPlan(chunks=chunks, fetch=fetch, focus_lo=lo,
                        focus_hi=hi, reset=reset)

    def fill(self, plan: FillPlan) -> None:
        """Execute a fill: fetch ``plan.fetch`` from DFS into the slowest
        cache tier and point every policy's focus at the fill window.  The
        faster tiers start cold (the historic level-2 semantics)."""
        if plan.reset:
            self.evict()
        for pol in self.policies:
            pol.set_focus(plan.focus_lo, plan.focus_hi)
        base = len(self.tiers) - 1
        for c in plan.fetch:
            block = self._store_read(int(c))
            self.stats.fill_chunks += 1
            self._admit(base, int(c), block)

    def fill_for(self, rows_needed: np.ndarray, **kw) -> FillPlan:
        """Convenience: ``plan_fill`` + ``fill`` in one call."""
        plan = self.plan_fill(rows_needed, **kw)
        self.fill(plan)
        return plan

    def evict(self, chunks: np.ndarray | None = None) -> int:
        """Drop chunks (default: everything) from every cache tier.  The
        authoritative store is untouched; returns chunks released."""
        dropped = 0
        for t, pol in zip(self.tiers, self.policies):
            ids = t.chunk_ids() if chunks is None else [
                int(c) for c in np.asarray(chunks, np.int64) if int(c) in t
            ]
            for c in ids:
                t.delete_chunk(c)
                pol.forget(c)
                dropped += 1
        return dropped

    # -- chunk movement ------------------------------------------------------
    def _admit(self, i: int, c: int, block: np.ndarray) -> None:
        t, pol = self.tiers[i], self.policies[i]
        t.write_chunk(c, block)
        t.stats.admits += 1
        pol.on_admit(c)
        self._seen_chunks.add(c)
        cap = self._effective_capacity(i)
        if cap is not None:
            while len(t) > cap:
                v = pol.victim()
                pol.forget(v)
                t.delete_chunk(v)
                t.stats.evictions += 1

    def _tier_read(self, i: int, c: int) -> np.ndarray | None:
        """Read chunk ``c`` from tier ``i`` with bounded retries; ``None``
        when the tier cannot serve it (transient errors exhausted the
        retry budget, or the stored payload is corrupt/truncated)."""
        t = self.tiers[i]
        policy = self.retry_policy
        for attempt in range(1, policy.max_attempts + 1):
            try:
                return t.read_chunk(c)
            except (InjectedFault, ChunkReadError, OSError):
                if attempt < policy.max_attempts:
                    t.stats.retries += 1
                    policy.sleep(attempt)
        return None

    def _store_read(self, c: int) -> np.ndarray:
        """Authoritative-store read with bounded retries.  There is no
        slower level to fall through to: exhausting the budget propagates
        the store's descriptive error."""
        policy = self.retry_policy
        for attempt in range(1, policy.max_attempts):
            try:
                return self.store.read_chunk(c)
            except (InjectedFault, ChunkReadError, OSError):
                self.stats.store_retries += 1
                policy.sleep(attempt)
        return self.store.read_chunk(c)

    def _get_chunk(self, c: int) -> np.ndarray:
        for i, t in enumerate(self.tiers):
            if c not in t:
                continue
            block = self._tier_read(i, c)
            if block is None:
                # the tier cannot serve this chunk: drop the bad copy and
                # fall through to the next slower level — the read still
                # succeeds, it just costs a slower fetch
                t.delete_chunk(c)
                self.policies[i].forget(c)
                t.stats.failovers += 1
                continue
            t.stats.hits += 1
            self.policies[i].on_access(c)
            for j in range(i - 1, -1, -1):  # promote into faster tiers
                self._admit(j, c, block)
            return block
        # full miss: demand DFS fetch, admitted at the slowest cache tier
        # (the historic fill-free fallback, capacity included); counted as
        # demand_reads, never as a tier hit — the chunk wasn't resident
        block = self._store_read(c)
        self.stats.fill_chunks += 1
        self.stats.demand_reads += 1
        base = len(self.tiers) - 1
        self._admit(base, c, block)
        for j in range(base - 1, -1, -1):
            self._admit(j, c, block)
        return block

    # -- row interface -------------------------------------------------------
    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """Gather rows through the stack, grouped by chunk via one argsort;
        one ``_get_chunk`` per distinct chunk, so accounting is identical
        to a scalar read loop."""
        with tracing.span("storage.cache_read"):
            rows = np.asarray(rows, dtype=np.int64)
            out = np.empty((rows.shape[0], self.store.dim), dtype=self.store.dtype)
            for c, pos, crows in chunk_runs(rows, self.store.chunk_rows):
                block = self._get_chunk(c)
                out[pos] = block[crows - c * self.store.chunk_rows]
            self.stats.rows_served += rows.shape[0]
            return out

    def write_rows(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Write-through: rows go to the authoritative store; stale cached
        copies of the touched chunks are released."""
        rows = np.asarray(rows, dtype=np.int64)
        self.store.write_rows(rows, values)
        self.evict(np.unique(rows // self.store.chunk_rows))

    def contains(self, rows: np.ndarray) -> np.ndarray:
        """Per-row cache residency (any tier, authoritative excluded)."""
        rows = np.asarray(rows, dtype=np.int64)
        out = np.zeros(rows.shape[0], dtype=bool)
        for c, pos, _ in chunk_runs(rows, self.store.chunk_rows):
            if any(c in t for t in self.tiers):
                out[pos] = True
        return out

    def __repr__(self) -> str:
        stack = " -> ".join(t.kind for t in self.tiers)
        return (
            f"HybridCache([{stack}] over {type(self.store).__name__}, "
            f"policy={self.policies[0].name})"
        )
