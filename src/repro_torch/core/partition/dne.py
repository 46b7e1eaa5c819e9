"""Neighbor-expansion vertex-cut partitioners: DistributedNE and AdaDNE.

DistributedNE (Hanai et al., VLDB'19): every partition greedily expands an
edge set from seed vertices; per iteration it (1) selects the λ·|B_p|
smallest-degree boundary vertices, (2) allocates their unallocated incident
edges (one-hop allocation), (3) allocates unallocated edges whose two
endpoints already share a partition to the common partition with the fewest
edges (two-hop allocation), and (4) stops expanding a partition when
|E_p| > τ·|E|/|P|.

AdaDNE (the paper's contribution): replaces the hard edge threshold with an
*adaptive expansion factor* — per iteration and partition

    VS_p = |P|·|V_p| / Σ_q |V_q|          (5)
    ES_p = |P|·|E_p| / Σ_q |E_q|          (6)
    λ_p  <- λ_p · exp(α(1−VS_p) + β(1−ES_p))   (7)

so over-full partitions expand slower and under-full ones faster, giving soft
constraints on BOTH vertex and edge balance (the hard threshold is removed,
equivalent to τ = |P|).

Two execution modes share the config and the greedy policy:

``mode="lockstep"`` (default) simulates the P logical workers the way the
paper's cluster actually runs them — one *batched* expansion step per
iteration.  All partitions select their smallest-degree boundary candidates
against the same snapshot, their one-hop edge claims are resolved in one
vectorized pass (per contested edge the lowest-|E_p| partition wins, ties
broken by lower partition id via lexsort — the same greedy preference the
sequential code expresses), and membership/boundary bookkeeping is one
grouped update over (partition, vertex) pairs.  Candidate pools are kept
sorted by a static (degree, id) rank, so smallest-degree-first selection is
a prefix cut and appending new boundary vertices is a vectorized sorted
merge; no per-partition Python inner loop ever touches edges or vertices,
and nothing re-sorts or re-scans a full candidate set per iteration.

``mode="loop"`` preserves the original sequential reference implementation
(partition p sees partition p-1's allocations within the same iteration)
for before/after benchmarking and as the statistical-equivalence gate for
the lockstep rewrite.

Partition membership is a uint64 bitmask per vertex (P ≤ 64), making the
two-hop common-partition test a vectorized AND in both modes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.partition.base import (
    DEFAULT_DIRECTION,
    PartitionerBase,
    PartitionPlan,
)
from repro_torch.graph.graph import HeteroGraph
from repro_torch.utils import concat_ranges, csr_slots, incidence_csr

__all__ = [
    "NEConfig",
    "NeighborExpansionPartitioner",
    "distributed_ne",
    "adadne",
]

NE_MODES = ("lockstep", "loop")


@dataclass(frozen=True)
class NEConfig:
    # ``num_parts``/``seed`` are legacy defaults for the class-level call
    # style; the protocol call ``partition(g, num_parts, seed=...)``
    # overrides both.
    num_parts: int = 0
    adaptive: bool = False  # False -> DistributedNE, True -> AdaDNE
    lam0: float = 0.1  # initial expansion factor (DNE default)
    tau: float = 1.1  # DNE imbalance factor (ignored when adaptive)
    alpha: float = 1.0  # AdaDNE vertex-score weight
    beta: float = 1.0  # AdaDNE edge-score weight
    seed: int = 0
    max_iters: int = 100_000
    verbose: bool = False
    # Per-iteration per-partition edge-allocation budget as a fraction of
    # |E|/|P|.  The paper's clusters take thousands of fine-grained iterations
    # on billion-edge graphs; at laptop scale one unbudgeted iteration can
    # swallow 35% of the graph before the adaptive feedback (7) reacts.  The
    # budget restores the iteration granularity the algorithm assumes; it does
    # not change the expansion policy.
    budget_frac: float = 0.01
    mode: str = "lockstep"  # lockstep (vectorized) | loop (sequential legacy)
    trace: bool = True  # record the per-iteration convergence trace


# ---------------------------------------------------------------------------
# shared vectorized helpers (CSR machinery lives in ``repro.utils``)
# ---------------------------------------------------------------------------

_ranges = concat_ranges
_gather_slots = csr_slots


def _incidence(g: HeteroGraph) -> tuple[np.ndarray, np.ndarray]:
    """Undirected incidence CSR: vertex -> incident edge ids (out then in)."""
    eids = np.arange(g.num_edges, dtype=np.int64)
    return incidence_csr(g.num_vertices, [(g.src, eids), (g.dst, eids)])


def _iteration_budgets(
    lam: np.ndarray,
    bsize: np.ndarray,
    terminated: np.ndarray,
    E: int,
    budget_frac: float,
) -> np.ndarray:
    """Per-iteration edge-allocation budgets for ACTIVE partitions only.

    The continuum expansion speed of partition p is ∝ λ_p·|B_p|; one system
    iteration allocates ~budget_frac·|E| edges split proportionally, with a
    16-edge floor so tiny partitions still make progress.  Terminated
    partitions get exactly 0 — the old ``np.maximum(16, ...)`` over the full
    vector handed every partition DNE's hard threshold had already stopped a
    nonzero budget floor."""
    budgets = np.zeros(lam.shape[0], dtype=np.int64)
    active = ~terminated
    if not active.any():
        return budgets
    w = lam * np.maximum(bsize.astype(np.float64), 1.0)
    w = np.where(active, w, 0.0)
    w_norm = w / max(1e-12, float(w.sum()))
    budgets[active] = np.maximum(
        16, (budget_frac * E * w_norm[active])
    ).astype(np.int64)
    return budgets


def _flush_sequence(nE: np.ndarray, K: int) -> np.ndarray:
    """The partition sequence of ``for each of K edges: p = argmin(nE);
    nE[p] += 1`` — computed in closed form instead of an O(K·P) Python loop.

    The argmin-with-lowest-index-tiebreak greedy consumes "slots" in
    lexicographic (level, partition) order, where partition p offers slots at
    fill levels nE[p], nE[p]+1, ...; the answer is the first K slots of that
    stream.  Bit-identical to the sequential loop by construction."""
    P = int(nE.shape[0])
    if K <= 0:
        return np.zeros(0, dtype=np.int16)
    nE = nE.astype(np.int64)
    s_idx = np.argsort(nE, kind="stable")
    s = nE[s_idx]
    prefix = np.concatenate(([0], np.cumsum(s)))
    # cap_at[i] = number of slots strictly below level s[i]
    cap_at = np.arange(P, dtype=np.int64) * s - prefix[:P]
    i = int(np.searchsorted(cap_at, K, side="right")) - 1
    m = int(np.searchsorted(s, s[i], side="right"))  # parts with nE <= s[i]
    extra = K - int(cap_at[i])
    full_levels, rem = divmod(extra, m)
    level = int(s[i]) + full_levels
    fin = np.maximum(nE, level)
    active_parts = np.sort(s_idx[:m])
    fin[active_parts[:rem]] += 1
    addc = fin - nE
    part_rep = np.repeat(np.arange(P, dtype=np.int64), addc)
    levels = np.repeat(nE, addc) + _ranges(addc)
    order = np.lexsort((part_rep, levels))
    return part_rep[order].astype(np.int16)


class _TraceRecorder:
    """Per-iteration convergence trace -> dict of stacked arrays."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.remaining: list[int] = []
        self.edge_counts: list[np.ndarray] = []
        self.vertex_counts: list[np.ndarray] = []
        self.lam: list[np.ndarray] = []

    def record(self, remaining, nE, nV, lam) -> None:
        if not self.enabled:
            return
        self.remaining.append(int(remaining))
        self.edge_counts.append(nE.copy())
        self.vertex_counts.append(nV.copy())
        self.lam.append(lam.copy())

    def build(self, P: int) -> dict | None:
        if not self.enabled:
            return None
        if not self.remaining:
            z = np.zeros((0, P), dtype=np.int64)
            return {
                "remaining": np.zeros(0, dtype=np.int64),
                "edge_counts": z,
                "vertex_counts": z,
                "lam": np.zeros((0, P), dtype=np.float64),
            }
        return {
            "remaining": np.asarray(self.remaining, dtype=np.int64),
            "edge_counts": np.stack(self.edge_counts),
            "vertex_counts": np.stack(self.vertex_counts),
            "lam": np.stack(self.lam),
        }


# ---------------------------------------------------------------------------
# the partitioner
# ---------------------------------------------------------------------------


class NeighborExpansionPartitioner(PartitionerBase):
    """DistributedNE / AdaDNE behind the ``Partitioner`` protocol.

    ``cfg`` supplies the algorithm knobs; ``partition(g, num_parts,
    seed=...)`` overrides the legacy ``cfg.num_parts``/``cfg.seed`` defaults
    per call and returns a scored :class:`PartitionPlan` (the raw edge
    assignment lives in ``plan.edge_parts``)."""

    def __init__(self, cfg: NEConfig | None = None, **overrides):
        if cfg is None:
            cfg = NEConfig(**overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if cfg.mode not in NE_MODES:
            raise ValueError(f"mode must be one of {NE_MODES}, got {cfg.mode!r}")
        if cfg.num_parts > 64:
            raise ValueError("bitmask implementation supports up to 64 partitions")
        self.cfg = cfg

    @property
    def name(self) -> str:
        base = "adadne" if self.cfg.adaptive else "dne"
        return base + ("_loop" if self.cfg.mode == "loop" else "")

    @property
    def cache_token(self) -> str:
        c = self.cfg
        return (
            f"{self.name}:lam0={c.lam0}:tau={c.tau}:alpha={c.alpha}"
            f":beta={c.beta}:budget={c.budget_frac}:iters={c.max_iters}"
        )

    # ------------------------------------------------------------------
    def partition(
        self,
        g: HeteroGraph,
        num_parts: int | None = None,
        *,
        seed: int | None = None,
        direction: str = DEFAULT_DIRECTION,
    ) -> PartitionPlan:
        cfg = self.cfg
        P = int(num_parts) if num_parts is not None else int(cfg.num_parts)
        if P <= 0:
            raise ValueError(f"num_parts must be positive, got {P}")
        if P > 64:
            raise ValueError("bitmask implementation supports up to 64 partitions")
        sd = int(cfg.seed if seed is None else seed)
        run = self._run_loop if cfg.mode == "loop" else self._run_lockstep
        edge_part, trace = run(g, P, sd)
        assert (edge_part >= 0).all()
        return PartitionPlan.from_assignment(
            g,
            edge_part,
            P,
            partitioner=self.name,
            seed=sd,
            iteration_trace=trace,
        )

    # ------------------------------------------------------------------
    # lockstep (vectorized) mode
    # ------------------------------------------------------------------
    def _run_lockstep(
        self, g: HeteroGraph, P: int, seed: int
    ) -> tuple[np.ndarray, dict | None]:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        E, N = g.num_edges, g.num_vertices
        deg = g.out_degrees() + g.in_degrees()
        inc_indptr, inc_eid = _incidence(g)
        # static selection key: rank of (degree, vertex id) — pools kept
        # sorted by it, so "smallest-degree-first" selection is a prefix cut
        vertex_of_rank = np.lexsort((np.arange(N), deg))
        rank = np.empty(N, dtype=np.int64)
        rank[vertex_of_rank] = np.arange(N)
        deg_by_rank = deg[vertex_of_rank]

        edge_part = np.full(E, -1, dtype=np.int16)
        mask = np.zeros(N, dtype=np.uint64)  # partition membership bitmask
        in_boundary = np.zeros((P, N), dtype=bool)
        # Per-partition candidate pools: sorted arrays of vertex RANKS (the
        # rank is unique, so it IS the vertex via ``vertex_of_rank``).  A
        # vertex enters a pool at most once (``in_boundary`` guard) and
        # selection always consumes a prefix, so pools never hold already-
        # expanded entries — no dense candidate matrices, no compaction.
        pools: list[np.ndarray] = [np.zeros(0, dtype=np.int64) for _ in range(P)]
        nE = np.zeros(P, dtype=np.int64)
        nV = np.zeros(P, dtype=np.int64)
        lam = np.full(P, cfg.lam0, dtype=np.float64)
        terminated = np.zeros(P, dtype=bool)
        Et = cfg.tau * E / P  # DNE hard threshold
        trace = _TraceRecorder(cfg.trace)

        seeds = rng.choice(N, size=P, replace=False)
        for p, s in enumerate(seeds):
            in_boundary[p, s] = True
            pools[p] = rank[np.array([s], dtype=np.int64)]

        remaining = E
        it = 0
        while remaining > 0 and it < cfg.max_iters:
            it += 1
            if cfg.adaptive:
                tot_v, tot_e = max(1, nV.sum()), max(1, nE.sum())
                vs = P * nV / tot_v
                es = P * nE / tot_e
                lam = lam * np.exp(cfg.alpha * (1.0 - vs) + cfg.beta * (1.0 - es))
                np.clip(lam, 1e-4, 1.0, out=lam)
            else:
                terminated = nE > Et
            active = ~terminated

            bsize = np.fromiter(
                (v.size for v in pools), dtype=np.int64, count=P
            )
            # reseed stalled active partitions from unallocated edges
            need = np.flatnonzero(active & (bsize == 0))
            if need.size:
                un = np.flatnonzero(edge_part == -1)
                if un.size:
                    picks = g.src[un[rng.integers(0, un.size, size=need.size)]]
                    for p, s in zip(need, picks):
                        if not in_boundary[p, s]:
                            in_boundary[p, s] = True
                        pools[p] = rank[np.array([s], dtype=np.int64)]
                        bsize[p] = 1
            budgets = _iteration_budgets(lam, bsize, terminated, E, cfg.budget_frac)

            # --- batched candidate selection -------------------------------
            # All partitions select against the same snapshot: partition p
            # takes the prefix of its rank-sorted pool limited by both
            # k = max(1, λ_p·|B_p|) and the budget's cumulative-degree cut
            # (identical ordering to the loop mode's stable degree argsort).
            sel_chunks: list[np.ndarray] = []
            sel_sizes: list[int] = []
            act = np.flatnonzero(active & (bsize > 0))
            for p in act:
                c = pools[p]
                k = min(c.size, max(1, int(lam[p] * c.size)))
                cap = min(k, int(budgets[p]) + 1)
                pre = c[:cap]
                cut = int(
                    np.searchsorted(
                        np.cumsum(deg_by_rank[pre]), budgets[p], side="left"
                    )
                ) + 1
                q = min(cap, cut)
                sel_chunks.append(vertex_of_rank[pre[:q]])
                sel_sizes.append(q)
                pools[p] = c[q:]
            progressed = False
            if sel_chunks:
                sv = np.concatenate(sel_chunks)
                sp = np.repeat(act, sel_sizes)

                # --- one-hop allocation with conflict resolution ----------
                lens = inc_indptr[sv + 1] - inc_indptr[sv]
                slots = np.repeat(inc_indptr[sv], lens) + _ranges(lens)
                eids = inc_eid[slots]
                owner = np.repeat(sp, lens)
                free = edge_part[eids] == -1
                eids, owner = eids[free], owner[free]
                if eids.size:
                    # per contested edge the lowest-|E_p| claimant wins,
                    # ties to the lower partition id (lexsort key order)
                    o = np.lexsort((owner, nE[owner], eids))
                    es_, os_ = eids[o], owner[o]
                    first = np.empty(es_.size, dtype=bool)
                    first[0] = True
                    first[1:] = es_[1:] != es_[:-1]
                    win_e, win_p = es_[first], os_[first]
                    edge_part[win_e] = win_p.astype(np.int16)
                    nE += np.bincount(win_p, minlength=P)
                    remaining -= win_e.size
                    progressed = True

                    # grouped membership + boundary update over unique
                    # (partition, endpoint) pairs
                    pv = np.concatenate([win_p, win_p])
                    vv = np.concatenate([g.src[win_e], g.dst[win_e]])
                    pk = np.unique(pv * np.int64(N) + vv)
                    up = pk // N
                    uv = pk % N
                    bitv = np.left_shift(np.uint64(1), up.astype(np.uint64))
                    fresh = (mask[uv] & bitv) == 0
                    nV += np.bincount(up[fresh], minlength=P)
                    # grouped OR into the membership bitmask (reduceat over
                    # vertex-sorted runs — ufunc.at is an order slower)
                    o2 = np.argsort(uv, kind="stable")
                    vs2, bs2 = uv[o2], bitv[o2]
                    heads = np.empty(vs2.size, dtype=bool)
                    heads[0] = True
                    heads[1:] = vs2[1:] != vs2[:-1]
                    starts2 = np.flatnonzero(heads)
                    mask[vs2[starts2]] |= np.bitwise_or.reduceat(bs2, starts2)
                    # vertices never seen by p before join its boundary pool
                    # (selected vertices are already in_boundary, so pools
                    # stay free of expanded entries)
                    newb = np.flatnonzero(~in_boundary[up, uv])
                    in_boundary[up[newb], uv[newb]] = True
                    # pairs are sorted by partition: one sorted-merge per pool
                    ub, starts = np.unique(up[newb], return_index=True)
                    stops = np.append(starts[1:], newb.size)
                    for j, p in enumerate(ub):
                        add_r = rank[uv[newb[starts[j] : stops[j]]]]
                        add_r.sort()
                        old = pools[p]
                        out = np.empty(old.size + add_r.size, dtype=np.int64)
                        idx = np.searchsorted(old, add_r) + np.arange(
                            add_r.size
                        )
                        out[idx] = add_r
                        keep_old = np.ones(out.size, dtype=bool)
                        keep_old[idx] = False
                        out[keep_old] = old
                        pools[p] = out

                    # --- two-hop allocation -------------------------------
                    # a free edge can only gain a common partition when an
                    # endpoint's membership CHANGED this round, and that
                    # endpoint is then in uv[fresh] — scanning only those is
                    # exhaustive and skips the re-gather of hub neighbor
                    # lists every round
                    touched = np.unique(uv[fresh])
                    te = inc_eid[_gather_slots(inc_indptr, touched)]
                    te = te[edge_part[te] == -1]
                    if te.size:
                        te = np.unique(te)
                    if te.size:
                        common = mask[g.src[te]] & mask[g.dst[te]]
                        has = common != 0
                        te, common = te[has], common[has]
                        if te.size:
                            bits = (
                                (common[:, None] >> np.arange(P, dtype=np.uint64))
                                & np.uint64(1)
                            ).astype(bool)
                            score = np.where(
                                bits, nE[None, :], np.iinfo(np.int64).max
                            )
                            pick = np.argmin(score, axis=1)
                            edge_part[te] = pick.astype(np.int16)
                            nE += np.bincount(pick, minlength=P)
                            remaining -= te.size

            if cfg.verbose:
                print(
                    f"it={it} rem={remaining} nE={nE.tolist()} nV={nV.tolist()} "
                    f"lam={np.round(lam, 4).tolist()}"
                )
            trace.record(remaining, nE, nV, lam)
            if not progressed:
                remaining = self._flush(edge_part, nE)
        if remaining > 0:  # max_iters exhausted
            self._flush(edge_part, nE)
        return edge_part, trace.build(P)

    # ------------------------------------------------------------------
    # sequential (legacy reference) mode
    # ------------------------------------------------------------------
    def _run_loop(
        self, g: HeteroGraph, P: int, seed: int
    ) -> tuple[np.ndarray, dict | None]:
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        E, N = g.num_edges, g.num_vertices
        deg = g.out_degrees() + g.in_degrees()
        inc_indptr, inc_eid = _incidence(g)
        edge_part = np.full(E, -1, dtype=np.int16)
        mask = np.zeros(N, dtype=np.uint64)
        boundary = np.zeros((P, N), dtype=bool)
        expanded = np.zeros((P, N), dtype=bool)
        nE = np.zeros(P, dtype=np.int64)
        nV = np.zeros(P, dtype=np.int64)
        lam = np.full(P, cfg.lam0, dtype=np.float64)
        terminated = np.zeros(P, dtype=bool)
        Et = cfg.tau * E / P
        trace = _TraceRecorder(cfg.trace)

        seeds = rng.choice(N, size=P, replace=False)
        for p, s in enumerate(seeds):
            boundary[p, s] = True

        remaining = E
        it = 0
        while remaining > 0 and it < cfg.max_iters:
            it += 1
            if cfg.adaptive:
                tot_v, tot_e = max(1, nV.sum()), max(1, nE.sum())
                vs = P * nV / tot_v
                es = P * nE / tot_e
                lam = lam * np.exp(cfg.alpha * (1.0 - vs) + cfg.beta * (1.0 - es))
                np.clip(lam, 1e-4, 1.0, out=lam)
            else:
                terminated = nE > Et

            progressed = False
            newly_touched: list[np.ndarray] = []
            bsize = np.array(
                [
                    np.count_nonzero(boundary[p] & ~expanded[p])
                    for p in range(P)
                ],
                dtype=np.int64,
            )
            budgets = _iteration_budgets(lam, bsize, terminated, E, cfg.budget_frac)
            for p in range(P):
                if terminated[p]:
                    continue
                cand = np.flatnonzero(boundary[p] & ~expanded[p])
                if cand.shape[0] == 0:
                    # reseed from an unallocated edge
                    un = np.flatnonzero(edge_part == -1)
                    if un.shape[0] == 0:
                        continue
                    s = g.src[un[rng.integers(0, un.shape[0])]]
                    boundary[p, s] = True
                    cand = np.array([s])
                k = max(1, int(lam[p] * cand.shape[0]))
                k = min(k, cand.shape[0])
                # smallest-degree-first selection (DNE heuristic)
                sel = cand[np.argsort(deg[cand], kind="stable")[:k]]
                # iteration-granularity edge budget: cut the selection prefix
                # whose incident-degree sum fits the budget
                budget = int(budgets[p])
                cum = np.cumsum(deg[sel])
                cut = int(np.searchsorted(cum, budget, side="left")) + 1
                sel = sel[:cut]
                expanded[p, sel] = True

                # one-hop allocation: unallocated incident edges of sel -> p
                slots = _gather_slots(inc_indptr, sel)
                eids = inc_eid[slots]
                un = eids[edge_part[eids] == -1]
                if un.shape[0]:
                    un = np.unique(un)
                    edge_part[un] = p
                    nE[p] += un.shape[0]
                    remaining -= un.shape[0]
                    progressed = True
                    ends = np.concatenate([g.src[un], g.dst[un]])
                    ends = np.unique(ends)
                    bit = np.uint64(1 << p)
                    fresh = (mask[ends] & bit) == 0
                    nV[p] += int(fresh.sum())
                    mask[ends] |= bit
                    newb = ends[~expanded[p, ends]]
                    boundary[p, newb] = True
                    newly_touched.append(ends)

            # two-hop allocation: unallocated edges whose endpoints share a
            # partition go to the common partition with fewest edges
            if newly_touched:
                touched = np.unique(np.concatenate(newly_touched))
                slots = _gather_slots(inc_indptr, touched)
                eids = np.unique(inc_eid[slots])
                eids = eids[edge_part[eids] == -1]
                if eids.shape[0]:
                    common = mask[g.src[eids]] & mask[g.dst[eids]]
                    has = common != 0
                    eids, common = eids[has], common[has]
                    if eids.shape[0]:
                        # greedy by ascending |E_p| ≈ argmin over common set
                        done = np.zeros(eids.shape[0], dtype=bool)
                        for p in np.argsort(nE):
                            bit = np.uint64(1 << int(p))
                            hit = (~done) & ((common & bit) != 0)
                            cnt = int(hit.sum())
                            if cnt == 0:
                                continue
                            sel_e = eids[hit]
                            edge_part[sel_e] = p
                            nE[p] += cnt
                            remaining -= cnt
                            done |= hit
                            progressed = True
                        # endpoints already members; no new vertices

            if cfg.verbose:
                print(
                    f"it={it} rem={remaining} nE={nE.tolist()} nV={nV.tolist()} "
                    f"lam={np.round(lam, 4).tolist()}"
                )
            trace.record(remaining, nE, nV, lam)
            if not progressed:
                remaining = self._flush(edge_part, nE)
        if remaining > 0:
            self._flush(edge_part, nE)
        return edge_part, trace.build(P)

    # ------------------------------------------------------------------
    @staticmethod
    def _flush(edge_part: np.ndarray, nE: np.ndarray) -> int:
        """Stall flush: spread every unallocated edge greedily onto the
        least-loaded partition — the closed-form :func:`_flush_sequence`
        replaces the old O(E·P) per-edge argmin loop bit-identically.
        Returns the new ``remaining`` count (always 0)."""
        un = np.flatnonzero(edge_part == -1)
        if un.shape[0]:
            seq = _flush_sequence(nE, un.shape[0])
            edge_part[un] = seq
            nE += np.bincount(seq, minlength=nE.shape[0])
        return 0


# ---------------------------------------------------------------------------
# legacy free-function shims (kept one release of deprecation; they return
# the RAW edge assignment — new call sites should use the registry entries,
# which return a scored ``PartitionPlan``)
# ---------------------------------------------------------------------------


def distributed_ne(
    g: HeteroGraph,
    num_parts: int,
    tau: float = 1.1,
    lam: float = 0.1,
    seed: int = 0,
    mode: str = "lockstep",
) -> np.ndarray:
    """DEPRECATED: ``PARTITIONERS.get("dne").partition(...).edge_parts``."""
    return NeighborExpansionPartitioner(
        NEConfig(adaptive=False, tau=tau, lam0=lam, mode=mode)
    ).partition(g, num_parts, seed=seed).edge_parts


def adadne(
    g: HeteroGraph,
    num_parts: int,
    lam: float = 0.1,
    alpha: float = 1.0,
    beta: float = 1.0,
    seed: int = 0,
    mode: str = "lockstep",
) -> np.ndarray:
    """DEPRECATED: ``PARTITIONERS.get("adadne").partition(...).edge_parts``."""
    return NeighborExpansionPartitioner(
        NEConfig(adaptive=True, lam0=lam, alpha=alpha, beta=beta, mode=mode)
    ).partition(g, num_parts, seed=seed).edge_parts
