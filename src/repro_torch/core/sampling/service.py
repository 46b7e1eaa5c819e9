"""Gather-Apply distributed K-hop neighbor sampling (paper §III-C, Alg. 1-4).

The P logical sampling servers (one per vertex-cut partition) are simulated
in-process.  One-hop requests are routed to servers by a *routing strategy*,
partial samples are gathered and (for the vertex-cut layout) merged:

  uniform  — server p draws r = f · local_deg/global_deg edges via Algorithm D
             (UniformGatherOp, Alg. 2); Apply joins and trims to f.
  weighted — server p computes A-ES scores u^{1/w} for its local neighbors and
             returns its top-f with scores (WeightedGatherOp, Alg. 3); Apply
             takes the global top-f by score (WeightedApplyOp, Alg. 4).

Two routing strategies cover the paper's system and the baseline:

``GatherApplyRouting`` — GLISP: every server hosting the seed (the vertex-cut
    property) answers with its local portion; the client-side Apply merges.
``OwnerRouting`` — the DistDGL-style baseline: one-hop requests are answered
    ONLY by the seed's owner (halo edges make the full neighborhood local);
    no cross-server merge — the hotspot's entire neighborhood burdens a
    single server, precisely the imbalance GLISP removes.

Per-server workload counters model the paper's Fig.-10 measurement: work is
dominated by edges touched (weighted scans all local neighbor weights; uniform
is O(k) thanks to Algorithm D) plus a per-seed request overhead.

Two consumption surfaces share the same servers, routing, and hop executor:

``SamplingService`` (preferred) — the asynchronous request-plan API.  Clients
    ``submit(SampleRequest) -> SampleTicket`` and read ``ticket.result()``;
    the service advances every in-flight request one hop per scheduling
    round, so concurrent requests overlap hop levels (request k's hop-2 runs
    beside request k+1's hop-1), duplicate frontier seeds across in-flight
    requests are coalesced into one dispatch, and oversized per-server
    batches are split.  Randomness is keyed per ``(service seed, request
    key, hop, server, chunk)``, so a request's result is bit-identical
    regardless of prefetch depth, submission interleaving, or how many
    concurrent clients share the service.

``GatherApplyClient`` / ``EdgeCutClient`` (legacy, blocking) — thin
    synchronous wrappers over the same routing strategies + hop executor,
    drawing from shared per-server RNG streams (results depend on call
    order).  Kept for raw single-consumer use; new code should go through
    ``SamplingService``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch import tracing
from repro_torch.core.faults import CircuitBreaker, InjectedFault, RetryPolicy, as_injector
from repro_torch.graph.graph import GraphPartition, HeteroGraph

__all__ = [
    "DEFAULT_DIRECTION",
    "MAX_PARTS",
    "VertexRouter",
    "SamplingServer",
    "ServerStats",
    "SamplingSpec",
    "SampleRequest",
    "SampleTicket",
    "SampleTimeout",
    "SamplingService",
    "ServiceStats",
    "request_rng",
    "GatherApplyRouting",
    "OwnerRouting",
    "GatherApplyClient",
    "EdgeCutClient",
    "SampledHop",
    "SampledSubgraph",
]

# One shared default for every sampler surface (clients, trainer, inference
# engine).  GLISP samples along OUT edges; baselines must use the same
# direction or comparisons silently skew.
DEFAULT_DIRECTION = "out"

# The router packs hosting sets into a uint64 bitmask; more partitions than
# bits silently alias (1 << p wraps), corrupting routing.
MAX_PARTS = 64

_KEY_MASK = (1 << 64) - 1
# domain-separation tags for the per-request RNG streams (gather draws vs
# the client-side Apply trim) so the two never alias
_GATHER_TAG = 0x6A7

_TRIM_TAG = 0x7213


def request_rng(seed: int, key: tuple, hop: int, *tail: int) -> np.random.Generator:
    """The deterministic RNG stream for ``(service seed, request key, hop,
    *tail)`` — length-prefixed entropy, so keys of different lengths never
    alias.  Module-level rather than a service method because remote
    sampling workers (``repro.dist.worker``) must re-derive the very same
    streams from wire-carried key material; this function is the single
    definition both deployments share."""
    seq = np.random.SeedSequence(
        (int(seed) & _KEY_MASK, len(key), *key, hop, *tail)
    )
    return np.random.default_rng(seq)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


class VertexRouter:
    """Vertex -> set of partitions (bitmask), built from the edge assignment."""

    def __init__(self, g: HeteroGraph, edge_parts: np.ndarray, num_parts: int):
        if num_parts > MAX_PARTS:
            raise ValueError(
                f"VertexRouter supports at most {MAX_PARTS} partitions "
                f"(uint64 hosting bitmask), got num_parts={num_parts}"
            )
        mask = np.zeros(g.num_vertices, dtype=np.uint64)
        for p in range(num_parts):
            sel = edge_parts == p
            bit = np.uint64(1 << p)
            verts = np.union1d(g.src[sel], g.dst[sel])
            mask[verts] |= bit
        self.mask = mask
        self.num_parts = num_parts

    def servers_of(self, gids: np.ndarray) -> list[np.ndarray]:
        """For each partition p, the subset of ``gids`` hosted on p."""
        out = []
        for p in range(self.num_parts):
            bit = np.uint64(1 << p)
            out.append(gids[(self.mask[gids] & bit) != 0])
        return out


class GatherApplyRouting:
    """GLISP routing: every server hosting a seed answers; Apply merges."""

    merge = True

    def __init__(self, router: VertexRouter):
        self.router = router

    def route(self, frontier: np.ndarray) -> list[np.ndarray]:
        return self.router.servers_of(frontier)


class OwnerRouting:
    """DistDGL-style routing: only the seed's owner answers; no merge (the
    owner's halo holds the FULL one-hop, so local_deg == global_deg)."""

    merge = False

    def __init__(self, owner: np.ndarray, num_parts: int):
        self.owner = owner
        self.num_parts = num_parts

    def route(self, frontier: np.ndarray) -> list[np.ndarray]:
        owners = self.owner[frontier]
        return [frontier[owners == p] for p in range(self.num_parts)]


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


@dataclass
class ServerStats:
    requests: int = 0
    seeds: int = 0
    work_units: float = 0.0  # modeled work: edges scanned + samples drawn
    edges_returned: int = 0
    bytes_out: int = 0
    # fault-tolerance counters: extra gather attempts after an injected
    # failure, dispatches served by a non-primary replica, and dispatches
    # lost entirely (every replica exhausted -> degraded partial fanout)
    retries: int = 0
    failovers: int = 0
    degraded: int = 0

    def merge(self, other: "ServerStats") -> None:
        self.requests += other.requests
        self.seeds += other.seeds
        self.work_units += other.work_units
        self.edges_returned += other.edges_returned
        self.bytes_out += other.bytes_out
        self.retries += other.retries
        self.failovers += other.failovers
        self.degraded += other.degraded


@dataclass
class ServiceStats(ServerStats):
    """``SamplingService.stats()``: the merged per-server counters plus the
    service-level work accounting, with the *modeled* numbers explicitly
    named as such so benchmarks can no longer conflate them with the
    *measured* wall-clock per-round time reported alongside."""

    # the Fig.-10 work model (edges touched + per-seed overhead), NOT a
    # measurement: per-round MAX across servers / per-round SUM
    modeled_parallel_work: float = 0.0
    modeled_total_work: float = 0.0
    # measured: scheduling rounds driven and their wall-clock total (the
    # service's ``sampling.round`` spans)
    rounds: int = 0
    measured_round_seconds: float = 0.0

    @property
    def parallel_work(self) -> float:
        """DEPRECATED alias for :attr:`modeled_parallel_work`."""
        return self.modeled_parallel_work

    @property
    def total_work(self) -> float:
        """DEPRECATED alias for :attr:`modeled_total_work`."""
        return self.modeled_total_work


class SamplingServer:
    def __init__(
        self,
        part: GraphPartition,
        seed: int = 0,
        cost_model: str = "algd",
        *,
        replica_id: int = 0,
        faults=None,
    ):
        """cost_model:
        "algd" — GLISP: Vitter's Algorithm D, O(k) work per uniform request
                 (the paper's design);
        "scan" — baseline systems whose uniform neighbor sampling walks the
                 local adjacency slice, O(local_deg) per request (DGL-style
                 permutation/reservoir implementations).

        ``replica_id`` distinguishes replica servers of the same partition
        (the service's failover targets); ``faults`` is an optional
        ``FaultInjector`` fired at the top of every gather, BEFORE any RNG
        consumption or stats accounting, so a failed attempt leaves no
        trace in the sample stream and a retry redraws bit-identically."""
        self.part = part
        self.rng = np.random.default_rng(seed * 7919 + part.part_id)
        self.stats = ServerStats()
        self.cost_model = cost_model
        self.replica_id = replica_id
        self.faults = faults
        self.breaker = CircuitBreaker()
        self.site = f"server.{part.part_id}.{replica_id}"

    @property
    def health(self) -> str:
        """"up" or "quarantined" (circuit breaker open)."""
        return "quarantined" if self.breaker.state == "open" else "up"

    def _maybe_fail(self) -> None:
        if self.faults is not None:
            self.faults.fire(self.site)

    # -- helpers -----------------------------------------------------------
    def _slices(self, lids: np.ndarray, direction: str):
        p = self.part
        if direction == "out":
            indptr, nbr = p.out_indptr, p.out_dst
            eid_of_slot = None  # slot index IS the edge local id
        else:
            indptr, nbr = p.in_indptr, p.in_src
            eid_of_slot = p.in_edge_id
        starts, ends = indptr[lids], indptr[lids + 1]
        return starts, ends, nbr, eid_of_slot

    def _global_degree(self, lids: np.ndarray, direction: str) -> np.ndarray:
        return (
            self.part.out_degrees[lids]
            if direction == "out"
            else self.part.in_degrees[lids]
        )

    @staticmethod
    def _flatten_slices(starts: np.ndarray, lens: np.ndarray):
        """(slots, seg): concatenated ``arange(starts[i], starts[i]+lens[i])``
        plus the owning seed index per slot — one vectorized pass, no Python
        loop (the sampling hot path runs on the prefetch thread and must not
        hog the GIL)."""
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cum = np.cumsum(lens) - lens
        ranges = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
        slots = np.repeat(starts, lens) + ranges
        seg = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
        return slots, seg

    def _eid_global(self, eids_local: np.ndarray) -> np.ndarray:
        """Local edge ids -> global edge ids (identity if the partition was
        built before ``edge_global_id`` existed)."""
        eg = self.part.edge_global_id
        return eids_local if eg is None else eg[eids_local].astype(np.int64)

    # -- UniformGatherOp (Alg. 2) -------------------------------------------
    def uniform_gather(
        self,
        seeds_gid: np.ndarray,
        fanout: int,
        direction: str = DEFAULT_DIRECTION,
        *,
        rng: np.random.Generator | None = None,
        replace: bool = False,
    ):
        """``rng=None`` draws from the server's shared stream (legacy blocking
        clients); the service passes a per-request stream so results are
        independent of request interleaving.  ``replace=True`` draws each of
        the r slots independently (with replacement)."""
        self._maybe_fail()
        rng = self.rng if rng is None else rng
        p = self.part
        lids = p.global_to_local(seeds_gid)
        ok = lids >= 0
        seeds_gid, lids = seeds_gid[ok], lids[ok]
        if seeds_gid.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int64),)
        starts, ends, nbr, eid_of_slot = self._slices(lids, direction)
        local_deg = (ends - starts).astype(np.int64)
        global_deg = np.maximum(1, self._global_degree(lids, direction))
        r = fanout * local_deg / global_deg
        k = np.floor(r).astype(np.int64)
        k += rng.random(k.shape[0]) < (r - k)  # randomized rounding
        if replace:
            k = np.where(local_deg > 0, k, 0)
        else:
            k = np.minimum(k, local_deg)

        self.stats.requests += 1
        self.stats.seeds += int(seeds_gid.shape[0])
        if self.cost_model == "algd":
            # Algorithm D: O(k) work per seed + request handling overhead
            self.stats.work_units += float(k.sum()) + seeds_gid.shape[0]
        else:
            # adjacency-slice walk: O(local_deg) per seed
            self.stats.work_units += float(local_deg.sum()) + seeds_gid.shape[0]

        sel = k > 0
        if not sel.any():
            return (np.zeros(0, np.int64),) * 3
        if replace:
            # each slot an independent uniform draw over the local neighbors
            ksel = k[sel]
            seg_k = np.repeat(np.arange(ksel.shape[0], dtype=np.int64), ksel)
            ld = local_deg[sel][seg_k]
            offs = np.minimum(
                (rng.random(seg_k.shape[0]) * ld).astype(np.int64), ld - 1
            )
            slots_k = starts[sel][seg_k] + offs
        else:
            # vectorized k-of-n per seed: draw one uniform key per local edge
            # slot, keep each seed's k smallest — distribution-identical to
            # Algorithm D (uniform without replacement); the *cost model*
            # above still charges O(k) per the paper's design
            slots, seg = self._flatten_slices(starts[sel], local_deg[sel])
            u = rng.random(slots.shape[0])
            order = np.lexsort((u, seg))
            seg_s, slots_s = seg[order], slots[order]
            keep = _group_rank(seg_s) < k[sel][seg_s]
            seg_k, slots_k = seg_s[keep], slots_s[keep]
        s = seeds_gid[sel][seg_k]
        n = p.local_to_global(nbr[slots_k])
        e = self._eid_global(
            slots_k if eid_of_slot is None else eid_of_slot[slots_k]
        )
        self.stats.edges_returned += s.shape[0]
        self.stats.bytes_out += s.nbytes + n.nbytes
        return s, n, e

    # -- WeightedGatherOp (Alg. 3) -------------------------------------------
    def weighted_gather(
        self,
        seeds_gid: np.ndarray,
        fanout: int,
        direction: str = DEFAULT_DIRECTION,
        *,
        rng: np.random.Generator | None = None,
    ):
        self._maybe_fail()
        rng = self.rng if rng is None else rng
        p = self.part
        assert p.edge_weights is not None, "graph has no edge weights"
        lids = p.global_to_local(seeds_gid)
        ok = lids >= 0
        seeds_gid, lids = seeds_gid[ok], lids[ok]
        if seeds_gid.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 2 + (
                np.zeros(0, np.float64),
                np.zeros(0, np.int64),
            )
        starts, ends, nbr, eid_of_slot = self._slices(lids, direction)
        local_deg = (ends - starts).astype(np.int64)

        self.stats.requests += 1
        self.stats.seeds += int(seeds_gid.shape[0])
        # A-ES scans every local neighbor weight: O(local_deg) per seed
        self.stats.work_units += float(local_deg.sum()) + seeds_gid.shape[0]

        # vectorized A-ES (Efraimidis–Spirakis): score u^{1/w} per local
        # edge, per-seed top-f by score — one lexsort over the flattened
        # neighbor slices instead of a Python loop per seed
        slots, seg = self._flatten_slices(starts, local_deg)
        if slots.shape[0] == 0:
            return (np.zeros(0, np.int64),) * 2 + (
                np.zeros(0, np.float64),
                np.zeros(0, np.int64),
            )
        eids = slots if eid_of_slot is None else eid_of_slot[slots]
        w = p.edge_weights[eids].astype(np.float64)
        u = rng.random(slots.shape[0])
        with np.errstate(divide="ignore", invalid="ignore"):
            scores = np.where(w > 0, u ** (1.0 / np.maximum(w, 1e-300)), 0.0)
        order = np.lexsort((-scores, seg))
        seg_s = seg[order]
        # P(select) ∝ weight: zero/negative-weight edges are never returned,
        # even when a seed has fewer than `fanout` positive-weight neighbors
        keep = (_group_rank(seg_s) < fanout) & (scores[order] > 0)
        kept = order[keep]
        seg_k = seg[kept]
        s = seeds_gid[seg_k]
        n = p.local_to_global(nbr[slots[kept]])
        sc = scores[kept]
        e = self._eid_global(eids[kept])
        self.stats.edges_returned += s.shape[0]
        self.stats.bytes_out += s.nbytes + n.nbytes + sc.nbytes
        return s, n, sc, e


# ---------------------------------------------------------------------------
# Sampled output
# ---------------------------------------------------------------------------


@dataclass
class SampledHop:
    src: np.ndarray  # seed gids, repeated per sampled edge
    dst: np.ndarray  # sampled neighbor gids
    # global edge id per sampled edge (None for partitions built before
    # edge_global_id existed); lets consumers read edge types/weights directly
    eid: np.ndarray | None = None


@dataclass
class SampledSubgraph:
    seeds: np.ndarray
    hops: list[SampledHop] = field(default_factory=list)
    # True when at least one dispatch was lost to failures (every replica
    # exhausted or quarantined): the sample is a partial fanout.  Degraded
    # results are flagged, never silent — consumers decide whether partial
    # neighborhoods are acceptable (training often tolerates them; a
    # determinism-sensitive consumer must drop or resample them).
    degraded: bool = False
    lost_dispatches: int = 0

    def all_vertices(self) -> np.ndarray:
        arrs = [self.seeds] + [h.src for h in self.hops] + [h.dst for h in self.hops]
        return np.unique(np.concatenate(arrs))

    @property
    def num_edges(self) -> int:
        return sum(h.src.shape[0] for h in self.hops)


# ---------------------------------------------------------------------------
# Request plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamplingSpec:
    """A validated, typed description of one K-hop sampling plan — replaces
    the ``fanouts/weighted/direction`` kwarg forest on every surface."""

    fanouts: tuple = (10, 5)
    weighted: bool = False  # A-ES weighted sampling instead of uniform
    direction: str = DEFAULT_DIRECTION
    # with-replacement uniform draws (each slot independent); weighted A-ES
    # is inherently without replacement
    replace: bool = False

    def validate(self) -> "SamplingSpec":
        if not self.fanouts or any(f <= 0 for f in self.fanouts):
            raise ValueError(f"fanouts must be positive, got {self.fanouts!r}")
        if self.direction not in ("out", "in"):
            raise ValueError(
                f"direction must be 'out' or 'in', got {self.direction!r}"
            )
        if self.weighted and self.replace:
            raise ValueError(
                "replace=True is uniform-only: weighted A-ES sampling is "
                "inherently without replacement"
            )
        return self


@dataclass(frozen=True)
class SampleRequest:
    """One K-hop request: seeds + plan + the RNG stream key.

    ``key`` (a tuple of ints) names the request's deterministic random
    stream: the result is a pure function of ``(service seed, key, seeds,
    spec)``.  Two requests MAY share a key — e.g. identically-seeded loaders
    on a shared service reuse the same key sequence and therefore reproduce
    the exact streams they would see on private services."""

    seeds: np.ndarray
    spec: SamplingSpec
    key: tuple = (0,)


def _norm_key(key) -> tuple:
    if isinstance(key, (int, np.integer)):
        key = (int(key),)
    if isinstance(key, (str, bytes)):
        raise TypeError(
            f"request key must be an int or a tuple of ints, got {key!r}"
        )
    try:
        out = tuple(int(k) & _KEY_MASK for k in key)
    except (TypeError, ValueError):
        raise TypeError(
            f"request key must be an int or a tuple of ints, got {key!r}"
        ) from None
    if not out:
        raise ValueError("request key must not be empty")
    return out


class _RequestState:
    __slots__ = ("request", "result", "frontier", "hop", "done", "cancelled")

    def __init__(self, request: SampleRequest):
        self.request = request
        self.result = SampledSubgraph(seeds=request.seeds)
        self.frontier = request.seeds
        self.hop = 0
        self.done = False
        self.cancelled = False


class SampleTimeout(TimeoutError):
    """``SampleTicket.result(timeout=)`` deadline expired before completion."""


class SampleTicket:
    """Future-like handle for a submitted request.  ``result()`` drives the
    service's cooperative scheduler until this request completes — every
    other in-flight request advances alongside it, one hop per round."""

    def __init__(self, service: "SamplingService", state: _RequestState):
        self._service = service
        self._state = state

    @property
    def request(self) -> SampleRequest:
        return self._state.request

    def done(self) -> bool:
        return self._state.done

    def cancel(self) -> None:
        """Withdraw an unfinished request so abandoned tickets stop
        consuming scheduler rounds and skewing workload counters."""
        self._service._cancel(self._state)

    def result(self, timeout: float | None = None) -> SampledSubgraph:
        """Drive rounds until done; raise :class:`SampleTimeout` past the
        deadline.  ``timeout=None`` falls back to the service's
        ``ticket_timeout`` (itself ``None`` = wait forever, an explicit
        opt-in).  The deadline is checked between rounds: a round's numpy
        work is not interruptible, so expiry is detected at the next
        round boundary — the ticket stays in flight and a later
        ``result()`` call may still complete it."""
        if timeout is None:
            timeout = self._service.ticket_timeout
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        if self._state.cancelled:
            raise RuntimeError("sample request was cancelled")
        while not self._state.done:
            if deadline is not None and time.monotonic() >= deadline:
                raise SampleTimeout(
                    f"sample request key={self._state.request.key} not "
                    f"complete within {timeout}s "
                    f"({self._service.inflight()} requests in flight)"
                )
            # pass the deadline down so contended rounds wait on the
            # scheduler lock only until expiry, not indefinitely — a 10 ms
            # timeout must come back in ~10 ms even when another thread
            # holds the service mid-round
            self._service._advance_round(deadline=deadline)
        if self._state.cancelled:
            raise RuntimeError("sample request was cancelled")
        return self._state.result


# ---------------------------------------------------------------------------
# Shared hop executor
# ---------------------------------------------------------------------------


def _group_rank(seed_arr: np.ndarray) -> np.ndarray:
    """Rank of each element within its (sorted, contiguous) seed group."""
    change = np.empty(seed_arr.shape[0], dtype=bool)
    change[0] = True
    change[1:] = seed_arr[1:] != seed_arr[:-1]
    group_start = np.maximum.accumulate(
        np.where(change, np.arange(seed_arr.shape[0]), 0)
    )
    return np.arange(seed_arr.shape[0]) - group_start


def _trim_uniform(
    seed_arr: np.ndarray,
    nbr_arr: np.ndarray,
    eid_arr: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
):
    """UniformApplyOp: join per-server results; trim any seed's surplus
    (randomized rounding can overshoot f by a draw or two) uniformly."""
    if seed_arr.shape[0] == 0:
        return seed_arr, nbr_arr, eid_arr
    # random permutation then stable-sort by seed => random order within seed
    perm = rng.permutation(seed_arr.shape[0])
    order = perm[np.argsort(seed_arr[perm], kind="stable")]
    seed_arr, nbr_arr, eid_arr = seed_arr[order], nbr_arr[order], eid_arr[order]
    keep = _group_rank(seed_arr) < fanout
    return seed_arr[keep], nbr_arr[keep], eid_arr[keep]


def _topk_by_score(
    seed_arr: np.ndarray,
    nbr_arr: np.ndarray,
    eid_arr: np.ndarray,
    score_arr: np.ndarray,
    fanout: int,
):
    """WeightedApplyOp: global top-f per seed by A-ES score (Alg. 4)."""
    if seed_arr.shape[0] == 0:
        return seed_arr, nbr_arr, eid_arr
    order = np.lexsort((-score_arr, seed_arr))
    seed_arr, nbr_arr, eid_arr = seed_arr[order], nbr_arr[order], eid_arr[order]
    keep = _group_rank(seed_arr) < fanout
    return seed_arr[keep], nbr_arr[keep], eid_arr[keep]


def _chunked(arr: np.ndarray, max_batch: int) -> list[np.ndarray]:
    """Split one per-server seed batch into dispatch-sized chunks.  Chunks
    partition the (unique) batch, so per-seed semantics are untouched."""
    n = arr.shape[0]
    if n == 0:
        return []
    if max_batch <= 0 or n <= max_batch:
        return [arr]
    return [arr[i : i + max_batch] for i in range(0, n, max_batch)]


def _gather_once(
    srv: SamplingServer,
    chunk: np.ndarray,
    fanout: int,
    direction: str,
    *,
    weighted: bool,
    replace: bool,
    rng: np.random.Generator | None,
):
    """One raw gather attempt against one server.  Shared by the direct
    executor path and the service's fault-tolerant dispatcher: any server
    hosting the same partition, given the same ``rng`` key material,
    returns the bit-identical draw — which is what makes retry and
    replica failover invisible in the sample stream."""
    if weighted:
        return srv.weighted_gather(chunk, fanout, direction, rng=rng)
    return srv.uniform_gather(chunk, fanout, direction, rng=rng, replace=replace)


def execute_hop(
    servers: list[SamplingServer],
    routed: list[np.ndarray],
    fanout: int,
    *,
    weighted: bool = False,
    replace: bool = False,
    direction: str = DEFAULT_DIRECTION,
    merge: bool = True,
    trim_rng: np.random.Generator | None = None,
    rng_for=None,
    max_server_batch: int = 0,
    on_dispatch=None,
    dispatch=None,
    submit_dispatch=None,
    collect_dispatch=None,
):
    """One hop for one request: per-server (chunked) gathers + optional Apply.

    The ONE gather/merge loop shared by the blocking clients and the async
    service.  ``merge=True`` is the Gather-Apply path (vertex-cut: join all
    hosts' partials, trim/top-f globally); ``merge=False`` is the owner-routed
    path, where each server's answer is already complete — weighted results
    get the per-server top-f (identical to the global top-f, since every
    neighbor is local to one server) and uniform results need no trim
    (local_deg == global_deg makes randomized rounding exact).

    ``rng_for(part_id, chunk_idx)`` supplies per-dispatch RNG streams (the
    service's per-request keying); ``None`` uses each server's shared stream.
    ``dispatch(part_id, chunk_idx, chunk)`` overrides the gather itself
    (the service's fault-tolerant retry/failover path); it returns
    ``(serving_server, raw_gather)`` or ``None`` for a lost dispatch,
    which marks the hop degraded.  ``on_dispatch(part_id, chunk, server)``
    observes every SERVED chunk (the coalescing accountant) — lost
    dispatches are not observed, so rebates never touch uncharged stats.
    ``submit_dispatch(part_id, chunk_idx, chunk) -> handle`` +
    ``collect_dispatch(handle)`` split the dispatch into two phases (the
    remote worker-pool path): every chunk is submitted before any answer
    is collected, so real worker processes overlap, and answers are
    collected in submission order — the merge sees chunks in exactly the
    sequence the single-phase loop would have produced, which is what
    keeps remote mode bit-identical to in-process mode.

    Returns ``(src, nbr, eid, lost)`` where ``lost`` counts dispatches
    that produced no answer.
    """
    jobs = [
        (p, ci, chunk, srv)
        for p, (srv, sub) in enumerate(zip(servers, routed))
        for ci, chunk in enumerate(_chunked(sub, max_server_batch))
    ]
    handles = (
        [submit_dispatch(p, ci, chunk) for p, ci, chunk, _ in jobs]
        if submit_dispatch is not None
        else None
    )
    parts_s, parts_n, parts_x, parts_e = [], [], [], []
    lost = 0
    for j, (p, ci, chunk, srv) in enumerate(jobs):
        with tracing.span("sampling.gather"):  # one server's part of the hop
            if handles is not None:
                served = collect_dispatch(handles[j])
            elif dispatch is not None:
                served = dispatch(p, ci, chunk)
            else:
                rng = rng_for(p, ci) if rng_for is not None else None
                served = srv, _gather_once(
                    srv, chunk, fanout, direction,
                    weighted=weighted, replace=replace, rng=rng,
                )
        if served is None:
            lost += 1
            continue
        srv_used, res = served
        if on_dispatch is not None:
            on_dispatch(p, chunk, srv_used)
        if weighted:
            s, n, sc, e = res
            if merge:
                parts_x.append(sc)
            else:
                s, n, e = _topk_by_score(s, n, e, sc, fanout)
        else:
            s, n, e = res
        parts_s.append(s)
        parts_n.append(n)
        parts_e.append(e)
    if not parts_s:
        z = np.zeros(0, np.int64)
        return z, z, z, lost
    s = np.concatenate(parts_s)
    n = np.concatenate(parts_n)
    e = np.concatenate(parts_e)
    if merge:
        if weighted:
            s, n, e = _topk_by_score(s, n, e, np.concatenate(parts_x), fanout)
        else:
            s, n, e = _trim_uniform(s, n, e, fanout, trim_rng)
    return s, n, e, lost


# ---------------------------------------------------------------------------
# The asynchronous request-plan service
# ---------------------------------------------------------------------------


class SamplingService:
    """The shared, concurrent, schedulable sampling tier.

    Owns the servers and a routing strategy; clients submit requests and
    read tickets:

        service = SamplingService(servers, GatherApplyRouting(router))
        t1 = service.submit(seeds_a, spec)
        t2 = service.submit(seeds_b, spec)      # in flight alongside t1
        sub_a, sub_b = t1.result(), t2.result()

    Scheduling: each round advances EVERY in-flight request by one hop, so
    concurrent requests overlap hop levels.  Within a round the service

    - **coalesces** duplicate frontier seeds across requests: each unique
      (server, seed) pair is charged the per-seed request overhead once and
      the round's dispatch count reflects the deduplicated batches (actual
      sample draws stay per-request so results are bit-exact regardless of
      what else is in flight);
    - **splits** per-server batches larger than ``max_server_batch`` into
      separate dispatches, bounding per-dispatch response size so one huge
      request cannot monopolize a server's queue ahead of other requests'
      chunks.

    Work model: ``parallel_work`` accumulates the per-round MAX of the
    per-server work deltas (servers run concurrently; requests sharing a
    round overlap), ``total_work`` the sum.  The blocking clients charge one
    round per request-hop; overlapping in-flight requests therefore lowers
    modeled parallel latency — the request-level load-balancing win the
    paper's service design targets.

    Determinism contract: a request's result is a pure function of
    ``(service seed, request.key, seeds, spec, max_server_batch)`` —
    invariant to submission order, interleaving, coalescing, and the number
    of concurrent clients.
    """

    def __init__(
        self,
        servers: list[SamplingServer],
        routing,
        *,
        seed: int = 0,
        coalesce: bool = True,
        max_server_batch: int = 0,
        replicas: int = 1,
        fault_plan=None,
        retry_policy: RetryPolicy | None = None,
        ticket_timeout: float | None = None,
        dispatcher=None,
    ):
        """``replicas`` spawns ``replicas - 1`` extra servers per partition
        sharing the primary's ``GraphPartition`` (no data copy — the
        in-process stand-in for a replicated deployment); dispatches fail
        over to them when the primary's attempts are exhausted or its
        breaker is open.  ``fault_plan`` (a ``FaultPlan`` or shared
        ``FaultInjector``) arms injection at every server's gather site;
        ``retry_policy`` bounds per-replica attempts; ``ticket_timeout``
        is the default deadline for ``SampleTicket.result()``.

        ``dispatcher`` routes every gather to real worker processes
        instead of the in-process server objects: anything with the
        ``repro.dist.client.WorkerPool`` contract (``dispatch(p, ci,
        chunk, key, hop, spec) -> handle``, ``collect(handle)``, plus
        ``server_stats/health/workloads/reset_stats/close``).  The
        keyed per-dispatch RNG makes the two paths bit-identical; the
        local servers then only provide routing metadata and sit idle."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.servers = servers
        self.routing = routing
        self.seed = int(seed) & _KEY_MASK
        self.coalesce = coalesce
        self.max_server_batch = int(max_server_batch)
        self.replicas = int(replicas)
        self.faults = as_injector(fault_plan)
        self.retry_policy = retry_policy if retry_policy is not None else RetryPolicy()
        self.retry_policy.validate()
        self.ticket_timeout = ticket_timeout
        self.degraded_dispatches = 0
        self.groups: list[list[SamplingServer]] = []
        for srv in servers:
            if self.faults is not None:
                srv.faults = self.faults
            group = [srv]
            for r in range(1, self.replicas):
                group.append(
                    SamplingServer(
                        srv.part,
                        seed=int(seed) + 104729 * r,
                        cost_model=srv.cost_model,
                        replica_id=r,
                        faults=self.faults,
                    )
                )
            self.groups.append(group)
        self._all_servers = [s for group in self.groups for s in group]
        # eids are only meaningful when EVERY server can map to global ids
        # (partitions persisted before edge_global_id existed return local
        # slots, which must not be mistaken for global edge ids)
        self.has_global_eids = all(
            s.part.edge_global_id is not None for s in servers
        )
        self.dispatcher = dispatcher
        self.modeled_parallel_work = 0.0
        self.modeled_total_work = 0.0
        self.rounds = 0
        self.measured_round_seconds = 0.0
        self._inflight: list[_RequestState] = []
        self._auto_key = 0
        # rounds are serialized: concurrent consumers (e.g. a thread-mode
        # prefetch producer beside a foreground sample call) never advance
        # the same request twice; per-request RNG keys keep every result
        # bit-identical no matter which thread drives the round
        self._lock = threading.RLock()

    # -- submission ----------------------------------------------------
    def submit(
        self,
        request,
        spec: SamplingSpec | None = None,
        *,
        key=None,
    ) -> SampleTicket:
        """Submit a ``SampleRequest`` (or ``(seeds, spec)``) for sampling.

        ``key`` names the request's RNG stream (see ``SampleRequest``);
        omitted keys draw from the service's own monotonic counter."""
        if isinstance(request, SampleRequest):
            if spec is not None:
                raise ValueError("pass spec inside the SampleRequest")
            seeds, spec = request.seeds, request.spec
            key = request.key if key is None else key
        else:
            seeds = request
            if spec is None:
                raise ValueError("submit(seeds, ...) requires a SamplingSpec")
        spec.validate()
        with self._lock:
            if key is None:
                key = (self._auto_key,)
                self._auto_key += 1
            req = SampleRequest(
                seeds=np.unique(np.asarray(seeds, dtype=np.int64)),
                spec=spec,
                key=_norm_key(key),
            )
            state = _RequestState(req)
            self._inflight.append(state)
        return SampleTicket(self, state)

    def inflight(self) -> int:
        return len(self._inflight)

    def drain(self) -> None:
        """Run rounds until no request is in flight."""
        while self._inflight:
            self._advance_round()

    # -- blocking shims (one release of deprecation) -------------------
    def sample_khop(
        self,
        seeds: np.ndarray,
        fanouts,
        weighted: bool = False,
        direction: str = DEFAULT_DIRECTION,
    ) -> SampledSubgraph:
        """DEPRECATED submit-and-wait shim over :meth:`submit` (kept one
        release so legacy client call sites keep working)."""
        spec = SamplingSpec(
            fanouts=tuple(fanouts), weighted=weighted, direction=direction
        )
        # glint: disable=DET004 -- deprecated shim keeps the legacy
        # sequence-key behavior its remaining external callers rely on
        return self.submit(seeds, spec).result(timeout=self.ticket_timeout)

    # -- stats ---------------------------------------------------------
    @property
    def router(self) -> VertexRouter:
        router = getattr(self.routing, "router", None)
        if router is None:
            raise AttributeError(
                f"{type(self.routing).__name__} routing has no VertexRouter "
                "(owner-routed services expose .routing.owner instead)"
            )
        return router

    @property
    def parallel_work(self) -> float:
        """DEPRECATED alias for :attr:`modeled_parallel_work` — the name
        hid that this is the Fig.-10 *work model*, not a measurement."""
        return self.modeled_parallel_work

    @parallel_work.setter
    def parallel_work(self, value: float) -> None:
        self.modeled_parallel_work = float(value)

    @property
    def total_work(self) -> float:
        """DEPRECATED alias for :attr:`modeled_total_work`."""
        return self.modeled_total_work

    @total_work.setter
    def total_work(self, value: float) -> None:
        self.modeled_total_work = float(value)

    def stats(self) -> ServiceStats:
        """Service-level aggregate: per-server counters (primaries and
        replicas, remote workers' included) merged into one, the
        service's lost-dispatch count in ``degraded``, the explicitly
        modeled work totals, and the measured per-round wall clock."""
        merged = ServiceStats()
        if self.dispatcher is not None:
            for d in self.dispatcher.server_stats().values():
                merged.merge(ServerStats(**d))
        for srv in self._all_servers:
            merged.merge(srv.stats)
        merged.degraded += self.degraded_dispatches
        merged.modeled_parallel_work = self.modeled_parallel_work
        merged.modeled_total_work = self.modeled_total_work
        merged.rounds = self.rounds
        merged.measured_round_seconds = self.measured_round_seconds
        return merged

    def server_health(self) -> dict[str, str]:
        """Health per replica site, e.g. ``{"server.0.0": "up",
        "server.0.1": "quarantined"}`` (circuit-breaker view).  With a
        remote dispatcher the workers' breakers answer, plus a
        ``worker.<p>`` process-liveness row per worker."""
        if self.dispatcher is not None:
            return self.dispatcher.health()
        return {srv.site: srv.health for srv in self._all_servers}

    def server_workloads(self) -> np.ndarray:
        """Modeled work per partition, summed over that partition's
        replicas (shape unchanged from the replica-free layout)."""
        if self.dispatcher is not None:
            return self.dispatcher.workloads()
        return np.array(
            [sum(s.stats.work_units for s in group) for group in self.groups]
        )

    def reset_stats(self) -> None:
        if self.dispatcher is not None:
            self.dispatcher.reset_stats()
        for s in self._all_servers:
            s.stats = ServerStats()
        self.degraded_dispatches = 0
        self.modeled_parallel_work = 0.0
        self.modeled_total_work = 0.0
        self.rounds = 0
        self.measured_round_seconds = 0.0

    def close(self, timeout: float = 2.0) -> None:
        """Shut down the remote worker pool, if any (in-process services
        have nothing to release)."""
        if self.dispatcher is not None:
            self.dispatcher.close(timeout=timeout)

    def __repr__(self) -> str:
        return (
            f"SamplingService(servers={len(self.servers)}, "
            f"routing={type(self.routing).__name__}, "
            f"inflight={len(self._inflight)})"
        )

    # -- scheduler -----------------------------------------------------
    def _rng(self, key: tuple, hop: int, *tail: int) -> np.random.Generator:
        return request_rng(self.seed, key, hop, *tail)

    def _cancel(self, state: _RequestState) -> None:
        with self._lock:
            if state.done:
                return
            state.done = True
            state.cancelled = True
            if state in self._inflight:
                self._inflight.remove(state)

    def _advance_round(self, deadline: float | None = None) -> None:
        """One scheduling round: every in-flight request advances one hop.

        ``deadline`` (absolute monotonic seconds) bounds the wait for the
        scheduler lock: past it the round is skipped and the caller's own
        deadline check fires.  Without it a blocking acquire could pin a
        short ``result(timeout=)`` behind a long round on another thread."""
        if deadline is None:
            acquired = self._lock.acquire()
        else:
            remaining = deadline - time.monotonic()
            acquired = self._lock.acquire(timeout=max(0.0, min(remaining, 0.05)))
        if not acquired:
            return
        try:
            active = list(self._inflight)
            if not active:
                return
            with tracing.span("sampling.round") as rnd:
                self._run_round(active)
            self.rounds += 1
            self.measured_round_seconds += rnd.seconds
            self._inflight = [st for st in self._inflight if not st.done]
        finally:
            self._lock.release()

    def _run_round(self, active: list) -> None:
        """Advance each of ``active`` one hop and book the round's work."""
        # remote mode: work is booked in the worker processes; the
        # snapshots riding on collected results give per-partition
        # (= per worker host) sums with no extra round-trip.  The
        # parallel-work MAX is then over hosts rather than over
        # individual replica servers — the right granularity, since a
        # partition's replicas share one host either way.
        if self.dispatcher is not None:
            w0 = self.dispatcher.snapshot_workloads()
        else:
            w0 = [srv.stats.work_units for srv in self._all_servers]
        # dispatch log keyed by the SERVING server (primary or a
        # failover replica), so coalescing rebates hit the stats that
        # were actually charged
        log: dict[int, tuple[SamplingServer, list]] = {}

        def on_dispatch(p, chunk, srv):
            log.setdefault(id(srv), (srv, []))[1].append(chunk)

        for st in active:
            with tracing.span("sampling.hop"):
                self._execute_hop(st, on_dispatch)
        if self.coalesce:
            self._coalesce_credit(log)
        if self.dispatcher is not None:
            w1 = self.dispatcher.snapshot_workloads()
        else:
            w1 = [srv.stats.work_units for srv in self._all_servers]
        deltas = [b - a for a, b in zip(w0, w1)]
        self.modeled_parallel_work += max(deltas) if deltas else 0.0
        self.modeled_total_work += sum(deltas)

    def _dispatch_gather(self, p: int, ci: int, chunk: np.ndarray, key, hop, spec):
        """Fault-tolerant dispatch of one chunk to partition ``p``.

        Tries each non-quarantined replica in order, up to
        ``retry_policy.max_attempts`` times each.  Every attempt
        re-derives the dispatch RNG stream from ``(key, hop, p, ci)`` —
        independent of attempt number and of which replica answers — so
        a retry or a failover redraws the bit-identical sample: failover
        is invisible in the result stream by construction.  Returns
        ``(serving_server, raw_gather)`` or ``None`` when every replica
        is exhausted (a degraded, partial-fanout dispatch)."""
        policy = self.retry_policy
        fanout = spec.fanouts[hop]
        for r, srv in enumerate(self.groups[p]):
            if not srv.breaker.allow():
                continue
            for attempt in range(1, policy.max_attempts + 1):
                rng = self._rng(key, hop, p, ci, _GATHER_TAG)
                try:
                    res = _gather_once(
                        srv, chunk, fanout, spec.direction,
                        weighted=spec.weighted, replace=spec.replace, rng=rng,
                    )
                except InjectedFault:
                    srv.breaker.record_failure()
                    if attempt < policy.max_attempts and srv.breaker.state != "open":
                        srv.stats.retries += 1
                        policy.sleep(attempt)
                        continue
                    break  # replica exhausted or quarantined: fail over
                srv.breaker.record_success()
                if r > 0:
                    srv.stats.failovers += 1
                return srv, res
        self.degraded_dispatches += 1
        return None

    def _execute_hop(self, st: _RequestState, on_dispatch) -> None:
        spec = st.request.spec
        key = st.request.key
        hop = st.hop
        if self.dispatcher is not None:
            # remote path: submit every chunk to the worker pool before
            # collecting any answer (real processes overlap), collect in
            # submission order (merge order identical to in-process).
            # No on_dispatch: the workers charge their own stats, so the
            # coalescing rebate has nothing local to credit; lost counts
            # land on the service here — the worker deliberately does not
            # book them (that would double-count degraded in stats()).
            s, n, e, lost = execute_hop(
                self.servers,
                self.routing.route(st.frontier),
                spec.fanouts[hop],
                weighted=spec.weighted,
                replace=spec.replace,
                direction=spec.direction,
                merge=self.routing.merge,
                trim_rng=self._rng(key, hop, _TRIM_TAG),
                max_server_batch=self.max_server_batch,
                submit_dispatch=lambda p, ci, chunk: self.dispatcher.dispatch(
                    p, ci, chunk, key, hop, spec
                ),
                collect_dispatch=self.dispatcher.collect,
            )
            self.degraded_dispatches += lost
        else:
            s, n, e, lost = execute_hop(
                self.servers,
                self.routing.route(st.frontier),
                spec.fanouts[hop],
                weighted=spec.weighted,
                replace=spec.replace,
                direction=spec.direction,
                merge=self.routing.merge,
                trim_rng=self._rng(key, hop, _TRIM_TAG),
                rng_for=lambda p, ci: self._rng(key, hop, p, ci, _GATHER_TAG),
                max_server_batch=self.max_server_batch,
                on_dispatch=on_dispatch,
                dispatch=lambda p, ci, chunk: self._dispatch_gather(
                    p, ci, chunk, key, hop, spec
                ),
            )
        if lost:
            st.result.degraded = True
            st.result.lost_dispatches += lost
        st.result.hops.append(
            SampledHop(src=s, dst=n, eid=e if self.has_global_eids else None)
        )
        st.hop += 1
        st.frontier = np.unique(n)
        if st.hop >= len(spec.fanouts) or st.frontier.shape[0] == 0:
            st.done = True

    def _coalesce_credit(self, log: dict) -> None:
        """Rebate the duplicated dispatch overhead within one round.

        Draw work stays per-request (per-request RNG streams must actually
        run), but a seed dispatched to the same server by several in-flight
        requests is one service-level request: the per-seed handling
        overhead and the dispatch count are charged for the deduplicated
        batch only.  Results are untouched — coalescing on/off is
        bit-equivalent; only the workload model changes."""
        m = self.max_server_batch
        for srv, arrs in log.values():
            if len(arrs) <= 1:
                continue
            # only seeds the server actually hosts were charged
            present = [a[srv.part.global_to_local(a) >= 0] for a in arrs]
            charged = [a for a in present if a.shape[0]]
            if len(charged) <= 1:
                continue
            total = sum(a.shape[0] for a in charged)
            uniq = int(np.unique(np.concatenate(charged)).shape[0])
            dup = total - uniq
            srv.stats.seeds -= dup
            srv.stats.work_units -= dup
            fair = 1 if m <= 0 else -(-uniq // m)  # ceil
            srv.stats.requests -= len(charged) - min(len(charged), fair)


# ---------------------------------------------------------------------------
# Legacy blocking clients (thin wrappers over the shared hop executor)
# ---------------------------------------------------------------------------


class _BlockingClient:
    """Shared K-hop loop for the legacy blocking clients: route, execute the
    hop through the one shared executor, account one scheduling round per
    request-hop (no overlap — exactly the pre-service behavior)."""

    routing = None  # set by subclasses

    def _init_common(self, servers: list[SamplingServer], seed: int) -> None:
        self.servers = servers
        self.rng = np.random.default_rng(seed)
        self.has_global_eids = all(
            s.part.edge_global_id is not None for s in servers
        )
        # modeled wall-clock work: servers run in parallel, so a hop costs the
        # MAX of the per-server work deltas (the in-process simulation is
        # serial; benchmarks use this to report parallel-cluster latency)
        self.parallel_work = 0.0
        self.total_work = 0.0

    def sample_khop(
        self,
        seeds: np.ndarray,
        fanouts: list[int],
        weighted: bool = False,
        direction: str = DEFAULT_DIRECTION,
    ) -> SampledSubgraph:
        seeds = np.unique(np.asarray(seeds, dtype=np.int64))
        result = SampledSubgraph(seeds=seeds)
        frontier = seeds
        for f in fanouts:
            w0 = [srv.stats.work_units for srv in self.servers]
            s, n, e, _ = execute_hop(
                self.servers,
                self.routing.route(frontier),
                f,
                weighted=weighted,
                direction=direction,
                merge=self.routing.merge,
                trim_rng=self.rng,
            )
            deltas = [
                srv.stats.work_units - w for srv, w in zip(self.servers, w0)
            ]
            self.parallel_work += max(deltas) if deltas else 0.0
            self.total_work += sum(deltas)
            result.hops.append(
                SampledHop(src=s, dst=n, eid=e if self.has_global_eids else None)
            )
            frontier = np.unique(n)  # GetSeedsOfNextHop
            if frontier.shape[0] == 0:
                break
        return result

    def server_workloads(self) -> np.ndarray:
        return np.array([s.stats.work_units for s in self.servers])

    def reset_stats(self) -> None:
        for s in self.servers:
            s.stats = ServerStats()
        self.parallel_work = 0.0
        self.total_work = 0.0


class GatherApplyClient(_BlockingClient):
    """GLISP client: Gather from all hosting servers, Apply merge (Alg. 1)."""

    def __init__(
        self,
        servers: list[SamplingServer],
        router: VertexRouter,
        seed: int = 0,
    ):
        self._init_common(servers, seed)
        self.routing = GatherApplyRouting(router)
        self.router = router


class EdgeCutClient(_BlockingClient):
    """DistDGL-style baseline: one-hop request of v is answered ONLY by
    owner(v); the halo (replicated cut edges) makes it local.  Built over the
    same server implementation, but routing is by vertex owner, the local
    partition holds the vertex's FULL one-hop, and the sample is complete
    without a merge step (local_deg == global_deg on the owner)."""

    def __init__(
        self,
        servers: list[SamplingServer],
        vertex_owner: np.ndarray,
        seed: int = 0,
    ):
        self._init_common(servers, seed)
        self.routing = OwnerRouting(vertex_owner, len(servers))
        self.owner = vertex_owner
