"""Layerwise (redundancy-free) graph inference engine (paper §III-D, Fig. 7).

Counterpart of ``repro/core/inference/engine.py``. A K-layer GNN is split
into K one-layer slices. Slice k reads layer-(k-1) embeddings of every
vertex and its one-hop sampled neighbors through a tiered ``HybridCache``,
computes layer-k embeddings for ALL vertices, and writes them to the
chunked store, so no vertex-layer embedding is ever computed twice. Work is
allocated one partition per worker; vertex ids for embedding I/O come from
the graph reorder algorithm (PDS by default).

Execution modes
---------------
``mode="bucketed"`` (default) is the device path: each batch's
(self, nbr, seg, etype) arrays are copied to the device once, padded there
to a power-of-two shape bucket, run through the layer's tensor slice
(``layer_fn.torch``, see ``GNNModel.embed_layer_fn``), and the result is
copied back once. Online batches (:meth:`run_layer_batch`) all run at one
fixed shape instead (:meth:`serving_shape`). Plain numpy layer callables still work and get the
vectorized gather without the device copies.

``mode="reference"`` keeps the per-vertex slice-and-concatenate gathers
and calls the layer's numpy callable on the unpadded batch.

:func:`samplewise_inference` is the naive baseline the paper's layerwise
claim is measured against (each target's K-hop subgraph through the whole
model): the reference's numpy, copied, around the layers' numpy callables,
which compute on the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.inference.cache import CacheStats
from repro_torch.core.sampling.service import (
    DEFAULT_DIRECTION,
    MAX_PARTS,
    GatherApplyClient,
    SamplingSpec,
)
from repro_torch.core.storage import (
    DFSTier,
    HybridCache,
    HybridStats,
    IOCost,
    TierStats,
    build_tiers,
)
from repro_torch.device import resolve_device
from repro_torch.graph.graph import HeteroGraph
from repro_torch.graph.reorder import reorder_permutation
from repro_torch.kernels.autotune import autotune_for_slice

# domain-separation tag for the engine's sample-request RNG keys, so they
# never alias a loader/trainer request stream on a shared service (the same
# tag as the JAX engine, so both draw the same neighbors)
_ENGINE_KEY_TAG = 0x1F7E

__all__ = [
    "CacheStats",
    "InferenceResult",
    "LayerStats",
    "LayerwiseInferenceEngine",
    "assign_inference_owners",
    "csr_gather",
    "samplewise_inference",
]


def csr_gather(values: np.ndarray, starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ``values[starts[i] : starts[i] + counts[i]]`` for all i,
    without a per-segment Python loop (one ``np.repeat`` over the CSR
    offsets plus a single fancy-index)."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return values[:0]
    starts = np.asarray(starts, dtype=np.int64)
    shift = starts - np.concatenate(([0], np.cumsum(counts)[:-1]))
    idx = np.repeat(shift, counts) + np.arange(total, dtype=np.int64)
    return values[idx]


def _pow2_ceil(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def assign_inference_owners(
    router_mask: np.ndarray, num_parts: int, seed: int = 0
) -> np.ndarray:
    """One inference owner per vertex: interior vertices go to their partition;
    boundary vertices go greedily to their least-loaded hosting partition."""
    if num_parts > MAX_PARTS:
        raise ValueError(
            f"assign_inference_owners supports at most {MAX_PARTS} partitions "
            f"(uint64 hosting bitmask), got num_parts={num_parts}"
        )
    n = router_mask.shape[0]
    owner = np.full(n, -1, dtype=np.int16)
    loads = np.zeros(num_parts, dtype=np.int64)
    bits = np.unpackbits(
        router_mask.view(np.uint8).reshape(n, 8), axis=1, bitorder="little"
    )[:, :num_parts]
    npart = bits.sum(axis=1)
    interior = npart == 1
    owner[interior] = np.argmax(bits[interior], axis=1)
    loads += np.bincount(owner[interior][owner[interior] >= 0], minlength=num_parts)
    boundary = np.flatnonzero(~interior)
    rng = np.random.default_rng(seed)
    boundary = rng.permutation(boundary)
    for batch in np.array_split(boundary, max(1, boundary.shape[0] // 8192)):
        if batch.shape[0] == 0:
            continue
        # choose min-load hosting partition (loads frozen within the batch)
        cand = bits[batch].astype(np.float64)
        cand[cand == 0] = np.inf
        scored = cand * (loads + 1)
        pick = np.argmin(scored, axis=1).astype(np.int16)
        owner[batch] = pick
        loads += np.bincount(pick, minlength=num_parts)
    if not (owner >= 0).all():
        raise RuntimeError("a vertex is hosted by no partition")
    return owner


@dataclass
class LayerStats:
    cache: CacheStats = field(default_factory=CacheStats)
    # aggregated per-tier accounting (fast→slow) across this layer's
    # partition caches; empty until the first partition finishes
    tiers: list = field(default_factory=list)
    vertices_computed: int = 0
    edges_aggregated: int = 0
    # padding-waste accounting: real vs power-of-two-padded rows the
    # bucketed slices dispatched, and per (vertex-bucket, edge-bucket)
    # batch counts
    batch_rows: int = 0
    padded_rows: int = 0
    batch_edges: int = 0
    padded_edges: int = 0
    bucket_batches: dict = field(default_factory=dict)

    def note_batch(
        self, rows: int, padded_rows: int, edges: int, padded_edges: int
    ) -> None:
        self.batch_rows += rows
        self.padded_rows += padded_rows
        self.batch_edges += edges
        self.padded_edges += padded_edges
        self.bucket_batches[(padded_rows, padded_edges)] = (
            self.bucket_batches.get((padded_rows, padded_edges), 0) + 1
        )

    def occupancy(self) -> float:
        """Fraction of padded vertex rows that carried real vertices."""
        return self.batch_rows / self.padded_rows if self.padded_rows else 0.0

    def edge_occupancy(self) -> float:
        return self.batch_edges / self.padded_edges if self.padded_edges else 0.0

    def device_batches(self) -> int:
        """Batches this layer sent through the device slice."""
        return sum(self.bucket_batches.values())

    def absorb(self, hs: HybridStats) -> None:
        """Fold one partition cache's counters into this layer's totals."""
        self.cache.fill_chunks += hs.fill_chunks
        self.cache.static_reads += hs.static_reads
        self.cache.dynamic_hits += hs.dynamic_hits
        self.cache.rows_served += hs.rows_served
        if not self.tiers:
            self.tiers = [TierStats(kind=t.kind) for t in hs.tiers]
        for agg, t in zip(self.tiers, hs.tiers):
            agg.hits += t.hits
            agg.admits += t.admits
            agg.evictions += t.evictions

    def modeled_io_ms(self, cost: IOCost) -> float:
        """Tier-aware rollup of modeled storage time."""
        if not self.tiers:
            return self.cache.modeled_time_ms(cost)
        ms = self.cache.fill_chunks * cost.dfs_ms
        for t in self.tiers:
            ms += t.hits * cost.per_chunk_ms(t.kind)
        return ms


@dataclass
class InferenceResult:
    final_store: DFSTier
    newid: np.ndarray  # vertex gid -> row id in stores
    owner: np.ndarray
    layer_stats: list[LayerStats] = field(default_factory=list)
    # distinct (layer, bucket) shapes this run sent through the device slice
    slice_shapes: int = 0

    def total_chunk_reads(self) -> int:
        return sum(s.cache.static_reads for s in self.layer_stats)

    def total_dynamic_hits(self) -> int:
        return sum(s.cache.dynamic_hits for s in self.layer_stats)

    def dynamic_hit_ratio(self) -> float:
        r = self.total_chunk_reads()
        h = self.total_dynamic_hits()
        return h / (h + r) if (h + r) else 0.0

    def modeled_io_ms(self, cost: IOCost) -> float:
        return sum(s.modeled_io_ms(cost) for s in self.layer_stats)

    def vertices_computed(self) -> int:
        return sum(s.vertices_computed for s in self.layer_stats)

    def device_batches(self) -> int:
        return sum(s.device_batches() for s in self.layer_stats)


@dataclass
class _ServeSliceStats:
    """Throwaway ``slice_shapes`` sink for online ``run_layer_batch`` calls
    (the lifetime shape set on the engine still records the shape)."""

    slice_shapes: int = 0


class LayerwiseInferenceEngine:
    def __init__(
        self,
        g: HeteroGraph,
        client,  # SamplingService (preferred) or a raw GatherApplyClient
        layer_fns: list,
        feats: np.ndarray,
        workdir: str,
        *,
        fanouts: list[int] | None = None,
        reorder_alg: str = "PDS",
        chunk_rows: int = 4096,
        policy="fifo",  # CACHE_POLICIES name or class
        dynamic_frac: float = 0.10,
        storage_tiers: tuple = ("memory", "disk"),
        tier_capacities: tuple = (),
        batch_size: int = 4096,
        direction: str = DEFAULT_DIRECTION,
        out_dims: list[int] | None = None,
        seed: int = 0,
        mode: str = "bucketed",
        edge_buckets: tuple | None = None,
        ticket_timeout: float | None = None,
        retry_policy=None,  # RetryPolicy for tiered-storage reads
        faults=None,  # FaultPlan/FaultInjector armed on the cache tiers
        device="cuda",
        kernel_autotune: bool = False,
        kernel_cache_dir: str | None = None,
    ):
        if mode not in ("bucketed", "reference"):
            raise ValueError(f"mode must be 'bucketed' or 'reference', got {mode!r}")
        self.g = g
        self.client = client
        self.layer_fns = layer_fns
        self.feats = feats
        self.workdir = workdir
        self.fanouts = fanouts or [10] * len(layer_fns)
        self.reorder_alg = reorder_alg
        self.chunk_rows = chunk_rows
        self.policy = policy
        self.dynamic_frac = dynamic_frac
        self.storage_tiers = tuple(storage_tiers)
        self.tier_capacities = tuple(tier_capacities)
        self.batch_size = batch_size
        self.direction = direction
        self.out_dims = out_dims or [feats.shape[1]] * len(layer_fns)
        self.seed = seed
        self.mode = mode
        self.edge_buckets = tuple(edge_buckets) if edge_buckets else ()
        self.ticket_timeout = ticket_timeout
        self.retry_policy = retry_policy
        self.faults = faults
        self.device = resolve_device(device)
        # sweep the kernels' launch shapes per (op, bucket, dtype) before a
        # (layer, bucket)'s first slice (repro_torch.kernels.autotune); the
        # artifact directory, or None to keep the winners in process only
        self.kernel_autotune = kernel_autotune
        self.kernel_cache_dir = kernel_cache_dir
        # filled by run(): the per-layer DFS stores (index k = layer-k
        # embeddings, 0 = input features) and the last InferenceResult —
        # the online serving tier reads layer K-1 through these instead of
        # re-opening the store paths (keeps live checksums)
        self.layer_stores: list = []
        self.last_result: InferenceResult | None = None
        self._shapes_seen: set = set()  # (layer, Bp, Ep) seen this run
        self._shapes_lifetime: set = set()  # every (layer, Bp, Ep) ever run

    # -- shape bucketing ------------------------------------------------
    def _vertex_bucket(self, b: int) -> int:
        return min(self.batch_size, _pow2_ceil(b, 64))

    def _edge_bucket(self, e: int) -> int:
        if self.edge_buckets:
            for cap in self.edge_buckets:
                if e <= cap:
                    return int(cap)
        return _pow2_ceil(e, 256)

    def serving_shape(self, k: int, b: int, e: int) -> tuple[int, int]:
        """The padded (vertex, edge) shape of an online batch of ``b`` rows
        and ``e`` edges at layer ``k``: one fixed shape, the buckets of the
        batcher's capacity (``batch_size`` rows, ``batch_size * fanout``
        edges). A row then meets the same matmul shapes whether its request
        was served alone or in any batch; cuBLAS picks its algorithm, and
        with it a row's bits, per shape. A batch beyond the capacity (an
        oversized first request) takes the bucket of its own size."""
        cap = self.batch_size
        bp = self._vertex_bucket(cap) if b <= cap else _pow2_ceil(b, 64)
        return bp, self._edge_bucket(max(e, cap * self.fanouts[k]))

    def _slice_fn(self, layer_fn):
        """The layer's tensor slice for the bucketed path, or None (the
        numpy callable runs eagerly)."""
        if self.mode != "bucketed":
            return None
        return getattr(layer_fn, "torch", None)

    def shape_count(self) -> int:
        """Distinct (layer, vertex-bucket, edge-bucket) triples ever run."""
        return len(self._shapes_lifetime)

    # -- tiered storage -------------------------------------------------
    def _build_cache(self, store: DFSTier) -> HybridCache:
        """One per-(layer, partition) tier stack from the storage config."""
        tiers = build_tiers(
            self.storage_tiers,
            store.chunk_rows,
            store.dim,
            capacities=self.tier_capacities,
            dtype=store.dtype,
            faults=self.faults,
        )
        return HybridCache(
            store,
            tiers,
            policy=self.policy,
            dynamic_frac=self.dynamic_frac,
            retry_policy=self.retry_policy,
        )

    # ------------------------------------------------------------------
    def run(self) -> InferenceResult:
        g = self.g
        num_parts = self.client.router.num_parts
        owner = assign_inference_owners(self.client.router.mask, num_parts, self.seed)
        deg = g.out_degrees() + g.in_degrees()
        perm = reorder_permutation(
            self.reorder_alg,
            global_ids=np.arange(g.num_vertices, dtype=np.int64),
            degrees=deg,
            partition_ids=owner,
        )
        newid = np.empty(g.num_vertices, dtype=np.int64)
        newid[perm] = np.arange(g.num_vertices)

        # layer-0 store: input features in newid order
        store_prev = DFSTier(
            f"{self.workdir}/layer0",
            g.num_vertices,
            self.feats.shape[1],
            self.chunk_rows,
        )
        store_prev.write_rows(newid, self.feats)

        result = InferenceResult(
            final_store=store_prev, newid=newid, owner=owner
        )
        stores = [store_prev]

        # inference order within each worker follows the reorder ids
        part_verts = []
        for p in range(num_parts):
            verts = np.flatnonzero(owner == p)
            part_verts.append(verts[np.argsort(newid[verts], kind="stable")])

        submit = getattr(self.client, "submit", None)
        self._shapes_seen.clear()  # slice_shapes counts per-run shapes
        for k, layer_fn in enumerate(self.layer_fns):
            stats = LayerStats()
            slice_fn = self._slice_fn(layer_fn)
            needs_etype = getattr(layer_fn, "needs_etype", False)
            store_next = DFSTier(
                f"{self.workdir}/layer{k + 1}",
                g.num_vertices,
                self.out_dims[k],
                self.chunk_rows,
            )
            # one-hop sampled neighbors for every worker: submit ALL workers'
            # requests up front so the service schedules them in one round
            # (balanced dispatch across servers); explicit keys make the
            # sample independent of any other traffic on a shared service
            tickets = None
            if submit is not None:
                spec = SamplingSpec(
                    fanouts=(self.fanouts[k],), direction=self.direction
                )
                tickets = [
                    submit(
                        part_verts[p],
                        spec,
                        key=(self.seed, k, p, _ENGINE_KEY_TAG),
                    )
                    for p in range(num_parts)
                ]
            for p in range(num_parts):
                verts = part_verts[p]
                if tickets is not None:
                    sub = tickets[p].result(timeout=self.ticket_timeout)
                    tickets[p] = None  # release the hop data once consumed
                else:
                    sub = self.client.sample_khop(
                        verts, [self.fanouts[k]], direction=self.direction
                    )
                hop = sub.hops[0]
                # static cache fill: all local rows + sampled neighbor rows,
                # with the partition's own rows as the fill-plan focus window
                cache = self._build_cache(store_prev)
                rows_needed = newid[
                    np.unique(np.concatenate([verts, hop.dst]))
                ]
                cache.fill(
                    cache.plan_fill(rows_needed, focus_rows=newid[verts])
                )
                # process in inference order batches
                order = np.argsort(hop.src, kind="stable")
                h_src_sorted = hop.src[order]
                h_dst_sorted = hop.dst[order]
                # edge types are gathered only for layers that consume them
                if needs_etype and hop.eid is not None:
                    h_et_sorted = g.edge_types[hop.eid[order]].astype(np.int32)
                elif needs_etype:
                    h_et_sorted = np.zeros(h_src_sorted.shape[0], np.int32)
                else:
                    h_et_sorted = None
                starts = np.searchsorted(h_src_sorted, verts)
                ends = np.searchsorted(h_src_sorted, verts, side="right")
                for lo in range(0, verts.shape[0], self.batch_size):
                    vb = verts[lo : lo + self.batch_size]
                    s_ = starts[lo : lo + self.batch_size]
                    e_ = ends[lo : lo + self.batch_size]
                    counts = e_ - s_
                    if self.mode == "reference":
                        nbr_rows = np.concatenate(
                            [h_dst_sorted[a:b] for a, b in zip(s_, e_)]
                        ) if vb.shape[0] else np.zeros(0, np.int64)
                    else:
                        nbr_rows = csr_gather(h_dst_sorted, s_, counts)
                    et = (
                        csr_gather(h_et_sorted, s_, counts)
                        if h_et_sorted is not None
                        else None
                    )
                    # non-decreasing by construction: the kernels' CSR rows
                    seg = np.repeat(np.arange(vb.shape[0]), counts)
                    h_self = cache.read_rows(newid[vb])
                    h_nbr = (
                        cache.read_rows(newid[nbr_rows])
                        if nbr_rows.shape[0]
                        else np.zeros((0, store_prev.dim), store_prev.dtype)
                    )
                    if slice_fn is not None:
                        h_new = self._run_slice(
                            k, slice_fn, h_self, h_nbr, seg, et, result, stats
                        )
                    elif needs_etype:
                        h_new = np.asarray(
                            layer_fn(k, h_self, h_nbr, seg, et)
                        )
                    else:
                        h_new = np.asarray(layer_fn(k, h_self, h_nbr, seg))
                    store_next.write_rows(newid[vb], h_new)
                    stats.vertices_computed += vb.shape[0]
                    stats.edges_aggregated += int(nbr_rows.shape[0])
                stats.absorb(cache.stats)
                cache.evict()  # release this partition's cache residency
            result.layer_stats.append(stats)
            stores.append(store_next)
            store_prev = store_next
        result.final_store = store_prev
        self.layer_stores = stores
        self.last_result = result
        return result

    # -- online serving entry point --------------------------------------
    def run_layer_batch(self, k, h_self, h_nbr, seg, et=None) -> np.ndarray:
        """One layer-``k`` slice over an online batch, outside ``run()``,
        through the offline path's device slice at the fixed
        :meth:`serving_shape`. Falls back to the plain numpy layer callable
        when the layer has no tensor slice."""
        layer_fn = self.layer_fns[k]
        slice_fn = self._slice_fn(layer_fn)
        if slice_fn is not None:
            shim = _ServeSliceStats()
            shape = self.serving_shape(k, h_self.shape[0], seg.shape[0])
            return self._run_slice(k, slice_fn, h_self, h_nbr, seg, et, shim, shape=shape)
        if getattr(layer_fn, "needs_etype", False):
            return np.asarray(layer_fn(k, h_self, h_nbr, seg, et))
        return np.asarray(layer_fn(k, h_self, h_nbr, seg))

    # -- bucketed device execution --------------------------------------
    def _run_slice(self, k, slice_fn, h_self, h_nbr, seg, et, result, stats=None, shape=None):
        """Run the tensor slice over one batch padded to ``shape`` (default:
        its (vertex, edge) shape bucket): one host→device copy of each
        array's real rows into a device buffer of the padded shape, one
        device→host copy of the result. Padding rows are zero and padding
        edges have ``seg == -1`` at the tail."""
        b, e = h_self.shape[0], seg.shape[0]
        bp, ep = shape or (self._vertex_bucket(b), self._edge_bucket(e))
        key = (k, bp, ep)
        if self.kernel_autotune and key not in self._shapes_lifetime:
            # tune this bucket's kernel shapes before its first slice, so
            # the slice's launches read the winners (a CPU device raises)
            shapes_of = getattr(self.layer_fns[k], "kernel_shapes", None)
            if shapes_of is not None:
                autotune_for_slice(
                    shapes_of(ep, bp, h_nbr.shape[1]),
                    h_nbr.dtype,
                    cache_dir=self.kernel_cache_dir,
                    device=self.device,
                )
        if key not in self._shapes_seen:
            self._shapes_seen.add(key)
            result.slice_shapes += 1
        self._shapes_lifetime.add(key)
        if stats is not None:
            stats.note_batch(b, bp, e, ep)
        dev = self.device

        def padded(a, rows, fill):
            a = np.ascontiguousarray(a)
            buf = torch.full((rows,) + a.shape[1:], fill, dtype=torch.from_numpy(a).dtype,
                             device=dev)
            buf[: a.shape[0]] = torch.from_numpy(a).to(dev)
            return buf

        out = slice_fn(
            padded(h_self, bp, 0),
            padded(h_nbr, ep, 0),
            padded(seg.astype(np.int32, copy=False), ep, -1),
            padded(np.zeros(0, np.int32) if et is None else et.astype(np.int32, copy=False),
                   ep, 0),
        )
        return out[:b].cpu().numpy()


def samplewise_inference(
    g: HeteroGraph,
    client: GatherApplyClient,
    layer_fns: list,
    feats: np.ndarray,
    targets: np.ndarray,
    *,
    fanouts: list[int] | None = None,
    batch_size: int = 256,
    direction: str = "out",
) -> tuple[np.ndarray, dict]:
    """Naive baseline: per-target K-hop subgraph through the full model.

    Vectorized over a compacted id space (``searchsorted`` into the sorted
    vertex universe instead of a per-vertex Python dict), so the baseline is
    honestly fast and speedup claims measure algorithmic redundancy, not
    interpreter overhead.  Returns (embeddings[targets], stats) where stats
    counts the redundant vertex-layer computations the layerwise engine
    avoids."""
    K = len(layer_fns)
    fanouts = fanouts or [10] * K
    stats = {"vertices_computed": 0, "edges_aggregated": 0, "feature_rows_read": 0}
    out = None

    for lo in range(0, targets.shape[0], batch_size):
        tb = np.unique(targets[lo : lo + batch_size])
        sub = client.sample_khop(tb, fanouts, direction=direction)
        # A vertex first reached at depth d has its sampled one-hop edges in
        # hop d; layer k therefore aggregates the union of hops 0..K-1-k and
        # needs h^{k-1} for every vertex at depth <= K-k.
        frontiers = [tb]
        hop_et = []
        for hop in sub.hops:
            frontiers.append(np.unique(hop.dst))
            hop_et.append(
                g.edge_types[hop.eid].astype(np.int32)
                if hop.eid is not None
                else np.zeros(hop.src.shape[0], np.int32)
            )
        all_verts = np.unique(np.concatenate(frontiers))
        hcur = np.ascontiguousarray(feats[all_verts])
        stats["feature_rows_read"] += all_verts.shape[0]
        for k in range(K):
            layer = layer_fns[k]
            es = np.concatenate([h.src for h in sub.hops[: K - k]])
            ed = np.concatenate([h.dst for h in sub.hops[: K - k]])
            et = np.concatenate(hop_et[: K - k])
            need_verts = np.unique(np.concatenate(frontiers[: K - k]))
            order = np.argsort(es, kind="stable")
            es, ed, et = es[order], ed[order], et[order]
            s_ = np.searchsorted(es, need_verts)
            e_ = np.searchsorted(es, need_verts, side="right")
            counts = e_ - s_
            nbrs = csr_gather(ed, s_, counts)
            et_g = csr_gather(et, s_, counts)
            seg = np.repeat(np.arange(need_verts.shape[0]), counts)
            need_pos = np.searchsorted(all_verts, need_verts)
            h_self = hcur[need_pos]
            h_nbr = (
                hcur[np.searchsorted(all_verts, nbrs)]
                if nbrs.shape[0]
                else np.zeros((0, h_self.shape[1]), h_self.dtype)
            )
            if getattr(layer, "needs_etype", False):
                h_new = np.asarray(layer(k, h_self, h_nbr, seg, et_g))
            else:
                h_new = np.asarray(layer(k, h_self, h_nbr, seg))
            nxt = np.zeros((all_verts.shape[0], h_new.shape[1]), h_new.dtype)
            nxt[need_pos] = h_new
            hcur = nxt
            stats["vertices_computed"] += need_verts.shape[0]
            stats["edges_aggregated"] += int(nbrs.shape[0])
        hb = hcur[np.searchsorted(all_verts, tb)]  # tb is unique-sorted
        # map back to the original (possibly unsorted) batch order
        hb = hb[np.searchsorted(tb, targets[lo : lo + batch_size])]
        out = hb if out is None else np.concatenate([out, hb])
    return out, stats
