"""``GNNServer`` — the online inference serving loop.

Serving turns the offline layerwise artifact into a request surface: an
``infer_layerwise`` run leaves per-layer embedding stores on disk, and a
live "embed these vertices now" request only needs the FINAL layer
recomputed — one sampled hop plus one layer slice over the layer-(K-1)
store.  That store is read through a serving ``HybridCache``, so the Zipf
head (hot users) migrates into the memory tier and the paper's power-law
popularity assumption becomes a serving win, not just a partitioning one.

Request lifecycle (cooperative, single-threaded like ``SamplingService``):

1. ``submit`` — admission against the bounded :class:`RequestQueue`
   (queue-full is an explicit ``rejected`` response, counted, never
   silent), then the request's one-hop sample is submitted to the
   ``SamplingService`` immediately, keyed ``(_SERVE_TAG, request_id)``:
   sampling for everything queued rides in flight together, hiding hop
   latency behind the compute of earlier batches.
2. ``step`` — the :class:`ContinuousBatcher` packs queue-order requests
   into the engine's power-of-two shape buckets; partial buckets flush on
   the ``max_batch_delay_ms`` timer.  Each flushed batch waits on its
   tickets under the per-request deadline (``SampleTicket.result(timeout=)``),
   completes deadline-missed requests with explicit ``timeout`` responses,
   and runs one padded slice through the engine's cached jit — the same
   (layer, bucket) compile the offline pass already traced.
3. ``response`` / ``drain`` — collect :class:`ServeResponse` objects.

Determinism: each request's sample stream is keyed by its request id and
its compute rows are padded row-independently, so the returned embeddings
are bit-identical whether the request was served solo or packed into any
batch mix (property-tested in tests/test_serve.py).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.inference.engine import csr_gather
from repro_torch.core.sampling.service import SampleTimeout, SamplingSpec
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import ServeRequest, ServeResponse
from repro_torch.serve.stats import ServeStats

__all__ = ["GNNServer"]

# domain-separation tag for serving sample-request keys: never aliases the
# trainer/loader (pipeline counter) or engine (_ENGINE_KEY_TAG) streams
_SERVE_TAG = 0x5E12


class GNNServer:
    """Online serving over a built ``GLISPSystem`` with a completed
    ``infer_layerwise`` run (construct via ``system.server()``)."""

    def __init__(
        self,
        system,
        *,
        queue_depth: int = 64,
        max_batch_delay_ms: float = 2.0,
        deadline_ms: float | None = 100.0,
    ):
        engine = system.infer_engine
        if engine is None or engine.last_result is None or not engine.layer_stores:
            raise ValueError(
                "GNNServer needs a completed infer_layerwise() run on this "
                "system (the per-layer embedding stores and the cached "
                "engine drive serving); call system.infer_layerwise(...) "
                "first"
            )
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive or None, got {deadline_ms}"
            )
        self.system = system
        self.engine = engine
        self.deadline_ms = deadline_ms
        k = len(engine.layer_fns) - 1
        self.layer = k
        self.newid = engine.last_result.newid
        self.store = engine.layer_stores[k]  # layer-(K-1) embeddings
        # the serving cache: same tier stack/policy as the offline engine,
        # demand-filled by request traffic so hot rows settle in the fast
        # tiers (per-tier ratios surface in ServeStats.cache_hit_ratios)
        self.cache = engine._build_cache(self.store)
        self.spec = SamplingSpec(
            fanouts=(engine.fanouts[k],), direction=engine.direction
        )
        self._needs_etype = getattr(engine.layer_fns[k], "needs_etype", False)
        self.queue = RequestQueue(queue_depth)
        self.batcher = ContinuousBatcher(engine.batch_size, max_batch_delay_ms)
        self.stats = ServeStats()
        self._next_id = 0
        self._responses: dict[int, ServeResponse] = {}
        self._tickets: dict[int, object] = {}  # request_id -> SampleTicket

    # -- submission ----------------------------------------------------
    def submit(
        self,
        vertices: np.ndarray,
        *,
        deadline_ms: float | None = None,
        now: float | None = None,
    ) -> int:
        """Admit one request; returns its request id.

        Rejected requests (queue full) complete immediately with
        ``status="rejected"`` — poll :meth:`response` either way."""
        now = time.monotonic() if now is None else now
        rid = self._next_id
        self._next_id += 1
        req = ServeRequest.make(rid, vertices, deadline_ms, now)
        self.stats.submitted += 1
        if not self.queue.push(req):
            self.stats.rejected += 1
            self._responses[rid] = ServeResponse(request_id=rid, status="rejected")
            return rid
        self.stats.note_queue_depth(len(self.queue))
        # sample NOW, not at batch-flush time: every queued request's hop
        # rides the SamplingService in-flight window while earlier batches
        # compute — request keying keeps the draw independent of traffic
        self._tickets[rid] = self.system.submit(
            req.unique, self.spec, key=(_SERVE_TAG, rid)
        )
        return rid

    def response(self, request_id: int, *, pop: bool = True) -> ServeResponse | None:
        """The finished response for ``request_id``, or ``None`` if still
        pending.  ``pop=True`` releases it from the server's buffer."""
        if pop:
            return self._responses.pop(request_id, None)
        return self._responses.get(request_id)

    def pending(self) -> int:
        """Requests admitted but not yet answered."""
        return len(self.queue) + len(self.batcher)

    # -- the serving loop ----------------------------------------------
    def step(self, *, now: float | None = None, force: bool = False) -> int:
        """One scheduler step: move admitted requests into the batcher,
        flush if a trigger fired (``force=True`` flushes a partial batch —
        use when no further arrivals are expected), compute, complete.
        Returns the number of requests answered this step."""
        now = time.monotonic() if now is None else now
        while self.queue and self.batcher.has_room():
            req = self.queue.pop()
            self.batcher.add(req, req.unique.shape[0], now)
        self.stats.note_queue_depth(len(self.queue))
        batch = self.batcher.take(now, force=force)
        if batch is None:
            return 0
        return self._serve_batch(batch)

    def drain(self) -> None:
        """Serve until nothing is pending (forces partial flushes)."""
        while self.pending():
            self.step(force=True)

    def call(self, vertices: np.ndarray, *, deadline_ms: float | None = None) -> ServeResponse:
        """Blocking convenience: submit one request and serve it through."""
        # GNNServer.submit keys its sampling itself: (_SERVE_TAG, request_id)
        rid = self.submit(vertices, deadline_ms=deadline_ms)  # glint: disable=DET004 -- see above
        resp = self.response(rid)
        while resp is None:
            self.step(force=True)
            resp = self.response(rid)
        return resp

    # -- batch execution -----------------------------------------------
    def _finish(self, req: ServeRequest, resp: ServeResponse, now: float) -> None:
        resp.latency_ms = (now - req.submitted_at) * 1e3
        self._responses[req.request_id] = resp
        self.stats.completed += 1
        if resp.status == "timeout":
            self.stats.timed_out += 1
        if resp.degraded:
            self.stats.degraded += 1
        self.stats.latency.add(resp.latency_ms)

    def _serve_batch(self, batch: list) -> int:
        """Wait out the batch's samples, drop deadline-missed requests with
        explicit timeout responses, run ONE padded slice for the rest."""
        live: list = []  # (req, sub)
        for req in batch:
            ticket = self._tickets.pop(req.request_id)
            deadline = req.deadline_at(self.deadline_ms)
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                ticket.cancel()
                self._finish(
                    req, ServeResponse(request_id=req.request_id, status="timeout"), now
                )
                continue
            try:
                timeout = None if deadline is None else deadline - now
                sub = ticket.result(timeout=timeout)
            except SampleTimeout:
                self._finish(
                    req,
                    ServeResponse(request_id=req.request_id, status="timeout"),
                    time.monotonic(),
                )
                continue
            live.append((req, sub))
        if not live:
            return len(batch)
        outs = self._compute(live)
        done = time.monotonic()
        for (req, sub), emb in zip(live, outs):
            self._finish(
                req,
                ServeResponse(
                    request_id=req.request_id,
                    status="ok",
                    embeddings=emb,
                    degraded=sub.degraded,
                    batch_requests=len(live),
                ),
                done,
            )
        self.stats.cache_hit_ratios = self.cache.stats.hit_ratios()
        self.stats.server_health = dict(self.system.server_health())
        return len(batch)

    def _compute(self, live: list) -> list[np.ndarray]:
        """One bucketed slice over the batch.  Every request's arrays are
        built independently and concatenated — segment ids only shift by a
        base offset and the padded slice is row-independent, so each
        request's output rows are bit-identical to a solo run."""
        engine, g = self.engine, self.system.graph
        selfs, nbrs, segs, ets, metas = [], [], [], [], []
        base = 0
        for req, sub in live:
            verts = req.unique
            hop = sub.hops[0]
            order = np.argsort(hop.src, kind="stable")
            src, dst = hop.src[order], hop.dst[order]
            starts = np.searchsorted(src, verts)
            counts = np.searchsorted(src, verts, side="right") - starts
            nbr_ids = csr_gather(dst, starts, counts)
            if self._needs_etype:
                if hop.eid is not None:
                    et_sorted = g.edge_types[hop.eid[order]].astype(np.int32)
                else:
                    et_sorted = np.zeros(src.shape[0], np.int32)
                ets.append(csr_gather(et_sorted, starts, counts))
            selfs.append(self.cache.read_rows(self.newid[verts]))
            nbrs.append(
                self.cache.read_rows(self.newid[nbr_ids])
                if nbr_ids.shape[0]
                else np.zeros((0, self.store.dim), self.store.dtype)
            )
            segs.append(np.repeat(np.arange(verts.shape[0]), counts) + base)
            metas.append((verts.shape[0], int(nbr_ids.shape[0])))
            base += verts.shape[0]
        h_self = np.concatenate(selfs)
        h_nbr = np.concatenate(nbrs)
        seg = np.concatenate(segs).astype(np.int64)
        et = np.concatenate(ets).astype(np.int32) if ets else None
        h_new = engine.run_layer_batch(self.layer, h_self, h_nbr, seg, et)
        self.stats.note_batch(
            h_self.shape[0],
            engine._vertex_bucket(h_self.shape[0]),
            seg.shape[0],
            engine._edge_bucket(seg.shape[0]),
        )
        outs, lo = [], 0
        for (req, _), (nv, _ne) in zip(live, metas):
            block = h_new[lo : lo + nv]
            lo += nv
            # unique-sorted rows back to the requested vertex order
            outs.append(block[np.searchsorted(req.unique, req.vertices)])
        return outs
