"""Online serving: ``GLISPSystem.server()`` (``GNNServer.submit`` / ``step``
/ ``response``) under open-loop Zipf traffic at the mix's fixed rate.

Set-up runs one layerwise pass (the layer-(K-1) store that serving reads),
builds the server and serves ``warmup_seconds`` of traffic from another
stream of the same seed, which fills the serving cache. The window
submits each request when it falls due, steps the server in between, and
after the last arrival steps it until every request is answered. Each
request is timed from when it was due. ``serve_p95_ms`` is the exact 95th
percentile over every request due in the window; a request rejected or
timed out counts as failed, and at no less than the deadline. Afterwards
a sample of the requests drawn from the seed before the window, with the
request of the most vertices, is compared with the reference where it
was answered. A traced run
adds the device trace of ``profile_s`` more seconds of the same traffic
after the window, with host spans (``submit``, ``step``, ``wait``: the
loop idle until the next arrival) that name the device's idle gaps.
"""
from __future__ import annotations

import time

import numpy as np

from glisp_bench.harness import inputs, program, stats
from glisp_bench.harness.core import Outcome
from glisp_bench.harness.passes import SampleLog, one_pass, workdir
from glisp_bench.harness.timers import Spans
from glisp_bench.harness.trace import Profile
from glisp_bench.harness.traffic import schedule
from glisp_bench.reference import layerwise
from glisp_bench.reference.samples import EdgeIndex, HopCheck

WAIT_S = 0.0005  # the longest the loop sleeps before it looks at the clock again


class Loop:
    """One open loop over a schedule: per request its latency (ms from
    due to answered) and status; for the requests in ``keep`` (indices of
    the schedule) also the embeddings answered and the sample log entry,
    so that the loop holds no more than the check reads."""

    def __init__(self, server, sched, log, spans, deadline_ms, keep=()):
        self.server, self.sched, self.log, self.spans = server, sched, log, spans
        n = len(sched)
        self.keep = set(keep)
        self.latency_ms = np.zeros(n)
        self.status = [None] * n
        self.embeddings: dict = {}
        self.entry: dict = {}
        self.late_s = np.zeros(n)
        self.deadline_ms = deadline_ms
        self.max_pending = 0

    def _answer(self, i, resp, now, t0) -> None:
        self.latency_ms[i] = (now - t0 - self.sched.due[i]) * 1e3
        self.status[i] = resp.status
        if resp.status == "ok":
            if i in self.keep:
                self.embeddings[i] = resp.embeddings
        elif self.deadline_ms is not None:
            self.latency_ms[i] = max(self.latency_ms[i], self.deadline_ms)

    def run(self) -> float:
        """Serves the schedule; returns its start on the host clock."""
        server, sched, spans = self.server, self.sched, self.spans
        n, i = len(sched), 0
        outstanding: dict = {}
        t0 = time.monotonic()
        while i < n or outstanding:
            now = time.monotonic()
            while i < n and t0 + sched.due[i] <= now:
                self.late_s[i] = now - t0 - sched.due[i]
                before = len(self.log.entries)
                self.log.on = i in self.keep
                with spans.span("submit"):
                    rid = server.submit(sched.vertices[i], now=t0 + sched.due[i])
                self.log.on = False
                if len(self.log.entries) > before:
                    self.entry[i] = before
                resp = server.response(rid)
                if resp is None:
                    outstanding[rid] = i
                else:
                    self._answer(i, resp, time.monotonic(), t0)
                i += 1
            self.max_pending = max(self.max_pending, len(outstanding))
            with spans.span("step"):
                answered = server.step(now=time.monotonic(), force=i >= n)
            if answered:
                done = time.monotonic()
                for rid in list(outstanding):
                    resp = server.response(rid)
                    if resp is not None:
                        self._answer(outstanding.pop(rid), resp, done, t0)
            elif i < n:
                with spans.span("wait"):
                    time.sleep(max(0.0, min(WAIT_S, t0 + sched.due[i] - time.monotonic())))
        return t0


def run(ctx) -> Outcome:
    import torch

    cfg, mix, dev = ctx.cfg, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arrays = inputs.make_graph(cfg)
    n = arrays["num_vertices"]
    system = program.build_system(cfg, arrays, ctx.seed)
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    model = program.make_model(cfg, weights, dev)
    fns = [model.embed_layer_fn(k) for k in range(cfg["num_layers"])]
    log = SampleLog(system.service)
    try:
        log.on = True
        one_pass(system, fns, cfg, workdir(ctx.cell.name), dev, sync)
        engine_requests = log.samples()
        log.entries.clear()
        server = system.server()
        deadline = cfg["serve_deadline_ms"]
        warm = Loop(server, schedule(mix, ctx.seed, mix["warmup_seconds"], n, stream=1), log,
                    Spans(), deadline)
        warm.run()
        log.entries.clear()
        before = server.stats.snapshot()
        rows0, padded0 = server.stats.batch_rows, server.stats.padded_rows
        spans = Spans()
        sched = schedule(mix, ctx.seed, ctx.seconds, n)
        loop = Loop(server, sched, log, spans, deadline,
                    keep=candidates(sched, ctx.seed, mix["check_candidates"]))
        t_setup = time.perf_counter() - ctx.t_process
        t0 = loop.run()
        window_s = time.monotonic() - t0
        sync()
        after = server.stats.snapshot()
        occupancy = ((server.stats.batch_rows - rows0) / (server.stats.padded_rows - padded0)
                     if server.stats.padded_rows > padded0 else None)
        profile = None
        if ctx.trace and cuda:
            # the device trace: a short stretch of the same traffic after the
            # window (starting and stopping the profiler takes seconds)
            prof = Profile()
            prof.start()
            Loop(server, schedule(mix, ctx.seed, mix["profile_s"], n, stream=2), log,
                 Spans(annotate=True), deadline).run()
            prof.stop()
            profile = prof.read()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        chosen = pick(loop, mix["check_requests"])
        checked = [(sched.vertices[i], loop.embeddings[i],
                    log.samples([log.entries[loop.entry[i]]])[0]) for i in chosen]
    finally:
        log.close()
    failed = sum(s != "ok" for s in loop.status)
    late = loop.late_s * 1e3
    ctx.log(f"serve generator lateness ms: p50 {np.median(late) if late.size else 0.0} "
            f"p99 {np.percentile(late, 99) if late.size else 0.0} "
            f"max {late.max() if late.size else 0.0} over {late.size} requests; "
            f"server counters before {before} after {after}")
    del system, model, fns, server
    if cuda:
        torch.cuda.empty_cache()
    numbers, control = check(ctx, arrays, weights, engine_requests, checked)
    record = {
        "kind": "serve", "window_s": window_s, "spans": dict(spans.seconds),
        "requests": len(loop.sched), "occupancy": occupancy,
        "cache_hit_ratios": dict(after["cache_hit_ratios"]), "profile": profile, "hw": ctx.hw,
    }
    return Outcome(
        e2e={"serve_p95_ms": stats.percentile(loop.latency_ms, 95) if len(loop.sched) else None,
             "setup_s": t_setup},
        attempted=len(loop.sched), failed=failed, numbers=numbers, record=record,
        memory_peak_bytes=int(peak), profile=profile, control=control)


def candidates(sched, seed: int, count: int) -> list:
    """The requests the check may compare, drawn from the seed before the
    window, with the request of the most vertices among them."""
    if not len(sched):
        return []
    rng = np.random.default_rng([int(seed), 2])
    chosen = set(rng.choice(len(sched), min(count, len(sched)), replace=False).tolist())
    chosen.add(max(range(len(sched)), key=lambda i: (np.unique(sched.vertices[i]).shape[0], -i)))
    return sorted(chosen)


def pick(loop, count: int) -> list:
    """The answered candidates the check compares: the largest one, and
    the first ``count`` others in the seed's order."""
    ok = [i for i in sorted(loop.keep) if loop.status[i] == "ok"]
    if not ok:
        return []
    largest = max(ok, key=lambda i: (np.unique(loop.sched.vertices[i]).shape[0], -i))
    return sorted({largest, *[i for i in ok if i != largest][:count]})


def check(ctx, arrays, weights, engine_requests, checked):
    """``embed_gap`` over the checked requests' embeddings, their samples'
    and the set-up pass's faults and fill; with ``ctx.control``, the
    control's ``embed_gap``."""
    cfg, K, n = ctx.cfg, ctx.cfg["num_layers"], arrays["num_vertices"]
    hc = HopCheck(EdgeIndex(arrays["src"], arrays["dst"], n))
    edges = layerwise.engine_edges(engine_requests, n, K, cfg["fanouts"], hc)
    served = HopCheck(hc.index)
    precisions = ["float32"] + (["tf32"] if ctx.control else [])
    prev = {p: layerwise.embed(cfg, arrays, weights, edges, ctx.device, K - 1, precision=p)
            for p in precisions}
    got, want, low = [], [], []
    for vertices, emb, (seeds, src, dst) in checked:
        served.hop(seeds, src, dst, cfg["fanouts"][K - 1])
        if not np.array_equal(seeds, np.unique(vertices)):
            served.fault()
        rows = {p: layerwise.final_rows(cfg, weights, prev[p], vertices, src, dst, p)
                for p in precisions}
        got.append(np.asarray(emb))
        want.append(rows["float32"].cpu())
        if ctx.control:
            low.append(rows["tf32"].cpu())
    if not checked:
        served.fault()
    import torch

    ref = torch.cat(want) if want else torch.zeros(0)
    numbers = {"embed_gap": layerwise.embed_gap(np.concatenate(got) if got else np.zeros(0), ref)
               if got else float("inf"),
               "sample_faults": hc.bad + served.bad,
               "sample_fill": min(hc.fill(), served.fill())}
    control = None
    if ctx.control:
        control = {"embed_gap": layerwise.embed_gap(torch.cat(low), ref)}
    return numbers, control
