"""Offline layerwise inference: ``GLISPSystem.infer_layerwise`` over every
vertex, full passes back to back.

Set-up runs one pass, which warms every shape bucket. The window runs
passes until ``--seconds`` have passed, finishing the pass under way;
each recomputes every layer from the features (the engine writes each
layer's store anew). ``infer_vertices_per_s`` is the vertices whose final
layer the timed passes wrote, over the time from the first timed pass's
start to the last one's end. The last timed pass's final store is
compared with the reference over every vertex, on the one-hop samples
that pass drew. A traced run keeps the engine's stages as host spans
(``timers.host_timers``), the slices' real rows and edges (for
``mfu.infer``), and the kernel calls and device trace of one more pass
after the window; the check reads the last timed pass's store before it
(the extra pass writes the same rows again).
"""
from __future__ import annotations

import time
from contextlib import nullcontext

from glisp_bench.harness import inputs, program, stats
from glisp_bench.harness.calls import KernelCalls
from glisp_bench.harness.core import Outcome
from glisp_bench.harness.passes import SampleLog, SliceRows, one_pass, workdir
from glisp_bench.harness.timers import Spans, host_timers
from glisp_bench.harness.trace import Profile
from glisp_bench.reference import layerwise
from glisp_bench.reference.samples import EdgeIndex, HopCheck


def run(ctx) -> Outcome:
    import torch

    cfg, dev = ctx.cfg, ctx.device
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arrays = inputs.make_graph(cfg)
    system = program.build_system(cfg, arrays, ctx.seed)
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    model = program.make_model(cfg, weights, dev)
    fns = [model.embed_layer_fn(k) for k in range(cfg["num_layers"])]
    wd = workdir(ctx.cell.name)
    log = SampleLog(system.service)
    spans = Spans()
    slices = SliceRows()
    prof = Profile() if ctx.trace and cuda else None
    passes = 0
    try:
        with slices.patch(), KernelCalls() as calls:
            one_pass(system, fns, cfg, wd, dev, sync)
            with host_timers(spans) if ctx.trace else nullcontext():
                slices.on = ctx.trace
                t0 = time.perf_counter()
                while True:
                    log.entries.clear()
                    log.on = True
                    res = one_pass(system, fns, cfg, wd, dev, sync)
                    log.on = False
                    passes += 1
                    if time.perf_counter() - t0 >= ctx.seconds:
                        break
                window_s = time.perf_counter() - t0
                slices.on = False
            final = res.final_store.read_rows(res.newid)
            requests = log.samples()
            if prof is not None:
                # the device trace: one more pass after the window (starting
                # and stopping the profiler takes seconds)
                prof.start()
                calls.on = True
                with host_timers(Spans(annotate=True)):
                    one_pass(system, fns, cfg, wd, dev, sync)
                calls.on = False
                prof.stop()
            profile = prof.read() if prof is not None else None
            bound = calls.bound_s(ctx.hw) if profile is not None else None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        log.close()
    n = arrays["num_vertices"]
    del system, model, fns, res, log
    if cuda:
        torch.cuda.empty_cache()
    numbers, control = check(ctx, arrays, weights, requests, final)
    record = {
        "kind": "infer", "window_s": window_s, "spans": dict(spans.seconds), "passes": passes,
        "slice_rows": slices.rows, "model": cfg["model"], "dims": inputs.layer_dims(cfg),
        "heads": cfg["num_heads"], "hw": ctx.hw, "profile": profile, "kernel_bound_s": bound,
    }
    return Outcome(
        e2e={"infer_vertices_per_s": stats.rate(passes * n, window_s),
             "setup_s": t0 - ctx.t_process},
        attempted=passes * n, failed=0, numbers=numbers, record=record,
        memory_peak_bytes=int(peak), profile=profile, control=control)


def check(ctx, arrays, weights, requests, final):
    """``embed_gap`` of every vertex's final-layer row, and the samples'
    faults and fill; with ``ctx.control``, the control's ``embed_gap``."""
    cfg, K, n = ctx.cfg, ctx.cfg["num_layers"], arrays["num_vertices"]
    hc = HopCheck(EdgeIndex(arrays["src"], arrays["dst"], n))
    edges = layerwise.engine_edges(requests, n, K, cfg["fanouts"], hc)
    ref = layerwise.embed(cfg, arrays, weights, edges, ctx.device, K)
    numbers = {"embed_gap": layerwise.embed_gap(final, ref.cpu()),
               "sample_faults": hc.bad, "sample_fill": hc.fill()}
    control = None
    if ctx.control:
        low = layerwise.embed(cfg, arrays, weights, edges, ctx.device, K, precision="tf32")
        control = {"embed_gap": layerwise.embed_gap(low.cpu(), ref.cpu())}
    return numbers, control
