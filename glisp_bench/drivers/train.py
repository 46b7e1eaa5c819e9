"""Sampled minibatch training: ``GLISPSystem.trainer`` fed by its
``BatchPipeline``, one ``GNNTrainer.train_step`` a batch, as fast as the
pipeline gives batches (a closed loop), epochs repeated through the window.

Set-up builds one trainer and drives it through the checked steps (the
steps the reference follows) and the warm-up steps, then hands the same
trainer and batch stream to the window. ``train_seeds_per_s`` counts
every seed whose step was issued in the window, over the window from its
first fetch to the device's end of the last step. A traced run keeps the
benchmark's host spans (``batch_wait``: the fetch of the next batch from
the pipeline; ``step``: the call of ``train_step``), every batch's real
rows (for ``mfu.train``), and the kernel calls and device trace of a
short stretch of ``profile_steps`` steps after the window (starting and
stopping the profiler takes seconds, which the window must not hold).
"""
from __future__ import annotations

import time
from unittest import mock

import numpy as np

from glisp_bench.harness import inputs, program, stats
from glisp_bench.harness.calls import KernelCalls
from glisp_bench.harness.core import Outcome
from glisp_bench.harness.timers import Spans
from glisp_bench.harness.trace import Profile
from glisp_bench.reference import gnn
from glisp_bench.reference.train_check import check_training

EPOCHS = 1 << 20  # the stream repeats the epochs until the window closes


def _by_leaf(tree: dict) -> dict:
    return {name: t.detach().clone() for name, t in gnn.leaves(tree)}


def _host(batch) -> dict:
    return {"feats": batch.feats.cpu().numpy(), "valid": batch.valid.cpu().numpy(),
            "seed_pos": batch.seed_pos.cpu().numpy().astype(np.int64),
            "layer_dst": [t.cpu().numpy() for t in batch.layer_dst],
            "layer_src": [t.cpu().numpy() for t in batch.layer_src]}


class BatchRows:
    """Every batch's real rows, counted on the host as the consumer moves
    it to the device (``GNNBatch.to``): valid vertices, valid edges per
    layer, seeds."""

    def __init__(self):
        self.rows: list = []
        self.on = False

    def patch(self):
        from repro_torch.models.gnn.batching import GNNBatch

        orig = GNNBatch.to

        def to(batch, device):
            if self.on:
                self.rows.append((int(batch.valid.sum()),
                                  [int((d >= 0).sum()) for d in batch.layer_dst],
                                  int(batch.seed_pos.shape[0])))
            return orig(batch, device)

        return mock.patch.object(GNNBatch, "to", to)


def run(ctx) -> Outcome:
    import torch

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    arrays = inputs.make_graph(cfg)
    system = program.build_system(cfg, arrays, ctx.seed)
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    model = program.make_model(cfg, weights, dev)
    ids = inputs.train_ids(cfg, ctx.seed)
    trainer = system.trainer(model, ids, opt=program.adamw(cfg))
    rows = BatchRows()
    spans = Spans()
    prof = Profile() if ctx.trace and cuda else None
    steps_done, seeds_done = 0, 0
    step_times: list = []  # (fetch s, step s) of each window step
    with rows.patch(), KernelCalls() as calls:
        stream = trainer.pipeline.batches(EPOCHS)
        try:
            checked = []
            for i in range(tr["checked_steps"]):
                seeds, batch = next(stream)
                loss = trainer.train_step(batch)
                checked.append((batch, loss))
                if i == 0:
                    mu1 = _by_leaf(trainer.opt_state["mu"])
            after = _by_leaf(trainer.params)
            for _ in range(tr["warmup_steps"]):
                seeds, batch = next(stream)
                trainer.train_step(batch)
            sync()
            rows.on = ctx.trace
            t0 = time.perf_counter()
            while True:
                ta = time.perf_counter()
                with spans.span("batch_wait"):
                    seeds, batch = next(stream)
                tb = time.perf_counter()
                with spans.span("step"):
                    trainer.train_step(batch)
                step_times.append((tb - ta, time.perf_counter() - tb))
                steps_done += 1
                seeds_done += int(seeds.shape[0])
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
            sync()
            window_s = time.perf_counter() - t0
            rows.on = False
            if prof is not None:
                # the device trace: a short stretch after the window
                prof.start()
                calls.on = True
                marks = Spans(annotate=True)
                for _ in range(tr["profile_steps"]):
                    with marks.span("batch_wait"):
                        seeds, batch = next(stream)
                    with marks.span("step"):
                        trainer.train_step(batch)
                calls.on = False
                prof.stop()
        finally:
            stream.close()
            trainer.pipeline.close()
        profile = prof.read() if prof is not None else None
        hw = ctx.hw
        bound = calls.bound_s(hw) if profile is not None else None
    setup_s = t0 - ctx.t_process
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [float(loss) for _, loss in checked]
    steps = [(_host(b), loss) for (b, _), loss in zip(checked, losses)]
    del trainer, model, system, checked, stream
    if cuda:
        torch.cuda.empty_cache()
    numbers = check_training(cfg, arrays, ids, weights, steps, mu1, after, dev,
                             control=ctx.control, witness=ctx.witness)
    control = numbers.pop("control", None)
    ctx.log(f"train check: worst leaves {numbers.pop('_worst')}, left out "
            f"{numbers.pop('_left_out')}; float32 reference {numbers.pop('_witness', None)}")
    fetch, step = np.array(step_times).T * 1e3
    ctx.log(f"train window {window_s:.3f} s, {steps_done} steps; fetch ms p50 {np.median(fetch):.2f}"
            f" p90 {np.percentile(fetch, 90):.2f} max {fetch.max():.2f} sum {fetch.sum():.1f};"
            f" step ms p50 {np.median(step):.2f} p90 {np.percentile(step, 90):.2f}"
            f" max {step.max():.2f} sum {step.sum():.1f}; first 8 (fetch, step) ms"
            f" {[(round(a, 1), round(b, 1)) for a, b in zip(fetch[:8], step[:8])]}")
    record = {
        "kind": "train", "window_s": window_s, "spans": dict(spans.seconds),
        "steps": steps_done, "seeds": seeds_done, "batch_rows": rows.rows,
        "model": cfg["model"], "dims": inputs.layer_dims(cfg), "heads": cfg["num_heads"],
        "classes": cfg["num_classes"], "hw": hw, "profile": profile, "kernel_bound_s": bound,
    }
    return Outcome(
        e2e={"train_seeds_per_s": stats.rate(seeds_done, window_s), "setup_s": setup_s},
        attempted=steps_done, failed=0, numbers=numbers, record=record,
        memory_peak_bytes=int(peak), profile=profile, control=control)
