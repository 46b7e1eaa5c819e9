"""The port's tracer (``repro_torch.tracing``) and the spans the batch
pipeline, sampling service, trainer, engine and storage open, on the CPU.

Nesting and self times, per-thread stacks, bounded memory, the profiler's
``span:`` ranges and the clock mapping, a forked producer's roots reaching
the consumer (and no profiler range opened in it), the engine's spans, the
clocks that read the tracer (``sample_time``, ``measured_round_seconds``,
``compute_time``), and outputs bitwise equal with a profiler on and off.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as torch_api  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core.sampling import SamplingSpec  # noqa: E402
from repro_torch.graph import power_law_graph  # noqa: E402
from repro_torch.models.gnn import GNNModel  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ENGINE_SPANS = {
    "engine.pass", "engine.layer", "engine.sample_wait", "engine.slice", "slice.copy_in",
    "slice.compute", "slice.result", "storage.cache_fill", "storage.cache_read",
    "storage.store_write", "storage.chunk_write", "storage.fsync", "storage.chunk_read",
    "storage.checksum", "sampling.round", "sampling.hop", "sampling.gather",
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def system():
    g = power_law_graph(1200, avg_degree=6, seed=5, feat_dim=16, num_classes=4)
    return torch_api.GLISPSystem.build(g, torch_api.GLISPConfig(num_parts=2, fanouts=(5, 3), seed=0))


def _model(kind="sage"):
    return GNNModel(kind, 16, hidden=16, num_layers=2, num_classes=4, device="cpu")


def _tree():
    with tracing.span("t.root"):
        time.sleep(0.002)
        with tracing.span("t.a"):
            time.sleep(0.003)
            with tracing.span("t.b"):
                time.sleep(0.004)
        for _ in range(3):
            with tracing.span("t.b"):
                time.sleep(0.001)
    return tracing.roots("t.root")[-1]


def test_self_times_and_children_make_the_root():
    root = _tree()
    assert root.pid == os.getpid()
    assert root.count == {"t.root": 1, "t.a": 1, "t.b": 4}
    assert abs(sum(root.self_ns.values()) - root.dur_ns) <= 0.01 * root.dur_ns
    end = root.start_ns + root.dur_ns
    assert [n for n, _, _ in root.intervals] == ["t.b", "t.a", "t.b", "t.b", "t.b"]
    assert all(root.start_ns <= a <= b <= end for _, a, b in root.intervals)
    # a's self time is its interval less b's inside it
    (_, a0, a1), (_, b0, b1) = root.intervals[1], root.intervals[0]
    assert a0 <= b0 <= b1 <= a1
    assert root.self_ns["t.a"] == (a1 - a0) - (b1 - b0)
    assert root.self_ns["t.a"] >= 3e6 and root.self_ns["t.b"] >= 7e6
    assert tracing.roots("t.a") == [] and tracing.roots("t.b") == []


def test_a_forced_root_is_its_parents_own_time():
    with tracing.span("t.outer") as outer:
        with tracing.span("t.inner", root=True) as inner:
            time.sleep(0.002)
        with tracing.span("t.child"):
            pass
    o, i = outer.summary, inner.summary
    assert set(o.self_ns) == {"t.outer", "t.child"} and set(i.self_ns) == {"t.inner"}
    assert o.self_ns["t.outer"] >= i.dur_ns
    assert tracing.roots("t.inner") == [i]


def test_a_dropped_root_keeps_no_summary():
    with tracing.span("t.none") as s:
        s.drop()
    assert s.summary is None and tracing.roots("t.none") == []


def test_two_threads_on_one_service_keep_their_own_stacks(system):
    """Two threads drive one ``SamplingService``: each thread's root holds
    its own spans only, and every round the service ran is in one root."""
    service = system.service
    spec = SamplingSpec(fanouts=(5, 3))
    rounds0, seconds0 = service.rounds, service.measured_round_seconds
    errors = []

    def client(t):
        try:
            for i in range(6):
                with tracing.span(f"t.client{t}"):
                    seeds = np.arange(40, dtype=np.int64) * 7 + 13 * i + t
                    service.submit(seeds, spec, key=(99, t, i)).result(timeout=60)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    roots = tracing.roots("t.client0") + tracing.roots("t.client1")
    assert len(roots) == 12
    for r in roots:
        assert sum(r.self_ns.values()) == r.dur_ns
        assert all(r.start_ns <= a <= b <= r.start_ns + r.dur_ns for _, a, b in r.intervals)
        assert set(r.self_ns) <= {r.name, "sampling.round", "sampling.hop", "sampling.gather"}
    rounds = [(a, b) for r in roots for n, a, b in r.intervals if n == "sampling.round"]
    assert len(rounds) == service.rounds - rounds0
    # the service's measured clock is the sum of its round spans
    assert sum(b - a for a, b in rounds) / 1e9 == pytest.approx(
        service.measured_round_seconds - seconds0, rel=1e-9, abs=1e-9)


def test_memory_stays_bounded_after_a_million_spans():
    for _ in range(2000):
        with tracing.span("t.many"):
            for _ in range(499):
                with tracing.span("t.leaf"):
                    pass
    kept = tracing.roots("t.many")
    assert len(kept) == tracing.KEEP
    assert all(r.count["t.leaf"] == 499 and len(r.intervals) == 499 for r in kept)
    with tracing.span("t.wide"):
        for _ in range(tracing.MAX_INTERVALS + 100):
            with tracing.span("t.leaf"):
                pass
    wide = tracing.roots("t.wide")[0]
    assert len(wide.intervals) == tracing.MAX_INTERVALS
    assert wide.count["t.leaf"] == tracing.MAX_INTERVALS + 100


def test_the_profiler_holds_each_span_as_a_nested_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("t.first"):  # the first range loads the profiler's ops
            pass
        root = _tree()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name.startswith("span:t.")
                     and e.name != "span:t.first"), key=lambda e: e.time_range.start)
    assert [e.name[5:] for e in events] == ["t.root", "t.a", "t.b", "t.b", "t.b", "t.b"]
    r, a, b = events[:3]
    assert r.time_range.start <= a.time_range.start <= b.time_range.start
    assert b.time_range.end <= a.time_range.end <= r.time_range.end
    assert all(r.time_range.start <= e.time_range.start and e.time_range.end
               <= r.time_range.end for e in events[3:])
    # profiler_us puts each span within 1 ms of its range
    spans = [("t.root", root.start_ns, root.start_ns + root.dur_ns)] + sorted(
        root.intervals, key=lambda iv: iv[1])
    for (name, a_ns, b_ns), e in zip(spans, events):
        assert e.name == "span:" + name
        assert abs(tracing.profiler_us(a_ns) - (e.time_range.start + start_ns / 1e3)) < 1000
        assert abs(tracing.profiler_us(b_ns) - (e.time_range.end + start_ns / 1e3)) < 1000


def test_no_range_without_a_profiler(monkeypatch):
    import torch.autograd.profiler as prof

    def fail(name):
        raise AssertionError(f"profiler range {name} opened with no profiler")

    monkeypatch.setattr(prof, "record_function", fail)
    _tree()


def _pipeline(system, workers, prefetch=2):
    pipe = system.loader(np.arange(0, 1200, 3), batch_size=64, prefetch=prefetch, device="cpu")
    pipe.workers = workers
    return pipe


def test_a_forked_producer_sends_its_roots_and_opens_no_range(system, monkeypatch):
    """Forked while a profiler records: the worker's ``pipeline.produce``
    roots reach the consumer with their sampling and batch spans, and the
    worker opens no profiler range (one would fail its run)."""
    import torch.autograd.profiler as prof

    parent = os.getpid()
    real = prof.record_function

    def only_here(name):
        if os.getpid() != parent:
            raise AssertionError(f"profiler range {name} opened in the forked producer")
        return real(name)

    monkeypatch.setattr(prof, "record_function", only_here)
    pipe = _pipeline(system, "process")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            got = [seeds for seeds, _ in pipe.batches(1)]
    finally:
        pipe.close()
    produced = tracing.roots("pipeline.produce")
    assert len(produced) == len(got) == 6
    # one pid per producer that made a batch, none the parent's
    pids = {r.pid for r in produced}
    assert len(pids) == min(pipe.producers, 6) and parent not in pids
    for r in produced:
        assert {"sampling.wait", "batch.assemble", "batch.features", "pipeline.put",
                "pipeline.write"} <= set(r.self_ns)
        assert sum(r.self_ns.values()) == r.dur_ns
    # a request in flight may be answered by an earlier batch's rounds
    assert {"sampling.submit", "sampling.round", "sampling.hop", "sampling.gather"} <= {
        n for r in produced for n in r.self_ns}
    # the consumer's own roots are ranges in the trace; the producer's are not
    names = {e.name for e in p.events() if e.name.startswith("span:")}
    assert {"span:pipeline.next", "span:pipeline.receive", "span:batch.to_device"} <= names
    assert "span:pipeline.produce" not in names
    assert len(tracing.roots("pipeline.next")) == 6
    assert pipe.sample_time == pytest.approx(
        sum(r.dur_ns - r.self_ns["pipeline.put"] for r in produced) / 1e9)


@pytest.mark.parametrize("cores", [(0,), (0, 1), (0, 1, 2)])
def test_each_forked_producer_sends_its_own_roots(system, cores):
    """W producers (W = len(worker_cores)): batch i's root comes from
    producer i mod W, each producer's roots from its own pid, and
    ``sample_time`` sums them all."""
    pipe = torch_api.BatchPipeline(system.backend, system.graph, np.arange(0, 1200, 3), (5, 3),
                                   2, batch_size=64, prefetch=2, worker_cores=cores,
                                   device="cpu")
    try:
        got = list(pipe.batches(1))
    finally:
        pipe.close()
    produced = tracing.roots("pipeline.produce")
    assert len(produced) == len(got) == 6
    pids = [r.pid for r in produced]
    assert len(set(pids)) == len(cores) and os.getpid() not in pids
    assert all(pids[i] == pids[i % len(cores)] for i in range(6))
    for r in produced:
        assert {"sampling.wait", "batch.assemble", "pipeline.put", "pipeline.write"} <= set(
            r.self_ns)
    assert pipe.sample_time == pytest.approx(
        sum(r.dur_ns - r.self_ns["pipeline.put"] for r in produced) / 1e9)


@pytest.mark.parametrize("workers,prefetch", [("thread", 2), ("thread", 0)])
def test_in_process_producers_keep_their_roots(system, workers, prefetch):
    pipe = _pipeline(system, workers, prefetch)
    got = list(pipe.batches(1))
    produced = tracing.roots("pipeline.produce")
    assert len(produced) == len(got) == 6 and {r.pid for r in produced} == {os.getpid()}
    assert all({"sampling.wait", "batch.assemble"} <= set(r.self_ns) for r in produced)
    assert "pipeline.put" not in produced[0].self_ns
    assert pipe.sample_time == pytest.approx(sum(r.dur_ns for r in produced) / 1e9)
    assert pipe.sample_time > 0


def test_the_trainers_log_reads_the_spans(system):
    tr = system.trainer(_model(), np.arange(0, 1200, 3), batch_size=64, prefetch=0)
    log = tr.train(max_steps=3, log_every=1)
    compute = tracing.roots("trainer.compute")
    assert len(compute) == 3
    assert log.compute_time == pytest.approx(sum(r.dur_ns for r in compute) / 1e9)
    assert all({"trainer.step", "trainer.forward", "trainer.backward", "trainer.update"}
               <= set(r.self_ns) for r in compute)
    assert log.sample_time == tr.pipeline.sample_time > 0


def test_an_engine_pass_carries_every_engine_and_storage_span(system, tmp_path):
    model = _model("gat")
    fns = [model.embed_layer_fn(k) for k in range(2)]
    system.infer_layerwise(fns, str(tmp_path / "run"), out_dims=[16, 16], batch_size=256,
                           device="cpu")
    (root,) = tracing.roots("engine.pass")
    assert ENGINE_SPANS <= set(root.self_ns), ENGINE_SPANS - set(root.self_ns)
    assert root.count["engine.layer"] == 2 and sum(root.self_ns.values()) == root.dur_ns
    assert root.count["storage.fsync"] == root.count["storage.chunk_write"]


def _run_both(fn):
    plain = fn()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = fn()
    assert any(e.name.startswith("span:") for e in prof.events())
    return plain, traced


def test_batches_and_the_final_store_are_bitwise_equal_under_a_profiler(system, tmp_path):
    def stream():
        pipe = _pipeline(system, "thread")
        return [(s, b) for s, b in pipe.batches(1)]

    plain, traced = _run_both(stream)
    assert len(plain) == len(traced) == 6
    for (sa, a), (sb, b) in zip(plain, traced):
        assert np.array_equal(sa, sb)
        for name, va in vars(a).items():
            vb = getattr(b, name)
            for x, y in zip(va if isinstance(va, list) else [va],
                            vb if isinstance(vb, list) else [vb]):
                assert torch.equal(x, y), name

    model = _model("gat")
    fns = [model.embed_layer_fn(k) for k in range(2)]
    runs = iter(("plain", "traced"))

    def final_store():
        res = system.infer_layerwise(fns, str(tmp_path / next(runs)), out_dims=[16, 16],
                                     batch_size=256, device="cpu")
        return res.final_store.read_rows(res.newid)

    plain, traced = _run_both(final_store)
    assert plain.shape == (1200, 16) and np.array_equal(plain, traced)


def test_trainer_steps_are_bitwise_equal_under_a_profiler(system):
    def losses():
        tr = system.trainer(_model(), np.arange(0, 1200, 3), batch_size=64, prefetch=0)
        out = tr.train(max_steps=3, log_every=1).losses
        return out, [p.detach().clone() for p in optim.tree_leaves(tr.params)]

    (la, pa), (lb, pb) = _run_both(losses)
    assert la == lb and all(torch.equal(a, b) for a, b in zip(pa, pb))
