"""The port's distributed sampling tier against the JAX package, on the CPU.

``repro_torch.dist`` is a copy of ``repro.dist``: its frames must be byte
for byte the reference's (the format is versioned), each package must
decode the other's, and forked workers (pipes or a socketpair) must answer
bit for bit as the JAX package's in-process system. Every wait on a worker
is bounded (``dist_dispatch_timeout``, ``ticket.result(timeout=)``,
``close(timeout=)``), so no test can hang the suite.
"""
import multiprocessing as mp
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro.dist.transport as jax_wire  # noqa: E402
import repro_torch.api as torch_api  # noqa: E402
import repro_torch.dist.transport as wire  # noqa: E402
from repro.core.sampling.service import SampleRequest as JaxRequest  # noqa: E402
from repro.core.sampling.service import SamplingSpec as JaxSpec  # noqa: E402
from repro_torch.core.faults import FaultPlan, FaultSpec, RetryPolicy  # noqa: E402
from repro_torch.core.sampling.service import SampleRequest, SamplingSpec  # noqa: E402
from repro_torch.graph import power_law_graph  # noqa: E402

pytestmark = pytest.mark.skipif(os.name != "posix", reason="dist workers fork (POSIX only)")

# the conftest's small_graph, drawn by the port's copy of the generator
GRAPH = dict(avg_degree=8, seed=7, feat_dim=16, num_classes=4)
BASE = dict(num_parts=2, fanouts=(4, 3), batch_size=32, seed=5, dist_dispatch_timeout=30.0)


@pytest.fixture(scope="module")
def graph():
    return power_law_graph(2000, **GRAPH)


@pytest.fixture(scope="module")
def jax_local(small_graph):
    return jax_api.GLISPSystem.build(small_graph, jax_api.GLISPConfig(**BASE))


def _system(graph, **over):
    return torch_api.GLISPSystem.build(graph, torch_api.GLISPConfig(**dict(BASE, **over)))


def _sample(system, seeds, key, **spec):
    spec = SamplingSpec(**dict(dict(fanouts=(4, 3)), **spec))
    return system.backend.submit(SampleRequest(seeds=seeds, spec=spec, key=key)).result(
        timeout=30.0
    )


def _jax_sample(system, seeds, key, **spec):
    spec = JaxSpec(**dict(dict(fanouts=(4, 3)), **spec))
    return system.backend.submit(JaxRequest(seeds=seeds, spec=spec, key=key)).result(timeout=30.0)


def _assert_same_sub(a, b):
    np.testing.assert_array_equal(a.seeds, b.seeds)
    assert (a.degraded, a.lost_dispatches) == (b.degraded, b.lost_dispatches)
    assert len(a.hops) == len(b.hops)
    for ha, hb in zip(a.hops, b.hops):
        for name in ("src", "dst", "eid", "scores"):
            x, y = getattr(ha, name, None), getattr(hb, name, None)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), name


def _no_worker_left():
    return [p for p in mp.active_children() if p.is_alive()] == []


# ---------------------------------------------------------------------------
# the wire format: byte for byte the reference's
# ---------------------------------------------------------------------------


def _messages(pkg):
    state = {
        "replicas": {"server.1.0": {"requests": 3, "work_units": 1.5}},
        "breakers": [{"consecutive_failures": 0, "opens": 1, "cooldown_left": 2,
                      "half_open": False}],
        "injector": {"invocations": {"server.1.0": 4}, "failures": {}, "burst": {}},
    }
    rng = np.random.default_rng(3)
    return [
        pkg.SampleDispatch(key=(2**64 - 3, 7), hop=2, part=1, chunk=3,
                           seeds=rng.integers(0, 10**6, 37).astype(np.int64), fanout=15,
                           direction="out", weighted=True, replace=False),
        pkg.SampleDispatch(key=(0, 0), hop=0, part=0, chunk=0, seeds=np.zeros(0, np.int64),
                           fanout=1, direction="in", weighted=False, replace=True),
        pkg.DispatchResult(part=1, chunk=3, src=rng.integers(0, 99, 20).astype(np.int64),
                           dst=rng.integers(0, 99, 20).astype(np.int64),
                           eid=rng.integers(0, 999, 20).astype(np.int64),
                           scores=rng.random(20).astype(np.float32), retries=2, failovers=1,
                           wall_ms=0.125, state=state),
        pkg.DispatchResult(part=0, chunk=0, lost=True, state={}),
        pkg.StatsRequest(),
        pkg.StatsResponse(part=3, replicas={"server.3.0": {"requests": 7}}),
        pkg.HealthRequest(),
        pkg.HealthResponse(part=0, health={"server.0.0": "up"}),
        pkg.ResetStatsRequest(),
        pkg.ResetStatsAck(part=2),
        pkg.ShutdownRequest(),
        pkg.ShutdownAck(part=1),
    ]


@pytest.mark.parametrize("i", range(12))
def test_frames_are_the_references_byte_for_byte(i):
    ours, theirs = _messages(wire)[i], _messages(jax_wire)[i]
    frame = wire.encode_frame(ours)
    assert frame == jax_wire.encode_frame(theirs)
    # each package decodes the other's frame
    back = wire.decode_frame(jax_wire.encode_frame(theirs))
    assert type(back) is type(ours) and wire.messages_equal(back, ours)
    back = jax_wire.decode_frame(frame)
    assert type(back) is type(theirs) and jax_wire.messages_equal(back, theirs)


def test_message_registry_and_version_are_the_references():
    assert wire.PROTOCOL_VERSION == jax_wire.PROTOCOL_VERSION == 1
    assert wire.MAGIC == jax_wire.MAGIC == b"GLSP"
    assert {k: v.__name__ for k, v in wire.MESSAGE_TYPES.items()} == {
        k: v.__name__ for k, v in jax_wire.MESSAGE_TYPES.items()
    }
    covered = {type(m).__name__ for m in _messages(wire)}
    assert covered == {v.__name__ for v in wire.MESSAGE_TYPES.values()}


def test_version_mismatch_rejected():
    frame = bytearray(wire.encode_frame(wire.StatsRequest()))
    frame[4:6] = (wire.PROTOCOL_VERSION + 1).to_bytes(2, "little")
    with pytest.raises(wire.VersionMismatch):
        wire.decode_frame(bytes(frame))


def test_malformed_frames_rejected():
    frame = wire.encode_frame(
        wire.DispatchResult(part=0, chunk=0, src=np.arange(5, dtype=np.int64))
    )
    with pytest.raises(wire.TruncatedFrame):
        wire.decode_frame(frame[:8])  # inside the header
    with pytest.raises(wire.TruncatedFrame):
        wire.decode_frame(frame[:-3])  # payload shorter than the header claims
    with pytest.raises(wire.ProtocolError):
        wire.decode_frame(b"NOPE" + frame[4:])  # bad magic
    bad_type = bytearray(frame)
    bad_type[6:8] = (999).to_bytes(2, "little")
    with pytest.raises(wire.ProtocolError):
        wire.decode_frame(bytes(bad_type))


@pytest.mark.parametrize("kind", ["mp", "socket"])
def test_channel_roundtrip_and_close(kind):
    a, b = wire.channel_pair(kind)
    msg = _messages(wire)[0]
    a.send(msg)
    assert wire.messages_equal(b.recv(), msg)
    b.send(wire.ShutdownAck(part=0))
    assert a.poll(1.0)
    assert type(a.recv()) is wire.ShutdownAck
    a.close()
    with pytest.raises(wire.ChannelClosed):
        b.recv()
    b.close()


# ---------------------------------------------------------------------------
# forked workers answer as the JAX package's in-process system
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["mp", "socket"])
def test_remote_systems_answer_as_the_jax_in_process_system(graph, jax_local, transport):
    remote = _system(graph, dist_transport=transport)
    try:
        for i in range(4):
            seeds = np.arange(10 + 5 * i, dtype=np.int64) * 13 % 2000
            _assert_same_sub(_jax_sample(jax_local, seeds, (77, i)),
                             _sample(remote, seeds, (77, i)))
        # weighted sampling threads scores through the wire too
        seeds = np.arange(20, dtype=np.int64)
        _assert_same_sub(_jax_sample(jax_local, seeds, (78, 0), weighted=True),
                         _sample(remote, seeds, (78, 0), weighted=True))
        # the facade's blocking call over the pool
        a = jax_local.sample(seeds, (4, 3), key=(79, 0))
        _assert_same_sub(a, remote.sample(seeds, (4, 3), key=(79, 0)))
    finally:
        remote.close()
    assert _no_worker_left()


def test_workloads_and_health_equal_the_jax_remote_systems(small_graph, graph):
    ref = jax_api.GLISPSystem.build(
        small_graph, jax_api.GLISPConfig(**dict(BASE, dist_transport="mp"))
    )
    remote = _system(graph, dist_transport="mp")
    try:
        seeds = np.arange(30, dtype=np.int64)
        _assert_same_sub(_jax_sample(ref, seeds, (1, 0)), _sample(remote, seeds, (1, 0)))
        assert np.array_equal(remote.server_workloads(), ref.server_workloads())
        assert remote.server_health() == ref.server_health()
        assert remote.server_health()["worker.1"] == "up"
        sr, sj = remote.backend.stats(), ref.backend.stats()
        assert (sr.requests, sr.work_units, sr.modeled_total_work) == (
            sj.requests, sj.work_units, sj.modeled_total_work)
        remote.reset_stats()
        assert remote.backend.stats().requests == 0
    finally:
        remote.close()
        ref.close()


def test_fault_plans_give_the_jax_answers(graph, small_graph):
    kw = dict(
        server_replicas=2,
        fault_plan=FaultPlan(seed=13, sites=(("server.0.0", FaultSpec(p=0.4)),)),
        retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.0),
    )
    from repro.core.faults import FaultPlan as JPlan, FaultSpec as JSpec, RetryPolicy as JRetry

    jkw = dict(
        server_replicas=2,
        fault_plan=JPlan(seed=13, sites=(("server.0.0", JSpec(p=0.4)),)),
        retry_policy=JRetry(max_attempts=2, base_delay_s=0.0),
    )
    local = jax_api.GLISPSystem.build(small_graph, jax_api.GLISPConfig(**dict(BASE, **jkw)))
    remote = _system(graph, dist_transport="socket", **kw)
    try:
        for i in range(4):
            seeds = np.arange(25, dtype=np.int64) + 11 * i
            _assert_same_sub(_jax_sample(local, seeds, (9, i)), _sample(remote, seeds, (9, i)))
        sl, sr = local.backend.stats(), remote.backend.stats()
        assert (sr.retries, sr.failovers, sr.degraded) == (sl.retries, sl.failovers, sl.degraded)
        assert sr.retries > 0  # the plan injected faults
    finally:
        remote.close()


def test_killed_worker_respawns_deterministically(graph, jax_local):
    remote = _system(graph, dist_transport="mp")
    pool = remote.backend.service.dispatcher
    try:
        for i in range(3):
            seeds = np.arange(20, dtype=np.int64) + i
            _assert_same_sub(_jax_sample(jax_local, seeds, (4, i)), _sample(remote, seeds, (4, i)))
        victim = pool._workers[1].proc
        victim.kill()
        victim.join(timeout=5.0)
        # later requests respawn the worker from its last snapshot and keep
        # answering bit for bit
        for i in range(3, 6):
            seeds = np.arange(20, dtype=np.int64) + i
            _assert_same_sub(_jax_sample(jax_local, seeds, (4, i)), _sample(remote, seeds, (4, i)))
        assert pool.respawn_count == 1
    finally:
        remote.close()
    assert _no_worker_left()


def test_exhausted_respawn_budget_degrades(graph):
    remote = _system(graph, dist_transport="mp", worker_respawns=0)
    try:
        victim = remote.backend.service.dispatcher._workers[0].proc
        victim.kill()
        victim.join(timeout=5.0)
        sub = _sample(remote, np.arange(12, dtype=np.int64), (2, 0))
        assert sub.degraded and sub.lost_dispatches > 0
        assert remote.server_health()["worker.0"] == "down"
    finally:
        remote.close()


@pytest.mark.parametrize("transport", ["mp", "socket"])
def test_close_is_idempotent_and_leaves_no_child(graph, transport):
    with _system(graph, dist_transport=transport) as remote:
        procs = [w.proc for w in remote.backend.service.dispatcher._workers]
        assert len(procs) == 2 and all(p.is_alive() for p in procs)
        _sample(remote, np.arange(8, dtype=np.int64), (5, 0))
        remote.close(timeout=2.0)
        assert not any(p.is_alive() for p in procs)
        remote.close(timeout=2.0)  # a no-op
    assert _no_worker_left()
    with pytest.raises(RuntimeError, match="closed"):
        remote.backend.service.dispatcher.dispatch(0, 0, np.arange(2), (0, 0), 0,
                                                   SamplingSpec(fanouts=(2,)))


def test_pipeline_rejects_process_workers_with_remote_backend(graph):
    remote = _system(graph, dist_transport="mp")
    try:
        with pytest.raises(ValueError, match="process"):
            torch_api.BatchPipeline(remote.backend, remote.graph, np.arange(64), [4, 3], 2,
                                    workers="process", device="cpu")
        # auto falls back to a thread producer
        pipe = torch_api.BatchPipeline(remote.backend, remote.graph, np.arange(64), [4, 3], 2,
                                       batch_size=32, workers="auto", prefetch=1, device="cpu")
        assert pipe.workers == "thread"
        assert sum(1 for _ in pipe.batches(1)) == 2
    finally:
        remote.close()
