"""The port's training slice against the JAX package, on the CPU.

Batching, the model's loss and gradients, the optimizer, the trainer and
its checkpoints, with the same numpy inputs on both sides and the JAX model
on its jnp path (``use_kernel=False``, what the JAX trainer differentiates).
Model: 2 layers, hidden 32, on the ``small_graph`` fixture.

Tolerances: loss and gradients rtol 1e-4 / atol 1e-6 (two frameworks'
matmuls, and the port sums each row's edges in CSR order where the JAX
oracle sums in edge order); one AdamW step rtol 1e-6 (the same float32
formula); a loss trajectory rtol 1e-4. Batch fields, checkpoints and
resumed runs are compared bit for bit.
"""
import mmap
import multiprocessing as mp
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro_torch.api as torch_api  # noqa: E402
from repro.core.sampling import GatherApplyClient as JaxClient  # noqa: E402
from repro.core.sampling import SamplingServer as JaxServer  # noqa: E402
from repro.core.sampling import VertexRouter as JaxRouter  # noqa: E402
from repro.graph import power_law_graph as jax_graph  # noqa: E402
from repro.kernels.fused_gnn import gather_spmm_ragged_pallas  # noqa: E402
from repro.kernels.ref import gather_spmm_ref as jax_gather_ref  # noqa: E402
from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
from repro.models.gnn.batching import subgraph_to_batch as jax_batch  # noqa: E402
from repro.train import GNNTrainer as JaxTrainer  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro_torch.core.sampling import GatherApplyClient, SamplingServer, VertexRouter  # noqa: E402
from repro_torch.graph import build_partitions  # noqa: E402
from repro_torch.graph import power_law_graph as torch_graph  # noqa: E402
from repro_torch.kernels import fused_gnn, ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    gat_softmax_aggregate_backward_ref,
    gat_softmax_aggregate_ref,
    gather_spmm_ragged_backward_ref,
    gather_spmm_ref,
)
from repro_torch.models.gnn import GNNModel, load_jax_params  # noqa: E402
from repro_torch.api.pipeline import _views, write_batch  # noqa: E402
from repro_torch.models.gnn.batching import (  # noqa: E402
    GNNBatch,
    largest_batch,
    sorted_order,
    subgraph_to_batch,
)
from repro_torch.train import DataParallelGNNTrainer, GNNTrainer, optim  # noqa: E402
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

HIDDEN, LAYERS, HEADS, FANOUTS = 32, 2, 2, [5, 3]
KINDS = ["gcn", "sage", "gat", "hgt"]


def _jax_client(g, partitioned):
    ep, parts = partitioned
    return JaxClient([JaxServer(p, seed=0) for p in parts], JaxRouter(g, ep, 4), seed=0)


def _torch_client(g, partitioned):
    """The port's client over the same partitions: the same samples."""
    ep, _ = partitioned
    parts = build_partitions(g, ep, 4)
    return GatherApplyClient([SamplingServer(p, seed=0) for p in parts], VertexRouter(g, ep, 4), seed=0)


@pytest.fixture(scope="module")
def sub(small_graph, sampling_client):
    return sampling_client.sample_khop(np.arange(0, 2000, 29)[:64], FANOUTS)


def _pair(kind, g, seed=0):
    jm = JaxGNN(kind, g.vertex_feats.shape[1], hidden=HIDDEN, num_layers=LAYERS,
                num_classes=4, num_heads=HEADS)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GNNModel(kind, g.vertex_feats.shape[1], hidden=HIDDEN, num_layers=LAYERS,
                  num_classes=4, num_heads=HEADS, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_batch_fields_are_bit_equal_and_orders_sort(small_graph, sub):
    g = small_graph
    jb = jax_batch(sub, g.vertex_feats, g.labels, LAYERS, edge_types=g.edge_types)
    tb = subgraph_to_batch(sub, g.vertex_feats, g.labels, LAYERS, edge_types=g.edge_types)
    for name in ("feats", "valid", "seed_pos", "labels"):
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("layer_dst", "layer_src", "layer_etype", "layer_cnt"):
        for a, b in zip(getattr(jb, name), getattr(tb, name)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for k in range(LAYERS):
        dst, src = tb.layer_dst[k], tb.layer_src[k]
        by_dst, by_src = tb.layer_dst_order[k], tb.layer_src_order[k]
        e = dst.shape[0]
        assert by_dst.dtype == by_src.dtype == np.int32
        assert np.array_equal(np.sort(by_dst), np.arange(e))
        assert np.array_equal(np.sort(by_src), np.arange(e))
        big = np.iinfo(np.int32).max
        d_key = np.where(dst < 0, big, dst)[by_dst]
        assert np.all(np.diff(d_key) >= 0)
        # stable: ties keep their edge order
        ties = np.diff(d_key) == 0
        assert np.all(np.diff(by_dst)[ties] > 0)
        s_sorted = src[by_dst]
        s_key = np.where(s_sorted < 0, big, s_sorted)[by_src]
        assert np.all(np.diff(s_key) >= 0)
        assert np.all(np.diff(by_src)[np.diff(s_key) == 0] > 0)
        # padding last in both orders
        valid = int((dst >= 0).sum())
        assert np.all(dst[by_dst][:valid] >= 0) and np.all(s_sorted[by_src][:valid] >= 0)
    moved = tb.to("cpu")
    assert isinstance(moved, GNNBatch) and moved.layer_src_order[1].dtype == torch.int32
    assert torch.equal(moved.feats, torch.from_numpy(tb.feats))


def test_sort_order_on_tensors_matches_the_host_order():
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 9, 200).astype(np.int32)
    got = fused_gnn.sort_order(torch.as_tensor(idx)).numpy()
    assert np.array_equal(got, sorted_order(idx))


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_every_gradient_match_jax(kind, small_graph, sub):
    g = small_graph
    jm, params, tm = _pair(kind, g, seed=1)
    jb = jax.tree.map(jnp.asarray, jax_batch(sub, g.vertex_feats, g.labels, LAYERS,
                                             edge_types=g.edge_types))
    loss_j, grads_j = jax.value_and_grad(jm.loss)(params, jb)
    tb = subgraph_to_batch(sub, g.vertex_feats, g.labels, LAYERS, edge_types=g.edge_types)
    loss_t = tm.loss(tb.to("cpu"))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tm.out.grad.numpy(), np.asarray(grads_j["out"]), rtol=1e-4, atol=1e-6)
    for k in range(LAYERS):
        for name, p in tm.layers[k].items():
            np.testing.assert_allclose(
                p.grad.numpy(), np.asarray(grads_j["layers"][k][name]), rtol=1e-4, atol=1e-6,
                err_msg=f"layer {k} {name}",
            )


def _tree(rng, shapes):
    return {"layers": [{n: rng.standard_normal(s).astype(np.float32) for n, s in layer.items()}
                       for layer in shapes], "out": rng.standard_normal((8, 3)).astype(np.float32)}


@pytest.mark.parametrize("step", [0, 5, 150])
def test_one_adamw_step_matches_jax(step):
    rng = np.random.default_rng(step)
    shapes = [{"w": (6, 8), "b": (8,)}, {"w": (16, 8), "b": (8,)}]
    params, grads = _tree(rng, shapes), _tree(rng, shapes)
    mu, nu = _tree(rng, shapes), jax.tree.map(np.abs, _tree(rng, shapes))
    cfg = dict(lr=1e-3, weight_decay=1e-4, grad_clip=1.0, warmup_steps=100)
    jstate = {"mu": mu, "nu": nu, "step": jnp.asarray(step, jnp.int32)}
    jp, js, jinfo = jax_optim.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, jstate), jax_optim.AdamWConfig(**cfg),
    )
    t = lambda tree: optim.tree_map(torch.as_tensor, tree)  # noqa: E731
    tstate = {"mu": t(mu), "nu": t(nu), "step": torch.tensor(step, dtype=torch.int32)}
    tp, ts, tinfo = optim.adamw_update(t(params), t(grads), tstate, optim.AdamWConfig(**cfg))
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == step + 1
    np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]), rtol=1e-6)
    for a, b in zip(optim.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for key in ("mu", "nu"):
        for a, b in zip(optim.tree_leaves(ts[key]), jax.tree.leaves(js[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_sgd_and_clipping_match_jax():
    rng = np.random.default_rng(3)
    params, grads = _tree(rng, [{"w": (4, 4)}]), _tree(rng, [{"w": (4, 4)}])
    t = lambda tree: optim.tree_map(torch.as_tensor, tree)  # noqa: E731
    jp, jv = jax_optim.sgd_update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads), None)
    tp, tv = optim.sgd_update(t(params), t(grads), None)
    for a, b in zip(optim.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    jc, jn = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 0.5)
    tc, tn = optim.clip_by_global_norm(t(grads), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(optim.tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _trainers(kind, g, partitioned, tmp_path=None):
    """The JAX trainer and the port's, on clients that draw the same
    samples, with the JAX trainer's initial parameters loaded into the
    port's model."""
    ids = np.arange(0, g.num_vertices, 3)
    jm = JaxGNN(kind, g.vertex_feats.shape[1], hidden=HIDDEN, num_layers=LAYERS,
                num_classes=4, num_heads=HEADS)
    kw = dict(batch_size=64, prefetch=0)
    jt = JaxTrainer(jm, _jax_client(g, partitioned), g, FANOUTS, ids,
                    checkpoint_dir=None if tmp_path is None else str(tmp_path / "jax"), **kw)
    tm = GNNModel(kind, g.vertex_feats.shape[1], hidden=HIDDEN, num_layers=LAYERS,
                  num_classes=4, num_heads=HEADS, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jt.params))
    tt = GNNTrainer(tm, _torch_client(g, partitioned), g, FANOUTS, ids,
                    checkpoint_dir=None if tmp_path is None else str(tmp_path / "torch"), **kw)
    return jt, tt


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_trainer_loss_trajectory_matches_jax(kind, small_graph, partitioned):
    jt, tt = _trainers(kind, small_graph, partitioned)
    fused_gnn.reset_launches()
    lj = jt.train(max_steps=5, log_every=1).losses
    lt = tt.train(max_steps=5, log_every=1).losses
    assert len(lj) == len(lt) == 5
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert set(fused_gnn.LAUNCHES.values()) == {0}  # CPU tensors launch nothing


def _leaves_np(tree):
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)
            for x in optim.tree_leaves(tree)]


def test_checkpoints_load_across_packages(small_graph, partitioned, tmp_path):
    jt, tt = _trainers("sage", small_graph, partitioned, tmp_path)
    jt.train(max_steps=2)
    tt.train(max_steps=3)
    jpath, tpath = jt.save(step=2), tt.save(step=3)
    # a JAX checkpoint into the port
    _, t2 = _trainers("sage", small_graph, partitioned, tmp_path)
    assert t2.resume(jpath) == 2
    state_j = {"params": jt.params, "opt": jt.opt_state}
    state_t = {"params": t2.params, "opt": t2.opt_state}
    for a, b in zip(_leaves_np(state_t), [np.asarray(x) for x in jax.tree.leaves(state_j)]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a port checkpoint into JAX
    j2, _ = _trainers("sage", small_graph, partitioned, tmp_path)
    assert j2.resume(tpath) == 3
    state_t = {"params": tt.params, "opt": tt.opt_state}
    state_j = {"params": j2.params, "opt": j2.opt_state}
    for a, b in zip(_leaves_np(state_t), [np.asarray(x) for x in jax.tree.leaves(state_j)]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_roundtrip_and_structure_errors(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "stages": [{"w": torch.ones(2, 2)}], "none": None}
    path = save_checkpoint(str(tmp_path / "ckpt"), tree, step=7)
    restored, step = load_checkpoint(path, tree)
    assert step == 7 and restored["none"] is None
    assert torch.equal(restored["a"], tree["a"]) and restored["a"].dtype == torch.float32
    from repro_torch.train.checkpoint import CheckpointError

    with pytest.raises(CheckpointError, match="missing key"):
        load_checkpoint(path, dict(tree, extra=torch.zeros(1)))
    with pytest.raises(CheckpointError, match="shape mismatch"):
        load_checkpoint(path, dict(tree, a=torch.zeros(3)))


@pytest.fixture(scope="module")
def port_system():
    g = torch_graph(1200, avg_degree=6, seed=5, feat_dim=16, num_classes=4)
    return torch_api.GLISPSystem.build(g, torch_api.GLISPConfig(num_parts=2, fanouts=(5, 3), seed=0))


def _model(seed=0):
    m = GNNModel("sage", 16, hidden=HIDDEN, num_layers=LAYERS, num_classes=4, device="cpu")
    return load_jax_params(m, m.init_numpy(seed))


def test_resume_is_bit_identical(port_system, tmp_path):
    ids = np.arange(0, 1200, 2)
    whole = port_system.trainer(_model(), ids, batch_size=64, prefetch=0)
    whole.train(max_steps=4)
    first = port_system.trainer(_model(), ids, batch_size=64, prefetch=0)
    first.train(max_steps=2)
    path = first.save(str(tmp_path / "ck.npz"), step=2)
    resumed = port_system.trainer(_model(), ids, batch_size=64, prefetch=0)
    assert resumed.resume(path) == 2
    resumed.train(max_steps=4)
    for a, b in zip(optim.tree_leaves(whole.params), optim.tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert torch.equal(whole.opt_state["step"], resumed.opt_state["step"])


def _same_batches(a, b):
    """Two lists of ``(seeds, GNNBatch)``, bit for bit."""
    assert len(a) == len(b)
    for (sa, ba), (sb, bb) in zip(a, b):
        assert np.array_equal(sa, sb)
        for name, va in vars(ba).items():
            vb = getattr(bb, name)
            for x, y in zip(va if isinstance(va, list) else [va],
                            vb if isinstance(vb, list) else [vb]):
                assert (x is None and y is None) or torch.equal(torch.as_tensor(x),
                                                                torch.as_tensor(y)), name


# W forked producers set through worker_cores of size W; the first two
# cases keep the pipeline's own choice of W
STREAMS = [pytest.param("process", None, 2, id="process"),
           pytest.param("thread", None, 2, id="thread")] + [
    pytest.param("process", tuple(range(w)), inflight, id=f"process-W{w}-inflight{inflight}")
    for w in (1, 2, 3) for inflight in (1, 2)]


@pytest.mark.parametrize("workers,cores,inflight", STREAMS)
def test_prefetch_gives_the_serial_stream(port_system, workers, cores, inflight):
    """A forked (or threaded) producer, or W forked producers, yields the
    batches and losses of the serial pipeline, bit for bit; after forked
    producers stop early (``max_steps``), the next run is the serial one's
    too."""
    ids = np.arange(0, 1200, 2)
    serial = port_system.trainer(_model(), ids, batch_size=64, prefetch=0, inflight=inflight)
    ahead = port_system.trainer(_model(), ids, batch_size=64, prefetch=2, inflight=inflight,
                                worker_cores=cores)
    ahead.pipeline.workers = workers
    if cores is not None:
        assert ahead.pipeline.producers == len(cores)
    try:
        a = serial.train(max_steps=3, log_every=1).losses
        b = ahead.train(max_steps=3, log_every=1).losses
        if workers == "process":
            _same_batches(list(serial.pipeline.host_batches(1)),
                          list(ahead.pipeline.host_batches(1)))
    finally:
        ahead.pipeline.close()
    assert a == b


def _pipe(system, prefetch, cores=None, inflight=2, cls=None, **kw):
    return (cls or torch_api.BatchPipeline)(
        system.backend, system.graph, np.arange(0, 1200, 2), (5, 3), LAYERS, batch_size=64,
        prefetch=prefetch, inflight=inflight, worker_cores=cores, device="cpu", **kw)


def _run(pipe, epochs, stop=None):
    """A run's host batches; ``stop`` closes it after that many."""
    out, stream = [], pipe.host_batches(epochs)
    try:
        for item in stream:
            out.append(item)
            if len(out) == stop:
                break
    finally:
        stream.close()
    return out


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("stop", [1, 7])
def test_a_run_stopped_early_leaves_the_serial_pipelines_state(port_system, w, stop):
    """W producers stopped after ``stop`` batches, then a two-epoch run on
    the same pipeline: the batches of a serial pipeline driven the same
    way, whatever W (so the same as with one producer)."""
    serial = _pipe(port_system, 0)
    want = _run(serial, 1, stop) + _run(serial, 2)
    pipe = _pipe(port_system, 2, tuple(range(w)))
    try:
        got = _run(pipe, 1, stop)
        assert not pipe._producers  # stopped early: the producers were stopped
        got += _run(pipe, 2)
        assert len(pipe._producers) == w  # a run to its end keeps them
        _same_batches(want, got)
        assert pipe.respawn_count == 0
    finally:
        pipe.close()


class _StallingProducer(torch_api.BatchPipeline):
    """Producer 1 stalls in its second batch until it is killed; the
    producer respawned in its place does not stall."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.stalled = mp.get_context("fork").Event()
        self._index = None
        self._made = 0

    def _worker_loop(self, index, *a):
        self._index = index
        super()._worker_loop(index, *a)

    def make_batch(self, seeds):
        if self._index == 1 and not self.stalled.is_set():
            self._made += 1
            if self._made == 2:
                self.stalled.set()
                time.sleep(120)
        return super().make_batch(seeds)


def test_a_killed_producer_is_respawned_and_the_stream_stays_serial(port_system):
    """One of three producers is killed mid-run (while it makes a batch,
    nothing of it in flight): it alone is respawned, past the batches
    delivered, and the run is the serial stream bit for bit."""
    want = _run(_pipe(port_system, 0), 2)
    pipe = _pipe(port_system, 2, (0, 1, 2), cls=_StallingProducer)
    got, stream = [], pipe.host_batches(2)
    try:
        for item in stream:
            got.append(item)
            if len(got) == 3:
                assert pipe.stalled.wait(timeout=60)
                others = [p.proc.pid for i, p in enumerate(pipe._producers) if i != 1]
                victim = pipe._producers[1].proc
                old_ring = pipe._producers[1].ring
                victim.kill()
                victim.join(timeout=10)
        assert pipe.respawn_count == 1 and not victim.is_alive()
        assert [p.proc.pid for i, p in enumerate(pipe._producers) if i != 1] == others
        # the respawned producer wrote into a ring of its own (the dead
        # one's unmapped: its address may be the new ring's), and every
        # ring ends the run with all its slots free
        assert pipe._producers[1].ring is not old_ring and old_ring._map.closed
        rings = _spans(p.ring for p in pipe._producers)
        assert len(rings) == 3 and rings <= _shared_maps()
        assert all(p.ring.free.get_value() == p.ring.slots == 2 for p in pipe._producers)
    finally:
        stream.close()
        pipe.close()
    _same_batches(want, got)


def _shared_maps() -> set:
    """``(start, bytes)`` of this process's anonymous shared mappings."""
    with open("/proc/self/maps") as maps:
        spans = [line.split()[0].split("-") for line in maps
                 if line.rstrip().endswith("/dev/zero (deleted)")]
    return {(int(a, 16), int(b, 16) - int(a, 16)) for a, b in spans}


def _spans(rings) -> set:
    """``(start, bytes)`` of each ring's mapping, while it is mapped."""
    return {(r._buf.ctypes.data, r.slots * r.slot_bytes) for r in rings}


def test_close_leaves_no_producer_alive(port_system):
    """``close()`` stops every producer and unmaps every ring."""
    pipe = _pipe(port_system, 2, (0, 1, 2))
    stream = pipe.host_batches(1)
    next(stream)
    procs = [p.proc for p in pipe._producers]
    rings = [p.ring for p in pipe._producers]
    spans = _spans(rings)
    assert len(procs) == 3 and all(p.is_alive() for p in procs)
    assert len(spans) == 3 and spans <= _shared_maps()
    pipe.close()
    assert not any(p.is_alive() for p in procs) and not pipe._producers
    assert all(r._map.closed for r in rings) and not spans & _shared_maps()
    stream.close()  # the abandoned run finds nothing left to drain
    pipe.close()  # idempotent
    assert not mp.active_children()


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("consumer", ["host_batches", "batches"])
def test_no_yielded_batch_changes_while_the_rings_wrap(port_system, w, consumer):
    """Every batch of a two-epoch run held to its end, while each
    producer's two slots are written over and over (18 batches): the held
    batches are the serial stream's, bit for bit. ``batches`` to the CPU
    is the same stream as tensors."""
    want = _run(_pipe(port_system, 0), 2)
    pipe = _pipe(port_system, 2, tuple(range(w)))
    try:
        got = list(getattr(pipe, consumer)(2))
        assert len(got) == 18 and all(p.ring.slots == 2 for p in pipe._producers)
    finally:
        pipe.close()
    _same_batches(want, got)


def _filled(batch: GNNBatch, rng) -> GNNBatch:
    """``batch`` with every array made real and filled at random."""
    def fill(a):
        return (rng.random(a.shape) < 0.5 if a.dtype == bool
                else rng.integers(-9, 9, a.shape).astype(a.dtype))

    return GNNBatch(**{name: [fill(a) for a in v] if isinstance(v, list) else fill(v)
                       for name, v in vars(batch).items()})


def test_a_batch_at_the_slot_bound_fits_and_one_beyond_raises(port_system):
    """The largest batch the pipeline can make fits a slot and reads back
    bit for bit; a batch one vertex quantum larger raises before a byte
    is written. Every real batch has the bound's fields, dtypes and
    ranks, and no array larger than the bound's."""
    pipe = _pipe(port_system, 0)
    g = port_system.graph
    bound = largest_batch(g.vertex_feats.shape[0], g.vertex_feats.shape[1], 64, (5, 3), LAYERS,
                          pipe.vertex_quantum, pipe.edge_quantum)
    for _, real in _run(pipe, 1):
        for name, b in vars(bound).items():
            r = getattr(real, name)
            for x, y in zip(r if isinstance(r, list) else [r], b if isinstance(b, list) else [b]):
                assert x.dtype == y.dtype and x.ndim == y.ndim, name
                assert all(i <= j for i, j in zip(x.shape, y.shape)), name
    rng = np.random.default_rng(0)
    big = _filled(bound, rng)
    slot = np.zeros(pipe.slot_bytes, np.uint8)
    plan, used = write_batch(slot, big)
    assert pipe.slot_bytes - mmap.PAGESIZE < used <= pipe.slot_bytes
    _same_batches([(None, big)], [(None, _views(slot, plan))])
    over = largest_batch(g.vertex_feats.shape[0] + pipe.vertex_quantum, g.vertex_feats.shape[1],
                         64, (5, 3), LAYERS, pipe.vertex_quantum, pipe.edge_quantum)
    assert over.feats.shape[0] == bound.feats.shape[0] + pipe.vertex_quantum
    fresh = np.zeros(pipe.slot_bytes, np.uint8)
    with pytest.raises(ValueError, match="does not fit a slot"):
        write_batch(fresh, _filled(over, rng))
    assert not fresh.any()


class _SmallSlots(torch_api.BatchPipeline):
    slot_bytes = mmap.PAGESIZE


def test_a_batch_larger_than_its_slot_raises_in_the_run(port_system):
    """A producer whose batch does not fit its slot fails the run with the
    reason; nothing falls back to another way of sending it."""
    pipe = _pipe(port_system, 2, (0, 1), cls=_SmallSlots)
    with pytest.raises(RuntimeError, match=f"does not fit a slot of {mmap.PAGESIZE} bytes"):
        _run(pipe, 1)
    assert not pipe._producers


@pytest.mark.parametrize("affinity,cores,workers,prefetch,want", [
    ({0}, None, "process", 2, 1),  # one usable core
    ({0, 1}, None, "process", 2, 1),  # one core for the consumer
    ({0, 1, 2, 3}, None, "process", 2, 3),
    (set(range(64)), None, "process", 2, "cap"),
    ({0}, (0, 1), "process", 2, 2),  # worker_cores are the producers' own
    (set(range(64)), None, "thread", 2, 1),
    (set(range(64)), None, "process", 0, 1),
])
def test_producers_follow_the_usable_cores(port_system, monkeypatch, affinity, cores,
                                           workers, prefetch, want):
    from repro_torch.api import pipeline as pipeline_mod

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: affinity)
    pipe = _pipe(port_system, prefetch, cores)
    pipe.workers = workers
    assert pipe.producers == (pipeline_mod.MAX_PRODUCERS if want == "cap" else want)


def test_a_raw_client_keeps_one_producer(small_graph, partitioned):
    """A raw client's draws follow the call order, not keys: one producer."""
    pipe = torch_api.BatchPipeline(_torch_client(small_graph, partitioned), small_graph,
                                   np.arange(64), (5, 3), LAYERS, batch_size=32, prefetch=2,
                                   worker_cores=(0, 1, 2), device="cpu")
    assert pipe.workers == "process" and pipe.producers == 1


def test_facade_loader_trainer_and_train(port_system):
    ids = np.arange(0, 1200, 4)
    pipe = port_system.loader(ids, batch_size=32, prefetch=0, device="cpu")
    seeds, batch = next(iter(pipe))
    assert seeds.shape == (32,) and isinstance(batch.feats, torch.Tensor)
    assert batch.feats.device.type == "cpu" and batch.layer_dst_order[0].dtype == torch.int32
    tr = port_system.train(_model(), ids, epochs=1, batch_size=100, prefetch=0, log_every=1)
    assert len(tr.log.losses) == 3 and np.all(np.isfinite(tr.log.losses))
    assert 0.0 <= tr.evaluate(ids, batches=2) <= 1.0
    dp = port_system.dp_trainer(_model(), ids, num_shards=2, batch_size=64, device="cpu")
    assert isinstance(dp, DataParallelGNNTrainer) and len(dp.pipelines) == 2
    assert [pl.loader.batch for pl in dp.pipelines] == [32, 32]
    assert all(pl.workers == "thread" for pl in dp.pipelines)


def test_facade_trainer_matches_the_jax_facade():
    """The same system config on both sides: bit-equal samples, so equal
    loss trajectories through both facades."""
    kw = dict(num_vertices=1000, avg_degree=6, seed=2, feat_dim=16, num_classes=4)
    cfg = dict(num_parts=2, fanouts=(4, 3), seed=0)
    sj = jax_api.GLISPSystem.build(jax_graph(**kw), jax_api.GLISPConfig(**cfg))
    st = torch_api.GLISPSystem.build(torch_graph(**kw), torch_api.GLISPConfig(**cfg))
    ids = np.arange(0, 1000, 3)
    jm = JaxGNN("gcn", 16, hidden=HIDDEN, num_layers=2, num_classes=4)
    jt = sj.trainer(jm, ids, batch_size=48, prefetch=0)
    tm = GNNModel("gcn", 16, hidden=HIDDEN, num_layers=2, num_classes=4, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jt.params))
    tt = st.trainer(tm, ids, batch_size=48, prefetch=0)
    np.testing.assert_allclose(
        tt.train(max_steps=4, log_every=1).losses, jt.train(max_steps=4, log_every=1).losses,
        rtol=1e-4,
    )


# (edges, rows of feats, segments, width, valid fraction, seed)
GATHER_SWEEP = [
    (0, 4, 3, 5, 1.0, 0),
    (37, 9, 11, 3, 1.0, 1),
    (64, 5, 40, 8, 0.0, 2),
    (96, 30, 7, 16, 0.5, 3),
    (120, 50, 40, 4, 0.9, 4),
]


def _gather_inputs(m, f, n, d, frac, seed, shuffle=True):
    rng = np.random.default_rng(seed)
    valid = int(m * frac)
    seg = np.sort(rng.integers(0, n, m)).astype(np.int32)
    idx = rng.integers(0, f, m).astype(np.int32)
    seg[valid:] = -1
    idx[valid:] = -1
    if shuffle:
        p = rng.permutation(m)
        seg, idx = seg[p], idx[p]
    feats = rng.standard_normal((f, d)).astype(np.float32)
    return feats, idx, seg


@pytest.mark.parametrize("m,f,n,d,frac,seed", GATHER_SWEEP)
def test_gather_aggregate_matches_jax_and_pallas(m, f, n, d, frac, seed):
    feats, idx, seg = _gather_inputs(m, f, n, d, frac, seed)
    got = ops.gnn_gather_aggregate(torch.as_tensor(feats), torch.as_tensor(idx),
                                   torch.as_tensor(seg), n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    want = jax_gather_ref(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(seg), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pallas = gather_spmm_ragged_pallas(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(seg), n,
                                       block_edges=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,f,n,d,frac,seed", GATHER_SWEEP)
def test_gather_backward_twin_matches_autograd(m, f, n, d, frac, seed):
    feats, idx, seg = _gather_inputs(m, f, n, d, frac, seed)
    x = torch.as_tensor(feats).requires_grad_(True)
    grad = torch.as_tensor(np.random.default_rng(seed + 9).standard_normal((n, d)).astype(np.float32))
    gather_spmm_ref(x, torch.as_tensor(idx), torch.as_tensor(seg), n).backward(grad)
    twin = gather_spmm_ragged_backward_ref(grad, torch.as_tensor(idx), torch.as_tensor(seg), f)
    np.testing.assert_allclose(twin.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-6)
    # the wrapper takes the twin for CPU tensors
    wrapped = fused_gnn.gather_spmm_ragged_backward(grad, torch.as_tensor(idx),
                                                    torch.as_tensor(seg), f)
    assert torch.equal(wrapped, twin)
    # gather_rows: the backward of x[idx] is the same function over (e, idx)
    y = torch.as_tensor(feats).requires_grad_(True)
    g_rows = torch.as_tensor(np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32))
    rows = ops.gather_rows(y, torch.as_tensor(idx))
    assert torch.equal(rows[torch.as_tensor(idx) < 0], torch.zeros_like(rows[torch.as_tensor(idx) < 0]))
    rows.backward(g_rows)
    order = torch.as_tensor(sorted_order(idx))
    twin = gather_spmm_ragged_backward_ref(g_rows[order.long()], torch.as_tensor(idx)[order.long()],
                                           torch.arange(m, dtype=torch.int32), f)
    np.testing.assert_allclose(twin.numpy(), y.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,n,d,frac,seed", [(0, 4, 5, 1.0, 0), (37, 11, 3, 1.0, 1),
                                             (64, 40, 8, 0.0, 2), (120, 40, 16, 0.93, 5),
                                             (50, 200, 4, 1.0, 6)])
def test_gat_backward_twin_matches_autograd(m, n, d, frac, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, m).astype(np.int32)
    seg[int(m * frac):] = -1
    seg = torch.as_tensor(rng.permutation(seg))
    logits = torch.as_tensor(rng.standard_normal(m).astype(np.float32)).requires_grad_(True)
    msg = torch.as_tensor(rng.standard_normal((m, d)).astype(np.float32)).requires_grad_(True)
    grad = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    gat_softmax_aggregate_ref(logits, msg, seg, n).backward(grad)
    dlogit, dmsg = gat_softmax_aggregate_backward_ref(grad, logits.detach(), msg.detach(), seg, n)
    np.testing.assert_allclose(dmsg.numpy(), msg.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dlogit.numpy(), logits.grad.numpy(), rtol=1e-4, atol=1e-6)
    assert torch.all(dlogit[seg < 0] == 0) and torch.all(dmsg[seg < 0] == 0)
