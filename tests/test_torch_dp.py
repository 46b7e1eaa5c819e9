"""The port's data-parallel trainer against the JAX package, on the CPU.

One card has only the shard axis: the port lays the S shard batches out
block-diagonally as one batch and takes one step over it
(``repro_torch/train/data_parallel.py``). Held here:

- ``stack_batches`` bitwise the reference's, orders recomputed;
- the merged layout (offsets, ``-1`` kept, padding at the global tail);
- at S = 1 the loss trajectory of the JAX ``DataParallelGNNTrainer`` over a
  one-device mesh, from the JAX parameters: rtol 1e-5;
- at S = 2 and 4 one merged step against the JAX step rebuilt from its
  public pieces (``vmap`` of ``model.loss`` over the reference's stacked
  batch, its mean, ``value_and_grad``, ``adamw_update``): loss rtol 1e-5,
  every gradient and updated parameter rtol 1e-4 / atol 1e-6 (two
  frameworks' matmuls and sum orders; ``PERF.md`` section 2);
- the merged step against the per-shard twin: rtol 1e-5 / atol 1e-6;
- DP over forked sampling workers bitwise DP in process (the CPU plain
  path is bit-reproducible).

Model: 2 layers, hidden 16, 4 classes (GAT 2 heads) on the conftest's
``small_graph``.
"""
import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro_torch.api as torch_api  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
from repro.models.gnn.batching import GNNBatch as JaxBatch  # noqa: E402
from repro.train import data_parallel as jax_dp  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro_torch.graph import power_law_graph  # noqa: E402
from repro_torch.models.gnn import GNNModel, load_jax_params  # noqa: E402
from repro_torch.models.gnn.batching import GNNBatch, sorted_order  # noqa: E402
from repro_torch.train import DataParallelGNNTrainer, stack_batches  # noqa: E402
from repro_torch.train.data_parallel import merge_shards, shard  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402

GRAPH = dict(avg_degree=8, seed=7, feat_dim=16, num_classes=4)
BASE = dict(num_parts=2, fanouts=(4, 3), batch_size=32, seed=5, dist_dispatch_timeout=30.0)
IDS = np.arange(0, 2000, 3)
HIDDEN, LAYERS, HEADS = 16, 2, 2
SHARED = ("feats", "valid", "seed_pos", "labels", "layer_dst", "layer_src", "layer_etype",
          "layer_cnt")


@pytest.fixture(scope="module")
def systems(small_graph):
    g = power_law_graph(2000, **GRAPH)
    sj = jax_api.GLISPSystem.build(small_graph, jax_api.GLISPConfig(**BASE))
    st = torch_api.GLISPSystem.build(g, torch_api.GLISPConfig(**BASE))
    return sj, st


def _pair(kind, seed=5):
    jm = JaxGNN(kind, 16, hidden=HIDDEN, num_layers=LAYERS, num_classes=4, num_heads=HEADS)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GNNModel(kind, 16, hidden=HIDDEN, num_layers=LAYERS, num_classes=4, num_heads=HEADS,
                  device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _shard_batches(system, num_shards, batch_size=64):
    """One step's shard batches (numpy) from a port DP trainer's pipelines."""
    tm = GNNModel("sage", 16, hidden=HIDDEN, num_layers=LAYERS, num_classes=4, device="cpu")
    tr = system.dp_trainer(tm, IDS, num_shards=num_shards, batch_size=batch_size, prefetch=0,
                           device="cpu")
    out = []
    for pl in tr.pipelines:
        stream = pl.host_batches(1)
        out.append(next(stream)[1])
        stream.close()
    return tr, out


def _as_jax(b: GNNBatch) -> JaxBatch:
    return JaxBatch(**{name: getattr(b, name) for name in SHARED})


def _equal(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_stack_batches_is_the_references(systems, num_shards):
    _, st = systems
    _, batches = _shard_batches(st, num_shards)
    ours = stack_batches(batches)
    theirs = jax_dp.stack_batches([_as_jax(b) for b in batches])
    for name in SHARED:
        assert _equal(getattr(ours, name), getattr(theirs, name)), name
    for k in range(LAYERS):
        for s in range(num_shards):
            dst, src = ours.layer_dst[k][s], ours.layer_src[k][s]
            by_dst = ours.layer_dst_order[k][s]
            assert np.array_equal(by_dst, sorted_order(dst))
            assert np.array_equal(ours.layer_src_order[k][s], sorted_order(src[by_dst]))
            # a shard's own orders, extended over its padding
            e = batches[s].layer_dst[k].shape[0]
            assert np.array_equal(by_dst[:e], batches[s].layer_dst_order[k])


def test_stack_batches_pads_and_rejects_ragged():
    def mk(v, e, b):
        dst = np.full(e, -1, np.int32)
        dst[: e // 2] = np.arange(e // 2) % v
        return GNNBatch(
            feats=np.ones((v, 4), dtype=np.float32),
            valid=np.ones(v, dtype=bool),
            seed_pos=np.zeros(b, dtype=np.int32),
            labels=np.zeros(b, dtype=np.int32),
            layer_dst=[dst],
            layer_src=[dst[::-1].copy()],
            layer_etype=[np.zeros(e, dtype=np.int32)],
        )

    stacked = stack_batches([mk(8, 6, 4), mk(5, 9, 4)])
    assert stacked.feats.shape == (2, 8, 4)
    assert stacked.layer_dst[0].shape == stacked.layer_dst_order[0].shape == (2, 9)
    assert not stacked.valid[1, 5:].any()
    assert (stacked.layer_dst[0][0, 6:] == -1).all()
    assert stacked.layer_cnt is None
    with pytest.raises(ValueError, match="seeds per batch"):
        stack_batches([mk(8, 6, 4), mk(8, 6, 3)])


@pytest.mark.parametrize("num_shards", [1, 3])
def test_merge_shards_lays_the_shards_out_block_diagonally(systems, num_shards):
    _, st = systems
    _, batches = _shard_batches(st, num_shards, batch_size=48)
    stacked = stack_batches(batches)
    merged = merge_shards(stacked)
    S, V = stacked.feats.shape[:2]
    assert merged.feats.shape == (S * V, 16)
    assert np.array_equal(merged.feats, np.concatenate(list(stacked.feats)))
    B = stacked.seed_pos.shape[1]
    for s in range(S):
        assert np.array_equal(merged.seed_pos[s * B:(s + 1) * B], stacked.seed_pos[s] + s * V)
    for k in range(LAYERS):
        dst, src = merged.layer_dst[k], merged.layer_src[k]
        E = stacked.layer_dst[k].shape[1]
        for s in range(S):
            d = stacked.layer_dst[k][s]
            assert np.array_equal(dst[s * E:(s + 1) * E], np.where(d >= 0, d + s * V, -1))
        by_dst = merged.layer_dst_order[k]
        assert by_dst.dtype == np.int32 and np.array_equal(by_dst, sorted_order(dst))
        real = int((dst >= 0).sum())
        # every shard's padding at the global tail, the rows ascending
        assert (dst[by_dst][:real] >= 0).all() and (dst[by_dst][real:] == -1).all()
        assert np.all(np.diff(dst[by_dst][:real]) >= 0)
        assert np.array_equal(merged.layer_src_order[k], sorted_order(src[by_dst]))
        assert np.array_equal(merged.layer_cnt[k][:, 0],
                              np.bincount(dst[dst >= 0], minlength=S * V).astype(np.float32))
    # one shard's own batch, as the per-shard loop sees it
    one = shard(stacked, S - 1)
    assert np.array_equal(one.feats, stacked.feats[S - 1])


def _unsharded_jax_run(jt, params, steps):
    """The JAX trainer's loop with its unsharded step (``_ref_step``)."""
    jt.ref_params, jt.ref_opt_state = params, jax_optim.adamw_init(params)
    streams = [pl.batches(1) for pl in jt.pipelines]
    log = jax_dp.DPTrainLog()
    for step in range(steps):
        stacked = jax_dp.stack_batches([jax.tree.map(np.asarray, next(s)[1]) for s in streams])
        jt.ref_params, jt.ref_opt_state, loss = jt._ref_step(
            jt.ref_params, jt.ref_opt_state, jax.tree.map(jnp.asarray, stacked))
        log.steps.append(step)
        log.losses.append(float(loss))
    for s in streams:
        s.close()
    return log


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_one_shard_matches_the_jax_dp_trainer(systems, kind):
    sj, st = systems
    jm, params, tm = _pair(kind)
    jt = sj.dp_trainer(jm, IDS, mesh=make_local_mesh(1), batch_size=32, reference=True)
    jt.params = params
    if kind == "sage":
        jlog = jt.train(log_every=1, max_steps=5)
    else:
        # the reference's sharded step fails to differentiate GAT over a
        # mesh axis on this jax ("expected cotangent type float32[1@data,
        # 1024]"); its unsharded jit of the same step runs on the same
        # stacked batches of its own shard pipelines
        jlog = _unsharded_jax_run(jt, params, steps=5)
    tt = st.dp_trainer(tm, IDS, num_shards=1, batch_size=32, device="cpu")
    tlog = tt.train(log_every=1, max_steps=5)
    assert len(tlog.losses) == 5 and tlog.steps == jlog.steps
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=1e-5)
    assert tlog.sample_time > 0 and tlog.compute_time > 0 and len(tlog.wall) == 5


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_merged_step_matches_the_jax_vmap_step(systems, kind, num_shards):
    _, st = systems
    jm, params, tm = _pair(kind)
    tr, batches = _shard_batches(st, num_shards)
    stacked = stack_batches(batches)
    jstacked = jax.tree.map(jnp.asarray, jax_dp.stack_batches([_as_jax(b) for b in batches]))
    cfg = jax_optim.AdamWConfig(lr=1e-3, weight_decay=1e-4)

    def loss_fn(p):
        return jax.vmap(lambda b: jm.loss(p, b))(jstacked).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    new_j, _, _ = jax_optim.adamw_update(params, grads_j, jax_optim.adamw_init(params), cfg)

    tr.model = tm
    tr.opt_state = adamw_init(tm.param_tree())
    loss_t = tr.merged_step(merge_shards(stacked).to("cpu"))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    pairs = [("out", tm.out, grads_j["out"], new_j["out"])] + [
        (f"layer {k} {name}", p, grads_j["layers"][k][name], new_j["layers"][k][name])
        for k in range(LAYERS) for name, p in tm.layers[k].items()
    ]
    for what, p, g, new in pairs:
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6,
                                   err_msg=f"d {what}")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(new), rtol=1e-4, atol=1e-6,
                                   err_msg=f"updated {what}")


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_merged_step_matches_the_per_shard_twin(systems, kind, num_shards):
    _, st = systems
    _, _, tm = _pair(kind)
    tr = st.dp_trainer(tm, IDS, num_shards=num_shards, batch_size=64, prefetch=0,
                       reference=True, device="cpu")
    log = tr.train(log_every=1, max_steps=3)
    assert len(log.losses) == len(log.ref_losses) == 3
    np.testing.assert_allclose(log.losses, log.ref_losses, rtol=1e-5, atol=1e-6)
    for p, q in zip(tm.parameters(), tr.ref_model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(os.name != "posix", reason="dist workers fork (POSIX only)")
@pytest.mark.parametrize("transport", ["mp", "socket"])
def test_dp_over_forked_workers_is_bitwise_dp_in_process(systems, transport):
    _, st = systems
    remote = torch_api.GLISPSystem.build(
        st.graph, torch_api.GLISPConfig(**dict(BASE, dist_transport=transport))
    )
    try:
        logs = []
        for system in (st, remote):
            _, _, tm = _pair("sage")
            tr = system.dp_trainer(tm, IDS, num_shards=2, batch_size=64, device="cpu")
            logs.append(tr.train(log_every=1, max_steps=3).losses)
    finally:
        remote.close()
    assert logs[0] == logs[1]
    assert [p for p in mp.active_children() if p.is_alive()] == []


def test_the_global_batch_must_divide_over_the_shards(systems):
    _, st = systems
    _, _, tm = _pair("sage")
    with pytest.raises(ValueError, match="divide evenly"):
        st.dp_trainer(tm, IDS, num_shards=3, batch_size=64, device="cpu")
    with pytest.raises(ValueError, match="num_shards"):
        st.dp_trainer(tm, IDS, num_shards=0, device="cpu")
    with pytest.raises(ValueError, match="SamplingSpec or fanouts"):
        DataParallelGNNTrainer(tm, st.backend, st.graph, IDS, device="cpu")


def test_the_model_must_live_on_the_trainers_device(systems):
    _, st = systems
    _, _, tm = _pair("sage")
    meta = GNNModel("sage", 16, hidden=HIDDEN, num_layers=LAYERS, num_classes=4, device="meta")
    with pytest.raises(ValueError, match="lives on"):
        st.dp_trainer(meta, IDS, device="cpu")
