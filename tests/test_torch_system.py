"""The port's slice as a whole against the JAX package, on the CPU:
build, sampling, layerwise inference and serving.

Host results (partition plan, reorder ids, sampled hops) are copies of the
JAX package's numpy code and must be bit-equal. Embeddings go through two
frameworks' matmuls and sums: float32 rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
import repro_torch.api as torch_api  # noqa: E402
from repro.graph import power_law_graph as jax_graph  # noqa: E402
from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
from repro_torch.graph import power_law_graph as torch_graph  # noqa: E402
from repro_torch.models.gnn import GNNModel, load_jax_params  # noqa: E402

GRAPH = dict(num_vertices=1200, avg_degree=6, seed=5, feat_dim=16, num_classes=4)
CONFIG = dict(num_parts=2, fanouts=(6, 4), seed=0)
HIDDEN = 16


@pytest.fixture(scope="module")
def systems():
    gj, gt = jax_graph(**GRAPH), torch_graph(**GRAPH)
    sj = jax_api.GLISPSystem.build(gj, jax_api.GLISPConfig(**CONFIG))
    st = torch_api.GLISPSystem.build(gt, torch_api.GLISPConfig(**CONFIG))
    return sj, st


def test_graph_and_plan_are_bit_equal(systems):
    sj, st = systems
    for name in ("src", "dst", "edge_types", "vertex_feats", "labels"):
        assert np.array_equal(getattr(sj.graph, name), getattr(st.graph, name)), name
    assert np.array_equal(sj.plan.edge_parts, st.plan.edge_parts)
    assert np.array_equal(sj.reorder_perm, st.reorder_perm)
    for pj, pt in zip(sj.partitions, st.partitions):
        assert np.array_equal(pj.global_id, pt.global_id)
    assert sj.partition_metrics() == st.partition_metrics()


@pytest.mark.parametrize("fanouts", [(6,), (6, 4)])
def test_sampled_hops_are_bit_equal(systems, fanouts):
    sj, st = systems
    seeds = np.arange(0, 1200, 37)
    a = sj.sample(seeds, fanouts, key=(3, 1))
    b = st.sample(seeds, fanouts, key=(3, 1))
    assert len(a.hops) == len(b.hops) == len(fanouts)
    for hj, ht in zip(a.hops, b.hops):
        assert np.array_equal(hj.src, ht.src) and np.array_equal(hj.dst, ht.dst)
        assert np.array_equal(hj.eid, ht.eid)


def _run_both(systems, kind, tmp_path):
    sj, st = systems
    jm = JaxGNN(kind, GRAPH["feat_dim"], hidden=HIDDEN, num_layers=2, num_heads=2)
    params = jm.init(jax.random.PRNGKey(1))
    tm = GNNModel(kind, GRAPH["feat_dim"], hidden=HIDDEN, num_layers=2, num_heads=2, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    kw = dict(out_dims=[HIDDEN, HIDDEN], batch_size=256)
    rj = sj.infer_layerwise(
        [jm.embed_layer_fn(params, k) for k in range(2)], str(tmp_path / "jax"), **kw
    )
    rt = st.infer_layerwise(
        [tm.embed_layer_fn(k) for k in range(2)], str(tmp_path / "torch"), device="cpu", **kw
    )
    return rj, rt


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_infer_layerwise_matches_jax(systems, kind, tmp_path):
    rj, rt = _run_both(systems, kind, tmp_path)
    assert np.array_equal(rj.newid, rt.newid) and np.array_equal(rj.owner, rt.owner)
    rows = np.arange(GRAPH["num_vertices"])
    np.testing.assert_allclose(
        rt.final_store.read_rows(rows), rj.final_store.read_rows(rows), rtol=1e-4, atol=1e-5
    )
    for sj_, st_ in zip(rj.layer_stats, rt.layer_stats):
        assert sj_.bucket_batches == st_.bucket_batches
        assert sj_.edges_aggregated == st_.edges_aggregated
    assert rt.device_batches() == sum(sum(s.bucket_batches.values()) for s in rj.layer_stats)
    assert systems[1].infer_engine.shape_count() == rt.slice_shapes


@pytest.fixture(scope="module")
def served(systems, tmp_path_factory):
    _run_both(systems, "sage", tmp_path_factory.mktemp("served"))
    return systems


def _requests():
    rng = np.random.default_rng(11)
    return [
        rng.choice(GRAPH["num_vertices"], size=int(rng.integers(1, 9)), replace=False)
        for _ in range(8)
    ]


def test_served_responses_match_jax(served):
    sj, st = served
    for v in _requests():
        a = sj.server(max_batch_delay_ms=0.0, deadline_ms=None).call(v)
        b = st.server(max_batch_delay_ms=0.0, deadline_ms=None).call(v)
        assert a.status == b.status == "ok"
        np.testing.assert_allclose(b.embeddings, a.embeddings, rtol=1e-4, atol=1e-5)


def test_batched_responses_equal_solo_bitwise(served):
    _, st = served
    reqs = _requests()
    solo = st.server(max_batch_delay_ms=0.0, deadline_ms=None)
    want = [solo.call(v).embeddings for v in reqs]
    batched = st.server(max_batch_delay_ms=1e6, deadline_ms=None)
    rids = [batched.submit(v) for v in reqs]
    batched.drain()
    assert batched.stats.mean_batch_requests() > 1.0
    for rid, w in zip(rids, want):
        resp = batched.response(rid)
        assert resp.status == "ok" and np.array_equal(resp.embeddings, w)


def test_config_keeps_the_reference_fields_less_the_jax_engine_knobs():
    ref = {f.name for f in dataclasses.fields(jax_api.GLISPConfig)}
    port = {f.name for f in dataclasses.fields(torch_api.GLISPConfig)}
    assert ref - port == {"infer_use_kernel", "infer_jit", "kernel_autotune", "kernel_cache_dir"}
    assert port <= ref
    for name in port:
        assert getattr(torch_api.GLISPConfig(), name) == getattr(jax_api.GLISPConfig(), name)


@pytest.mark.parametrize(
    "bad",
    [
        dict(num_parts=0),
        dict(partitioner="metis"),
        dict(reorder="zz"),
        dict(storage_tiers=()),
        dict(dynamic_frac=0.0),
        dict(infer_mode="jit"),
        dict(infer_edge_buckets=(512, 256)),
        dict(serve_queue_depth=0),
    ],
)
def test_config_validation_matches_the_reference(bad):
    with pytest.raises(ValueError):
        jax_api.GLISPConfig(**bad).validate()
    with pytest.raises(ValueError):
        torch_api.GLISPConfig(**bad).validate()


@pytest.mark.parametrize("transport", ["mp", "socket"])
def test_remote_transports_wait_for_a_later_slice(transport):
    """The remote transports are ported (``repro_torch.dist``): the config
    validates, and ``close()`` after ``build`` leaves no worker process."""
    import multiprocessing as mp

    cfg = torch_api.GLISPConfig(dist_transport=transport, **CONFIG)
    assert cfg.validate() is cfg
    system = torch_api.GLISPSystem.build(torch_graph(**GRAPH), cfg)
    procs = [w.proc for w in system.backend.service.dispatcher._workers]
    assert len(procs) == CONFIG["num_parts"] and all(p.is_alive() for p in procs)
    system.close()
    assert not any(p.is_alive() for p in procs)
    assert [p for p in mp.active_children() if p.is_alive()] == []


def test_server_requires_inference_artifact():
    g = torch_graph(**GRAPH)
    fresh = torch_api.GLISPSystem.build(g, torch_api.GLISPConfig(**CONFIG))
    with pytest.raises(ValueError, match="infer_layerwise"):
        fresh.server()
