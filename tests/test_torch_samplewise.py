"""The port's sample-wise inference and old inference shims against the JAX
package, on the CPU.

``samplewise_inference`` is the baseline of the paper's layerwise claim:
each target's K-hop subgraph through the whole model. The cases of
``tests/test_inference.py`` run through both packages (layerwise equals
sample-wise at full fanout; the redundancy count), then the port's pass
with its GNN models against the JAX pass with the same parameters
(``load_jax_params``) on identically seeded clients: the counts equal,
the embeddings within float32 rtol 1e-4 / atol 1e-5 (two frameworks'
matmuls and sum orders; the JAX model on its jnp path). The deprecated
``TwoLevelCache`` / ``ChunkedEmbeddingStore`` shims keep the accounting of
``tests/test_storage.py`` in both packages.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.inference as jax_inference  # noqa: E402
import repro.core.storage as jax_storage  # noqa: E402
import repro_torch.core.inference as torch_inference  # noqa: E402
import repro_torch.core.storage as torch_storage  # noqa: E402
from repro.core.sampling import GatherApplyClient as JaxClient  # noqa: E402
from repro.core.sampling import SamplingServer as JaxServer  # noqa: E402
from repro.core.sampling import VertexRouter as JaxRouter  # noqa: E402
from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
from repro_torch.core.inference import engine as torch_engine  # noqa: E402
from repro_torch.core.sampling import GatherApplyClient, SamplingServer, VertexRouter  # noqa: E402
from repro_torch.graph import build_partitions  # noqa: E402
from repro_torch.graph import power_law_graph as torch_graph  # noqa: E402
from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.models.gnn import GNNModel, load_jax_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"repro": jax_inference, "repro_torch": torch_inference}
STORAGE = {"repro": jax_storage, "repro_torch": torch_storage}
BIG = 10**9


@pytest.fixture(scope="module")
def port_graph(small_graph):
    """The port's copy of the generator gives the conftest graph's arrays."""
    g = torch_graph(2000, avg_degree=8, seed=7, feat_dim=16, num_classes=4)
    for name in ("src", "dst", "edge_types", "vertex_feats", "labels"):
        assert np.array_equal(getattr(g, name), getattr(small_graph, name)), name
    return g


def _client(pkg, g, ep):
    """A fresh client over the partitions ``ep``: the same seeds give the
    same samples in both packages."""
    if pkg == "repro":
        from repro.graph import build_partitions as jax_build

        parts = jax_build(g, ep, 4)
        return JaxClient([JaxServer(p, seed=0) for p in parts], JaxRouter(g, ep, 4), seed=0)
    parts = build_partitions(g, ep, 4)
    return GatherApplyClient([SamplingServer(p, seed=0) for p in parts], VertexRouter(g, ep, 4),
                             seed=0)


def _graph(pkg, small_graph, port_graph):
    return small_graph if pkg == "repro" else port_graph


def _mean_layer(W):
    def layer(_k, h_self, h_nbr, seg):
        agg = np.zeros_like(h_self)
        cnt = np.zeros(h_self.shape[0])
        if h_nbr.shape[0]:
            np.add.at(agg, seg, h_nbr)
            np.add.at(cnt, seg, 1.0)
        agg = agg / np.maximum(cnt, 1)[:, None]
        return np.tanh(np.concatenate([h_self, agg], axis=1) @ W)
    return layer


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    return [_mean_layer(rng.standard_normal((32, 16)).astype(np.float32) * 0.3)
            for _ in range(2)]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_layerwise_equals_samplewise_full_fanout(pkg, small_graph, port_graph, partitioned,
                                                 layers, tmp_path):
    """``tests/test_inference.py::test_layerwise_equals_samplewise_full_fanout``
    through each package; the two packages' sample-wise results are the
    same bits (numpy layers, the same samples)."""
    inf = PACKAGES[pkg]
    g, ep = _graph(pkg, small_graph, port_graph), partitioned[0]
    eng = inf.LayerwiseInferenceEngine(
        g, _client(pkg, g, ep), layers, g.vertex_feats, str(tmp_path),
        fanouts=[BIG, BIG], chunk_rows=128, out_dims=[16, 16],
        **({"device": "cpu"} if pkg == "repro_torch" else {}),
    )
    res = eng.run()
    targets = np.arange(48)
    sw, _ = inf.samplewise_inference(g, _client(pkg, g, ep), layers, g.vertex_feats, targets,
                                     fanouts=[BIG, BIG])
    lw = res.final_store.read_rows_direct(res.newid[targets])
    np.testing.assert_allclose(lw, sw, rtol=1e-4, atol=1e-5)
    other = "repro_torch" if pkg == "repro" else "repro"
    og = _graph(other, small_graph, port_graph)
    sw2, _ = PACKAGES[other].samplewise_inference(og, _client(other, og, ep), layers,
                                                  og.vertex_feats, targets, fanouts=[BIG, BIG])
    assert np.array_equal(sw, sw2)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_samplewise_redundancy(pkg, small_graph, port_graph, partitioned, layers):
    """``tests/test_inference.py::test_samplewise_redundancy`` through each
    package: sample-wise vertex-layer computations for N targets exceed the
    layerwise K * N; both packages count the same."""
    g, ep = _graph(pkg, small_graph, port_graph), partitioned[0]
    targets = np.arange(g.num_vertices)[:500]
    counts = {}
    for name, inf in PACKAGES.items():
        gg = _graph(name, small_graph, port_graph)
        _, counts[name] = inf.samplewise_inference(
            gg, _client(name, gg, ep), layers, gg.vertex_feats, targets,
            fanouts=[10, 10], batch_size=32,
        )
    st = counts[pkg]
    assert st["vertices_computed"] > 1.5 * 2 * targets.shape[0]
    assert counts["repro"] == counts["repro_torch"]
    assert set(st) == {"vertices_computed", "edges_aggregated", "feature_rows_read"}


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat", "hgt"])
def test_samplewise_with_the_models_matches_jax(kind, small_graph, port_graph, partitioned):
    """The port's ``GNNModel.embed_layer_fn`` layers against the JAX
    model's, parameters from ``jax.random`` loaded into the port: the same
    counts, embeddings within float32 tolerance, in the targets' order
    (unsorted, with a repeat inside a batch)."""
    ep = partitioned[0]
    jm = JaxGNN(kind, 16, hidden=16, num_layers=2, num_heads=2)
    params = jm.init(jax.random.PRNGKey(3))
    tm = GNNModel(kind, 16, hidden=16, num_layers=2, num_heads=2, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    targets = np.random.default_rng(5).choice(2000, 70, replace=False)
    targets[5] = targets[3]
    fused_gnn.reset_launches()
    got, st = torch_inference.samplewise_inference(
        port_graph, _client("repro_torch", port_graph, ep),
        [tm.embed_layer_fn(k) for k in range(2)], port_graph.vertex_feats, targets,
        fanouts=[5, 3], batch_size=32,
    )
    want, st_j = jax_inference.samplewise_inference(
        small_graph, _client("repro", small_graph, ep),
        [jm.embed_layer_fn(params, k) for k in range(2)], small_graph.vertex_feats, targets,
        fanouts=[5, 3], batch_size=32,
    )
    assert st == st_j and st["vertices_computed"] > 0
    assert got.shape == (70, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    assert np.array_equal(got[5], got[3])
    assert set(fused_gnn.LAUNCHES.values()) == {0}  # CPU tensors launch nothing


def _store(storage, path, rows=512, dim=4, chunk_rows=32):
    store = storage.DFSTier(str(path), rows, dim, chunk_rows=chunk_rows)
    vals = np.arange(rows * dim, dtype=np.float32).reshape(rows, dim) / (rows * dim)
    store.write_rows(np.arange(rows), vals.astype(store.dtype))
    return store


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_two_level_shim_matches_the_hybrid_cache(pkg, tmp_path):
    """``tests/test_storage.py::test_hybrid_matches_legacy_two_level_accounting``
    in each package: the shim reproduces the memory+disk fifo hybrid's
    counters trace for trace, and its ``stats`` is a ``CacheStats``."""
    inf, storage = PACKAGES[pkg], STORAGE[pkg]
    trace = [0, 1, 2, 0, 1, 2, 3, 3, 0]
    store_a = _store(storage, tmp_path / "a", rows=320)
    store_b = _store(storage, tmp_path / "b", rows=320)
    legacy = inf.TwoLevelCache(store_a, inf.CachePolicy.FIFO, dynamic_frac=0.2)
    legacy.fill_static(np.arange(320))
    hybrid = storage.HybridCache(store_b, storage.build_tiers(("memory", "disk"), 32, 4),
                                 policy="fifo", dynamic_frac=0.2)
    hybrid.fill(hybrid.plan_fill(np.arange(320)))
    for c in trace:
        rows = np.arange(c * 32, c * 32 + 16)
        np.testing.assert_array_equal(legacy.read_rows(rows), hybrid.read_rows(rows))
    ls, hs = legacy.stats, hybrid.stats
    assert (ls.fill_chunks, ls.static_reads, ls.dynamic_hits, ls.rows_served) \
        == (hs.fill_chunks, hs.static_reads, hs.dynamic_hits, hs.rows_served)
    assert hs.fill_chunks == 10 and legacy.dynamic_capacity == 2
    assert ls.modeled_time_ms(inf.IOCost()) == hs.modeled_time_ms(inf.IOCost())
    assert isinstance(ls, inf.CacheStats)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_two_level_shim_capacity_grows_without_a_fill(pkg, tmp_path):
    """``tests/test_storage.py::test_fill_free_capacity_grows`` in each
    package; the two packages count the same hits."""
    hits = {}
    for name, inf in PACKAGES.items():
        store = _store(STORAGE[name], tmp_path / name, rows=320)
        cache = inf.TwoLevelCache(store, inf.CachePolicy.LRU, dynamic_frac=0.5)
        for c in [0, 1, 2, 3, 4, 5]:
            cache.read_rows(np.arange(c * 32, c * 32 + 4))
        assert cache.dynamic_capacity == 3
        before = cache.stats.dynamic_hits
        cache.read_rows(np.arange(4 * 32, 6 * 32))
        cache.read_rows(np.arange(4 * 32, 6 * 32))
        assert cache.stats.dynamic_hits >= before + 3
        hits[name] = (cache.stats.dynamic_hits, cache.stats.static_reads,
                      cache.stats.fill_chunks)
    assert hits["repro"] == hits["repro_torch"]
    assert pkg in hits


def test_chunked_store_shim_is_the_dfs_tier(tmp_path):
    from repro_torch.core.inference import store as shim

    assert issubclass(shim.ChunkedEmbeddingStore, torch_storage.DFSTier)
    assert shim.IOCost is torch_storage.IOCost
    assert shim.chunk_runs is torch_storage.store.chunk_runs
    a = shim.ChunkedEmbeddingStore(str(tmp_path / "a"), 100, 3, chunk_rows=16)
    b = jax_inference.ChunkedEmbeddingStore(str(tmp_path / "b"), 100, 3, chunk_rows=16)
    vals = np.random.default_rng(0).standard_normal((100, 3)).astype(np.float32)
    for s in (a, b):
        s.write_rows(np.arange(100), vals)
    rows = np.array([3, 17, 18, 64, 99])
    assert np.array_equal(a.read_rows(rows), b.read_rows(rows))
    assert (a.stats.chunk_reads, a.stats.chunk_writes) == (b.stats.chunk_reads,
                                                          b.stats.chunk_writes)


def test_both_cache_stats_names_are_one_class(port_graph, partitioned, tmp_path, layers):
    """The engine's ``LayerStats.cache`` and the package's ``CacheStats``
    (the shim's, as ``repro/core/inference/__init__.py`` exports it) are
    one class; an engine run fills it."""
    assert torch_inference.CacheStats is torch_engine.CacheStats
    assert torch_inference.CacheStats is torch_inference.cache.CacheStats
    assert isinstance(torch_inference.LayerStats().cache, torch_inference.CacheStats)
    g = port_graph
    res = torch_inference.LayerwiseInferenceEngine(
        g, _client("repro_torch", g, partitioned[0]), layers, g.vertex_feats, str(tmp_path),
        fanouts=[5, 5], chunk_rows=128, out_dims=[16, 16], device="cpu",
    ).run()
    stats = res.layer_stats[1].cache
    assert isinstance(stats, torch_inference.CacheStats)
    assert stats.rows_served > 0 and res.total_chunk_reads() == sum(
        s.cache.static_reads for s in res.layer_stats)


def test_the_package_exports_what_the_reference_exports():
    assert set(jax_inference.__all__) <= set(torch_inference.__all__)
    assert {"InferenceResult", "LayerStats"} <= set(torch_inference.__all__)
    for name in torch_inference.__all__:
        assert getattr(torch_inference, name) is not None


def test_importing_the_inference_package_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.core.inference as m\n"
        "m.samplewise_inference, m.TwoLevelCache, m.ChunkedEmbeddingStore\n"
        "print(','.join(sorted(k for k in sys.modules\n"
        "                      if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
