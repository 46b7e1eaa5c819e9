"""The port's launch-shape autotuner against the JAX package's, on the CPU.

Keys, measurement inputs, the tuned-op list and the layer slices' kernel
shapes must equal the reference's exactly. The rest is the port's own
contract: the artifact's identity and atomic write, the tie rule (on
injected times), the engine hook's calls (through a recorder over the
engine's ``autotune_for_slice``), the launch shape a wrapper passes to
the library, the refusal on a CPU device, and the config check's messages.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as jax_api  # noqa: E402
from repro.kernels import autotune as ref  # noqa: E402
from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
import repro_torch.api as torch_api  # noqa: E402
from repro_torch.core.inference import engine as engine_mod  # noqa: E402
from repro_torch.graph import power_law_graph as torch_graph  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.models.gnn import GNNModel, load_jax_params  # noqa: E402

SHAPES = [(1, 1, 1), (200, 50, 16), (256, 64, 16), (257, 65, 17), (65536, 4096, 256),
          (40960, 4096, 1), (3000, 700, 100)]
DTYPES = [(np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(autouse=True)
def _fresh_table():
    at.reset()
    yield
    at.reset()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", at.TUNED_OPS)
def test_tuned_key_is_the_reference_s(op, shape):
    for jdt, tdt in DTYPES:
        want = ref.tuned_key(op, shape, jdt)
        assert at.tuned_key(op, shape, tdt) == want
        assert at.tuned_key(op, shape, at.dtype_name(tdt)) == want
    assert at.tuned_key(op, shape, np.dtype("float32")) == ref.tuned_key(op, shape, "float32")
    assert at.tuned_key("gather_spmm", (200, 50, 16), torch.float32) == \
        "gather_spmm/256x64x16/float32"


def test_tuned_ops_are_the_reference_s():
    assert at.TUNED_OPS == ref.TUNED_OPS
    assert set(at.CANDIDATES) == set(ref.CANDIDATES)


@pytest.mark.parametrize("shape", [(1, 1, 1), (200, 50, 16), (1000, 300, 7)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_inputs_are_the_reference_s_bitwise(shape, dtypes):
    jdt, tdt = dtypes
    want = ref._inputs("segment_spmm", shape, jdt)
    got = at._inputs("segment_spmm", shape, tdt, device="cpu")
    assert got["n"] == want["n"]
    for name in ("seg", "idx", "feats", "msg", "logits"):
        w = np.asarray(want[name])
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), name
        else:
            assert at.dtype_name(g.dtype) == w.dtype.name, name
            assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat", "hgt"])
def test_kernel_shapes_are_the_reference_s(kind):
    kw = dict(hidden=24, num_layers=2, num_heads=3, num_etypes=2)
    jm = JaxGNN(kind, 16, **kw)
    params = jm.init(jax.random.PRNGKey(0))
    tm = GNNModel(kind, 16, device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    for k in range(2):
        want = jm.embed_layer_fn(params, k).kernel_shapes
        got = tm.embed_layer_fn(k).kernel_shapes
        for args in ((4096, 512, 16), (256, 64, 24), (65536, 4096, 1)):
            assert got(*args) == want(*args), (k, args)


# -- the heuristic and the candidates ----------------------------------------


def _aligned(rows, d, dtype):
    return torch.zeros((rows, d), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 64, 1), (4096, 512, 3), (65536, 4096, 128),
                                   (1024, 1024, 256), (512, 1024, 64), (64, 64, 8)])
def test_default_config_is_what_the_wrappers_launch_untuned(shape, dtype):
    e, n, d = shape
    msg, out = _aligned(e, d, dtype), _aligned(n, d, dtype)
    vec, tpr = fused_gnn._vec_tpr(d, msg, out)
    lean = fused_gnn._lean(e, n, dtype)
    assert at.default_config("segment_spmm_ragged", shape, dtype) == at.KernelConfig(vec, tpr, lean)
    assert at.default_config("gat_softmax_aggregate", shape, dtype) == at.KernelConfig(vec, tpr, 1)
    assert fused_gnn._launch_shape("segment_spmm_ragged", None, e, n, d, msg, out) == (
        vec, tpr, lean)


@pytest.mark.parametrize("op", at.TUNED_OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_valid_candidates_start_with_the_heuristic_and_follow_the_rule(op, dtype):
    for shape in ((65536, 4096, 256), (40960, 4096, 1), (16384, 64, 64), (300, 20, 12)):
        cands = at.valid_candidates(op, shape, dtype)
        assert cands[0] == at.default_config(op, tuple(at._pow2(s) for s in shape), dtype)
        row = at._pow2(shape[2])
        grid = at.CANDIDATES[op][dtype]
        rest = [c for c in grid if row % c.vec == 0 and c.tpr * c.vec <= row]
        assert list(cands[1:]) == [c for c in rest if c != cands[0]]
        assert len(set(cands)) == len(cands)
        assert all(c.vec * torch.tensor([], dtype=at._DTYPES[dtype]).element_size() <= 16
                   for c in cands)
    if op == "segment_max":
        assert len(at.CANDIDATES[op][dtype]) == 1
    elif op == "gat_softmax_aggregate":
        assert {c.lean for c in at.CANDIDATES[op][dtype]} == {1}
    else:
        assert {c.lean for c in at.CANDIDATES[op][dtype]} == {0, 1}


@pytest.mark.parametrize(
    "times, want",
    [
        ([1.0, 1.0, 0.98, 0.971], 0),  # within 3% of the heuristic: it stays
        ([1.0, 0.96, 0.95, 0.935], 1),  # 0.96 wins; 0.95 and 0.935 are not 3% below it
        ([1.0, 0.96, 0.93, 0.905], 2),
        ([1.0, 1.2, 0.5, 0.49], 2),
        ([2.0], 0),
        ([1.0, 0.9699], 1),
    ],
)
def test_tie_rule_keeps_the_best_so_far_within_the_margin(times, want):
    assert at._pick(times) == want


def test_tie_rule_through_autotune_with_injected_times(monkeypatch, tmp_path):
    """The sweep's injected times pick the winner, the table and the
    artifact keep it, and the second call is a memory hit."""
    shape, dtype = (4096, 512, 128), torch.float32
    cands = at.valid_candidates("segment_spmm_ragged", shape, dtype)
    times = [1.0] * len(cands)
    times[3], times[5] = 0.96, 0.94  # 5 is within 3% of 3: 3 wins
    monkeypatch.setattr(at.torch.cuda, "get_device_name", lambda *a: "card A")
    monkeypatch.setattr(at, "_sweep", lambda *a: (cands, times))
    monkeypatch.setattr(at.torch.cuda, "device", lambda d: _NullContext())
    got = at.autotune("segment_spmm_ragged", shape, dtype, cache_dir=str(tmp_path))
    assert got == cands[3]
    assert at.get_tuned("segment_spmm_ragged", (4000, 300, 100), dtype) == cands[3]
    assert at.get_tuned("segment_spmm_ragged", shape, torch.bfloat16) is None
    assert at.autotune("segment_spmm_ragged", shape, dtype, cache_dir=str(tmp_path)) == cands[3]
    assert at.stats() == {"memory_hits": 1, "artifact_hits": 0, "measured": 1}
    rec = at.sweeps()[at.tuned_key("segment_spmm_ragged", shape, dtype)]
    assert rec["heuristic"] == dataclasses.asdict(cands[0]) and rec["winner_ms"] == 0.96
    at.reset(clear_stats=False)
    assert at.autotune("segment_spmm_ragged", shape, dtype, cache_dir=str(tmp_path)) == cands[3]
    assert at.stats() == {"memory_hits": 1, "artifact_hits": 1, "measured": 1}


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- the artifact --------------------------------------------------------------


def test_artifact_round_trip_and_atomic_write(tmp_path, monkeypatch):
    cfgs = {"segment_spmm_ragged/256x64x16/float32": at.KernelConfig(4, 8, 0),
            "gat_softmax_aggregate/256x64x64/bfloat16": at.KernelConfig(8, 8, 1)}
    at._store_artifact(str(tmp_path), cfgs, "card A")
    assert at._load_artifact(str(tmp_path), "card A") == cfgs
    assert at._load_artifact(str(tmp_path), "card B") == {}
    path = at.artifact_path(str(tmp_path), "card A")
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]  # no temporary file left
    payload = json.loads(open(path).read())
    assert payload["device"] == "card A" and payload["version"] == at.TUNE_VERSION

    # a write that fails before the rename leaves the old artifact whole
    def broken(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(at.os, "replace", broken)
    with pytest.raises(OSError):
        at._store_artifact(str(tmp_path), {}, "card A")
    monkeypatch.undo()
    assert at._load_artifact(str(tmp_path), "card A") == cfgs
    with open(path, "w") as f:
        f.write("{not json")
    assert at._load_artifact(str(tmp_path), "card A") == {}


def test_identity_digest_moves_with_version_grid_and_card(monkeypatch, tmp_path):
    d = str(tmp_path)
    base = at.artifact_path(d, "NVIDIA H100 80GB HBM3")
    assert at.artifact_path(d, "NVIDIA H100 80GB HBM3") == base
    assert at.artifact_path(d, "NVIDIA H200") != base
    monkeypatch.setattr(at, "TUNE_VERSION", at.TUNE_VERSION + 1)
    assert at.artifact_path(d, "NVIDIA H100 80GB HBM3") != base
    monkeypatch.undo()
    grid = dict(at.CANDIDATES)
    grid["segment_max"] = {k: (at.KernelConfig(2, 1, 1),) for k in grid["segment_max"]}
    monkeypatch.setattr(at, "CANDIDATES", grid)
    assert at.artifact_path(d, "NVIDIA H100 80GB HBM3") != base
    monkeypatch.undo()
    assert at.artifact_path(d, "NVIDIA H100 80GB HBM3") == base
    assert os.path.basename(base) != os.path.basename(ref.artifact_path(d))


# -- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_tuner_raises_on_a_cpu_device(device):
    with pytest.raises(ValueError, match="CUDA device"):
        at.autotune("segment_spmm_ragged", (256, 64, 16), torch.float32, device=device)
    with pytest.raises(ValueError, match="CUDA device"):
        at.autotune_for_slice([("gat_softmax_aggregate", (256, 64, 8))], np.float32,
                              device=device)
    with pytest.raises(ValueError, match="unknown tuned op"):
        at.autotune("flash_attention", (256, 64, 16), torch.float32)
    assert at.stats() == {"memory_hits": 0, "artifact_hits": 0, "measured": 0}


@pytest.mark.parametrize("bad", ["", 5])
def test_config_kernel_cache_dir_check_is_the_reference_s(bad):
    with pytest.raises(ValueError) as want:
        jax_api.GLISPConfig(kernel_cache_dir=bad).validate()
    with pytest.raises(ValueError) as got:
        torch_api.GLISPConfig(kernel_cache_dir=bad).validate()
    assert str(got.value) == str(want.value)


def test_config_autotune_needs_no_use_kernel_flag():
    """The reference demands ``infer_use_kernel=True``; the port has no
    such field (the device picks the kernel), so the config validates and
    a CPU pass refuses at the tuner instead."""
    with pytest.raises(ValueError, match="infer_use_kernel"):
        jax_api.GLISPConfig(kernel_autotune=True).validate()
    cfg = torch_api.GLISPConfig(kernel_autotune=True, kernel_cache_dir="tune")
    assert cfg.validate() is cfg
    assert cfg.to_dict()["kernel_autotune"] is True


# -- launch shapes -------------------------------------------------------------


def test_tuned_launch_shape_is_read_and_vec_capped_by_the_pointers():
    e, n, d = 4096, 512, 128
    msg = _aligned(e + 1, d, torch.bfloat16)
    out = _aligned(n, d, torch.bfloat16)
    key_shape = (e, n, d)
    at._TUNED[at.tuned_key("segment_spmm_ragged", key_shape, torch.bfloat16)] = \
        at.KernelConfig(8, 4, 1)
    ok = msg[:e]
    assert fused_gnn._launch_shape("segment_spmm_ragged", None, e, n, d, ok, out) == (8, 4, 1)
    # a view 2 elements (4 bytes) in: 8 and 4 elements no longer align
    off = msg.view(-1)[2: 2 + e * d].view(e, d)
    assert fused_gnn._launch_shape("segment_spmm_ragged", None, e, n, d, off, out) == (2, 4, 1)
    # a row the bucket's vec does not divide (100 in the bucket of 128)
    row = _aligned(e, 100, torch.bfloat16)
    at._TUNED[at.tuned_key("segment_spmm_ragged", (e, n, 100), torch.bfloat16)] = \
        at.KernelConfig(8, 2, 0)
    assert fused_gnn._launch_shape("segment_spmm_ragged", None, e, n, 100, row) == (4, 2, 0)
    # no op (the backwards, the tools' direct launches): the heuristic
    assert fused_gnn._launch_shape(None, None, e, n, d, ok, out) == (
        *fused_gnn._vec_tpr(d, ok, out), fused_gnn._lean(e, n, torch.bfloat16))
    # a forced config (the tuner's candidates) wins over the table
    forced = at.KernelConfig(1, 32, 0)
    assert fused_gnn._launch_shape("segment_spmm_ragged", forced, e, n, d, ok, out) == (1, 32, 0)


class _Library:
    """Records the sum kernel's C calls in place of the library."""

    def __init__(self):
        self.calls = []

    def segment_sum_scratch_rows(self, e):
        return 2

    def segment_sum(self, *args):
        self.calls.append(("segment_sum", args))
        return 0

    def gather_segment_sum(self, *args):
        self.calls.append(("gather_segment_sum", args))
        return 0


class _Stream:
    cuda_stream = 0


def test_launches_pass_the_winner_to_the_library(monkeypatch):
    """``launch_segment_sum`` / ``launch_gather_sum`` under a tuned op pass
    the winner's (vec, tpr, lean) to the C entry; with no op, the
    heuristic's. The tensors here are CPU stand-ins for the pointers."""
    lib = _Library()
    monkeypatch.setattr(fused_gnn, "library", lambda stem: lib)
    monkeypatch.setattr(fused_gnn.torch.cuda, "current_stream", lambda: _Stream())
    e, n, d = 256, 64, 32
    msg, out = _aligned(e, d, torch.float32), _aligned(n, d, torch.float32)
    seg = torch.zeros(e, dtype=torch.int32)
    index = torch.zeros(n + 2 + 2 * 4, dtype=torch.int32)
    win = at.KernelConfig(2, 16, 0)
    at._TUNED[at.tuned_key("segment_spmm_ragged", (e, n, d), torch.float32)] = win
    at._TUNED[at.tuned_key("gather_spmm", (e, n, d), torch.float32)] = at.KernelConfig(1, 4, 0)
    fused_gnn.launch_segment_sum(msg, seg, index, out, op="segment_spmm_ragged")
    fused_gnn.launch_segment_sum(msg, seg, index, out)
    fused_gnn.launch_gather_sum(msg, seg, seg, index, out, op="gather_spmm")
    fused_gnn.launch_gather_sum(msg, seg, seg, index, out, op="gather_spmm_ragged")
    heur = (*fused_gnn._vec_tpr(d, msg, out), fused_gnn._lean(e, n, torch.float32))
    # (vec, tpr, lean) sit after (dtype code) in both C signatures
    picked = [args[-7:-4] for _, args in lib.calls]
    assert picked == [(2, 16, 0), heur, (1, 4, 0), heur]


# -- the engine hook -----------------------------------------------------------

GRAPH = dict(num_vertices=1200, avg_degree=6, seed=5, feat_dim=16, num_classes=4)


@pytest.fixture(scope="module")
def system():
    return torch_api.GLISPSystem.build(
        torch_graph(**GRAPH), torch_api.GLISPConfig(num_parts=2, fanouts=(6, 4), seed=0))


def _fns(kind):
    jm = JaxGNN(kind, GRAPH["feat_dim"], hidden=16, num_layers=2, num_heads=2)
    params = jm.init(jax.random.PRNGKey(1))
    tm = GNNModel(kind, GRAPH["feat_dim"], hidden=16, num_layers=2, num_heads=2, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return [tm.embed_layer_fn(k) for k in range(2)], [jm.embed_layer_fn(params, k)
                                                       for k in range(2)]


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_engine_tunes_each_new_layer_bucket_once_before_its_first_slice(
        system, kind, tmp_path, monkeypatch):
    fns, ref_fns = _fns(kind)
    events = []

    def recorder(shapes, dtype, *, cache_dir=None, device="cuda"):
        events.append(("tune", list(shapes), at.dtype_name(dtype), cache_dir, str(device)))

    for k, fn in enumerate(fns):
        def sliced(h_self, h_nbr, seg, etype, _k=k, _fn=fn.torch):
            events.append(("slice", _k, h_self.shape[0], seg.shape[0]))
            return _fn(h_self, h_nbr, seg, etype)
        fn.torch = sliced
    monkeypatch.setattr(engine_mod, "autotune_for_slice", recorder)
    cache = str(tmp_path / "tune")
    res = system.infer_layerwise(fns, str(tmp_path / "run"), out_dims=[16, 16], batch_size=256,
                                 device="cpu", kernel_autotune=True, kernel_cache_dir=cache)
    eng = system.infer_engine
    assert eng.kernel_autotune and eng.kernel_cache_dir == cache
    tunes = [ev for ev in events if ev[0] == "tune"]
    assert len(tunes) == eng.shape_count() == res.slice_shapes > 0
    seen = set()
    for i, ev in enumerate(events):
        if ev[0] != "slice":
            continue
        key = ev[1:]
        if key not in seen:
            seen.add(key)
            # the slice right before is this bucket's tune, with its shapes
            k, bp, ep = key
            din = GRAPH["feat_dim"] if k == 0 else 16
            want = [(op, tuple(s)) for op, s in ref_fns[k].kernel_shapes(ep, bp, din)]
            assert events[i - 1] == ("tune", want, "float32", cache, "cpu"), key
    assert len(seen) == len(tunes)
    # a pass again through the same engine tunes nothing new
    system.infer_layerwise(fns, str(tmp_path / "run"), out_dims=[16, 16], batch_size=256,
                           device="cpu", kernel_autotune=True, kernel_cache_dir=cache)
    assert system.infer_engine is eng
    assert len([ev for ev in events if ev[0] == "tune"]) == len(tunes)
    # the tuning settings are part of the engine's reuse key
    system.infer_layerwise(fns, str(tmp_path / "run2"), out_dims=[16, 16], batch_size=256,
                           device="cpu")
    assert system.infer_engine is not eng and not system.infer_engine.kernel_autotune
    assert len([ev for ev in events if ev[0] == "tune"]) == len(tunes)


def test_autotuned_pass_on_the_cpu_raises_at_the_first_bucket(system, tmp_path):
    fns, _ = _fns("sage")
    with pytest.raises(ValueError, match="CUDA device"):
        system.infer_layerwise(fns, str(tmp_path / "run"), out_dims=[16, 16], batch_size=256,
                               device="cpu", kernel_autotune=True)
    cfg_system = torch_api.GLISPSystem.build(
        torch_graph(**GRAPH),
        torch_api.GLISPConfig(num_parts=2, fanouts=(6, 4), seed=0, kernel_autotune=True))
    with pytest.raises(ValueError, match="CUDA device"):
        cfg_system.infer_layerwise(fns, str(tmp_path / "cfg"), out_dims=[16, 16],
                                   batch_size=256, device="cpu")
