"""The port's production-mesh dry run against the JAX package's, on the CPU.

The sharding rules, head padding and the mesh form of the roofline are held
to the reference's entry by entry, for every architecture on both meshes.
Head padding and repeat mode are held to JAX's forward, prefill and decode
on the same ``load_jax_params`` weights (reduced float32 configs, the LM
tests' tolerance: rtol 2e-5 / atol 2e-5). Whatever creates a process group
(the collective recorder, ``run_one``) runs in a subprocess: the group is
per process.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.launch import shardings as jax_shardings  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models.transformer import model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import roofline, shardings, specs  # noqa: E402
from repro_torch.models.transformer import model  # noqa: E402
from repro_torch.models.transformer.moe import shard_g  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Just enough of a Mesh for the sharding rule functions."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _configs(arch, shape):
    """(port, JAX) configs as the dry run resolves them at a model axis of 16."""
    return (specs.resolve_config(get_config(arch), shape, model_axis=16),
            jax_specs.resolve_config(jax_get_config(arch), shape, model_axis=16))


def _ref_layers(tree, cfg):
    """The reference's stacked stage trees, one per layer (leading axis kept
    as the first entry of each leaf), in model order."""
    out = []
    for (kinds, reps), stage in zip(model.stage_plan(cfg), tree):
        for r in range(reps):
            out.extend(stage[ki] for ki in range(len(kinds)))
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _spec(p):
    return tuple(p)


def _same_layer_specs(port_layers, ref_layers):
    assert len(port_layers) == len(ref_layers)
    for got, want in zip(port_layers, ref_layers):
        g, w = dict(_flat(got)), dict(_flat(want))
        assert sorted(g) == sorted(w)
        for path in g:
            assert g[path] == _spec(w[path])[1:], path  # the port keeps no layer axis


def _ref_bytes(shapes, pspecs, mesh):
    """Bytes one device holds under the reference's specs (leaves with
    PartitionSpecs), and the bytes of its ``pos`` leaves."""
    total = pos = 0
    sh = jax.tree_util.tree_leaves_with_path(shapes)
    sp = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(sh, sp):
        dims = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    dims[i] //= mesh.shape[axis]
        nbytes = math.prod(dims) * leaf.dtype.itemsize
        total += nbytes
        if str(getattr(path[-1], "key", "")) == "pos":
            pos += nbytes
    return total, pos


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_leaf_by_leaf(arch, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    for shape in ("train_4k", "decode_32k"):  # padded and unpadded heads
        cfg, jcfg = _configs(arch, shape)
        jshapes = jax_specs.params_shapes(jcfg)
        want = jax_shardings.param_specs(jcfg, jshapes, mesh)
        params = specs.params_shapes(cfg)
        got = shardings.param_specs(cfg, params, mesh)
        for key in ("embed", "final_norm", "head"):
            assert (key in got) == (key in want)
            if key in got:
                assert got[key] == _spec(want[key])
        _same_layer_specs(got["layers"], _ref_layers(want["stages"], cfg))
        # shapes and dtypes: the reference's eval_shape leaves
        for w, g in zip(_ref_layers(jshapes["stages"], cfg), params["layers"]):
            for (path, a), (_, b) in zip(_flat(w), _flat(g)):
                assert tuple(a.shape[1:]) == tuple(b.shape) and str(a.dtype) == "float32", path
                assert b.dtype == torch.float32 and b.device.type == "meta"
        ospecs = shardings.opt_state_specs(got)
        wospecs = jax_shardings.opt_state_specs(want)
        assert ospecs["step"] == _spec(wospecs["step"]) == ()
        _same_layer_specs(ospecs["mu"]["layers"], _ref_layers(wospecs["mu"]["stages"], cfg))
        sh = specs.SHAPES[shape]
        gb = shardings.batch_specs(cfg, sh["batch"], mesh)
        wb = jax_shardings.batch_specs(jcfg, sh["batch"], mesh)
        assert {k: v for k, v in gb.items()} == {k: _spec(v) for k, v in wb.items()}
        cache = specs.cache_shapes(cfg, sh["batch"], sh["seq"])
        jcache = jax_specs.cache_shapes(jcfg, sh["batch"], sh["seq"])
        _same_layer_specs(shardings.cache_specs(cfg, cache, mesh),
                          _ref_layers(jax_shardings.cache_specs(jcfg, jcache, mesh), cfg))
        # the bytes a device holds: the reference's specs' bytes, less its
        # per-layer int32 ``pos`` (a Python int in the port)
        want_bytes, pos_bytes = _ref_bytes(jcache, jax_shardings.cache_specs(jcfg, jcache, mesh),
                                           mesh)
        got_bytes = shardings.device_bytes(cache, shardings.cache_specs(cfg, cache, mesh), mesh)
        assert got_bytes == want_bytes - pos_bytes and pos_bytes == 4 * cfg.num_layers
        want_bytes, _ = _ref_bytes(jshapes, want, mesh)
        assert shardings.device_bytes(params, got, mesh) == want_bytes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pad_heads_and_resolve_config_equal_the_reference(arch):
    for msize in (4, 8, 16):
        for enable in (True, False):
            got = specs.pad_heads_for_mesh(get_config(arch), msize, enable_padding=enable)
            want = jax_specs.pad_heads_for_mesh(jax_get_config(arch), msize,
                                                enable_padding=enable)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (msize, enable)
    for model_axis in (0, 4, 16):
        for shape in specs.SHAPES:
            got = specs.resolve_config(get_config(arch), shape, model_axis=model_axis)
            want = jax_specs.resolve_config(jax_get_config(arch), shape, model_axis=model_axis)
            assert (got is None) == (want is None)
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (model_axis, shape)


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(MESHES["2x16x16"])
    assert shardings.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert shardings.placements((None, None), mesh) == [Replicate()] * 3
    one = FakeMesh({"data": 1, "model": 1})  # a size-1 axis holds the whole dim
    assert shardings.placements(("data", "model"), one) == [Replicate()] * 2
    assert shardings.local_shape((256, 4096, 14336), (("pod", "data"), None, "model"),
                                 mesh) == (8, 4096, 896)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    for shape in specs.SHAPES:
        cfg, jcfg = _configs(arch, shape)
        got = specs.input_specs(cfg, shape)
        want = jax_specs.input_specs(jcfg, shape)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)


# ---------------------------------------------------------------------------
# head padding and repeat mode against JAX
# ---------------------------------------------------------------------------


def _pair(arch, msize):
    """(port cfg, JAX cfg, JAX params, port params): a reduced config
    resolved for an ``msize``-way model axis by both packages."""
    jcfg = jax_specs.pad_heads_for_mesh(jax_get_config(arch, reduced=True), msize)
    cfg = specs.pad_heads_for_mesh(get_config(arch, reduced=True), msize)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = model.load_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("arch,msize,mode", [
    ("granite-3-2b", 3, "padded q heads"),  # 8 -> 12 heads, GQA groups 4 -> 6
    ("musicgen-medium", 3, "padded kv heads"),  # 4 -> 6 q and kv heads
    ("mixtral-8x7b", 8, "repeat"),  # kv 2, groups 4, q 8 over 8: kv repeated
])
def test_padded_and_repeat_mode_match_jax(arch, msize, mode):
    cfg, jcfg, jparams, params = _pair(arch, msize)
    padded = cfg.padded_q_heads != cfg.num_heads
    assert padded == (mode != "repeat")
    assert (cfg.padded_kv_heads != cfg.num_kv_heads) == (mode == "padded kv heads")
    assert params["layers"][0]["mixer"]["wq"].shape[1] == cfg.padded_q_heads * cfg.resolved_head_dim
    rng = np.random.default_rng(3)
    if cfg.input_mode == "embeddings":  # the audio stub: frame embeddings
        tok = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    else:
        tok = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)

    def t(a):
        return torch.tensor(a) if a.dtype == np.float32 else torch.tensor(a).long()

    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(tok))
    got, _, _ = model.forward(params, cfg, t(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    b, prompt, steps = 2, 12, 4
    jcache = jax_model.init_cache(jcfg, b, prompt + steps)
    cache = model.init_cache(cfg, b, prompt + steps, device="cpu")
    assert cache[0]["k"].shape[2] == cfg.padded_kv_heads
    jl, jcache = jax_specs.make_prefill_step(jcfg)(jparams, jcache,
                                                   {"inputs": jnp.asarray(tok[:, :prompt])})
    logits, cache = specs.make_prefill_step(cfg)(params, cache, {"inputs": t(tok[:, :prompt])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    for i in range(steps):
        nxt = tok[:, prompt + i:prompt + i + 1]
        jl, jcache = jax_specs.make_decode_step(jcfg)(jparams, jcache,
                                                      {"inputs": jnp.asarray(nxt)},
                                                      jnp.int32(prompt + i))
        logits, cache = specs.make_decode_step(cfg)(params, cache, {"inputs": t(nxt)},
                                                    prompt + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_shard_g_is_the_identity_on_plain_tensors():
    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True), moe_dispatch_groups=4,
                              data_axis_names=("data",), tp_size=4)
    t = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(0))
    for expert_dim in (False, True):
        out = shard_g(t, cfg, 4, expert_dim=expert_dim)
        assert out is t
        assert torch.equal(out, t.clone())


# ---------------------------------------------------------------------------
# the mesh roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_hbm_bytes_on_a_mesh_equals_the_reference(arch):
    for shape in specs.SHAPES:
        cfg, jcfg = _configs(arch, shape)
        for mesh_shape in [{}] + list(MESHES.values()):
            got = roofline.analytic_hbm_bytes(cfg, shape, mesh_shape)
            want = jax_roofline.analytic_hbm_bytes(jcfg, shape, mesh_shape)
            assert got == want, (shape, mesh_shape)
        # one card: the single-card form of the port, the reference's with {}
        assert roofline.analytic_hbm_bytes(cfg, shape) == jax_roofline.analytic_hbm_bytes(
            jcfg, shape, {})


def test_interconnect_rates_by_group_size():
    hw = roofline.hardware("NVIDIA H100 80GB HBM3")
    coll = {"bytes_by_group_ranks": {8: 450e9, 16: 50e9}}
    # 8 ranks: one node's NVLink, 1 s; 16 ranks span nodes: InfiniBand, 1 s
    assert roofline.collective_seconds(coll, hw) == pytest.approx(2.0)


def _run(code: str, timeout: int) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_recorder_counts_a_known_all_gather():
    """Shard(0) -> Replicate of a [64, 32] float32 tensor over 4 ranks: one
    all-gather whose result is the whole tensor, 64 * 32 * 4 bytes."""
    out = _run("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.roofline import CollectiveRecorder
        with fake_group(4):
            mesh = make_local_mesh(4)
            with FakeTensorMode() as fake:
                t = DTensor.from_local(torch.empty(16, 32), mesh, [Shard(0), Replicate()],
                                       run_check=False)
                rec = CollectiveRecorder(fake_mode=fake)
                with rec:
                    r = t.redistribute(mesh, [Replicate(), Replicate()])
                print(json.dumps([rec.totals(), rec.flops, list(r.to_local().shape)]))
        print(torch.distributed.is_initialized())
    """, 120)
    res, flops, local = json.loads(out.splitlines()[0])
    assert res["counts"]["all-gather"] == 1 and res["total_bytes"] == 64 * 32 * 4
    assert res["bytes"]["all-gather"] == 8192 and res["bytes_by_group_ranks"] == {"4": 8192}
    assert local == [64, 32] and flops == 0
    assert out.splitlines()[1] == "False"  # the group is destroyed


def test_run_one_mamba2_decode_on_the_single_mesh(tmp_path):
    out = _run(f"""
        import json, torch
        from repro_torch.launch.dryrun import run_one
        r = run_one("mamba2-130m", "decode_32k", False, {str(tmp_path)!r}, verbose=False)
        print(json.dumps(r))
        print(torch.distributed.is_initialized())
    """, 240)
    res = json.loads(out.splitlines()[0])
    assert out.splitlines()[1] == "False"
    saved = json.loads((tmp_path / "mamba2-130m_decode_32k_single.json").read_text())
    assert saved == res
    assert sorted(res) == sorted(["arch", "shape", "mesh", "num_chips", "trace_s", "memory",
                                  "collectives", "roofline"])
    assert res["mesh"] == "16x16" and res["num_chips"] == 256
    assert sorted(res["memory"]) == sorted(["argument_bytes", "output_bytes", "temp_bytes",
                                            "peak_bytes_per_device"])
    assert sorted(res["collectives"]) == sorted(["bytes", "counts", "total_bytes",
                                                 "bytes_by_group_ranks"])
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "step_time_bound_s",
                "analytic_flops_global", "model_flops_6nd_global", "useful_flops_ratio",
                "traced_flops_per_device", "analytic_bytes_per_device",
                "collective_bytes_per_device"):
        assert key in res["roofline"], key
    # argument bytes: the reference's specs' bytes for params, cache and
    # inputs, less the per-layer ``pos`` scalars (Python ints in the port)
    jcfg = jax_specs.resolve_config(jax_get_config("mamba2-130m"), "decode_32k", model_axis=16)
    mesh = FakeMesh(MESHES["16x16"])
    jp = jax_specs.params_shapes(jcfg)
    pbytes, _ = _ref_bytes(jp, jax_shardings.param_specs(jcfg, jp, mesh), mesh)
    jc = jax_specs.cache_shapes(jcfg, 128, 32768)
    cbytes, pos = _ref_bytes(jc, jax_shardings.cache_specs(jcfg, jc, mesh), mesh)
    ins = jax_specs.input_specs(jcfg, "decode_32k")
    ibytes, _ = _ref_bytes(ins, {"inputs": jax_shardings.batch_specs(jcfg, 128, mesh)["inputs"]},
                           mesh)
    assert res["memory"]["argument_bytes"] == pbytes + cbytes - pos + ibytes
    assert res["memory"]["peak_bytes_per_device"] >= res["memory"]["argument_bytes"]
    assert res["roofline"]["traced_flops_per_device"] > 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mixtral_argument_bytes_per_device(mesh_name):
    """mixtral-8x7b's per-device arguments under the rules, with no run:
    float32 params (and AdamW moments in training), the cache and inputs,
    each below the card's 80 GB."""
    from repro_torch.launch.dryrun import build_arguments, resolve

    mesh = FakeMesh(MESHES[mesh_name])
    got = {}
    for shape in specs.SHAPES:
        cfg = resolve("mixtral-8x7b", shape, mesh_name != "16x16")
        tree, spec = build_arguments(cfg, shape, mesh)
        got[shape] = shardings.device_bytes(tree, spec, mesh)
        assert 0 < got[shape] < 80e9 and math.isfinite(got[shape])
        if shape == "train_4k":  # params and two moments of them, and the batch
            params = shardings.device_bytes(tree["params"], spec["params"], mesh)
            batch = shardings.device_bytes(tree["batch"], spec["batch"], mesh)
            assert got[shape] == 3 * params + batch + 4  # and the int32 step
            # 46.7 B float32 parameters, most of them over a model axis of 16
            assert 4 * cfg.num_params() / 16 < params < 1.1 * 4 * cfg.num_params() / 16
    print(mesh_name, {k: round(v / 2**30, 3) for k, v in got.items()})
