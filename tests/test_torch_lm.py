"""The port's transformer serving path against the JAX package, on the CPU.

Configs are the reduced ones (float32): dense, SSM, and the MoE family
(deepseek-v2-lite with MLA, mixtral-8x7b with a sliding window). Parameters come from
``repro.models.transformer.model.init_params(cfg, PRNGKey(0))`` and are
carried across with ``load_jax_params``; both sides get the same numpy
inputs. The JAX Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them.

Tolerances: logits and caches float32 rtol 2e-5 / atol 2e-5 (two
frameworks' matmuls and sums in another order, through two layers; the
largest error seen is 2e-6 on logits of magnitude 1.5);
single attention and SSD calls rtol 2e-5 / atol 2e-5 (one op, sums in
another order); the sequential SSD against the chunked one rtol 2e-4 /
atol 2e-4 (another algorithm), as ``tests/test_kernels.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, DASHED  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models.transformer import layers as jax_layers  # noqa: E402
from repro.models.transformer import model as jax_model  # noqa: E402
from repro.models.transformer.ssm import ssd_chunked_jnp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref, ssd_scan_ref  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.serve import main, serve  # noqa: E402
from repro_torch.models.transformer import layers, model  # noqa: E402

LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
OP_TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)

DASHED_IDS = sorted({v: k for k, v in DASHED.items()}.values())


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _pair(arch, **changes):
    """(port cfg, JAX cfg, JAX params, port params) for a reduced config."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = model.load_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jcfg, jparams, params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DASHED_IDS)
def test_get_config_matches_the_jax_registry(arch, reduced):
    got = dataclasses.asdict(get_config(arch, reduced))
    want = dataclasses.asdict(jax_get_config(arch, reduced))
    assert got == want
    assert type(get_config(arch, reduced)).__module__.startswith("repro_torch.")


def test_registry_lists_the_same_ids():
    from repro_torch.configs import ARCH_IDS as PORT_IDS
    from repro_torch.configs import all_configs

    assert PORT_IDS == ARCH_IDS
    assert sorted(all_configs(True)) == sorted(ARCH_IDS)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels and the JAX paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,d", [(64, 64, 32), (100, 100, 64), (1, 200, 32), (50, 130, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37), (False, 0)])
def test_attention_ref_matches_flash_pallas(sq, skv, d, causal, window):
    rng = np.random.default_rng(sq + d)
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32) for n in (sq, skv, skv))
    off = skv - sq if sq < skv else 0
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  window=window, kv_offset=off, block_q=32, block_kv=32)
    got = attention_ref(_t(q)[None, :, None], _t(k)[None, :, None], _t(v)[None, :, None],
                        causal=causal, window=window, kv_offset=off)
    np.testing.assert_allclose(_np(got[0, :, 0]), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100)])
@pytest.mark.parametrize("s", [129, 257])
@pytest.mark.parametrize("d,dv", [(256, 256), (192, 128)])
def test_attention_ref_matches_jax_at_the_path_widths(d, dv, s, causal, window):
    """The plain version that the card's flash kernel is held against, at
    the prefill paths' widths and across the kernel's 64-key and 128-query
    tile edges: gemma-2b's D 256 (8 query heads over 1 KV head, here 2
    over 1) against the Pallas kernel in interpret mode through the JAX
    package's ``mha_attention``; MLA's 192 over 128 against the JAX
    package's attention for unequal widths (``layers._dense_attention``;
    the Pallas kernel takes one width)."""
    rng = np.random.default_rng(s + d)
    hkv = 1 if d == dv else 2
    q = rng.standard_normal((1, s, 2, d)).astype(np.float32)
    k = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, s, hkv, dv)).astype(np.float32)
    if d == dv:
        want = jax_ops.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, window=window, kv_offset=0)
    else:
        want = jax_layers._dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window, q_offset=0)
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window, kv_offset=0)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize(
    "b,sq,skv,h,hkv,d,window,off",
    [(2, 40, 40, 4, 1, 32, 0, 0), (1, 70, 70, 8, 2, 64, 16, 0), (2, 9, 30, 4, 2, 32, 0, 21)],
)
def test_mha_attention_matches_jax_gqa(b, sq, skv, h, hkv, d, window, off, use_kernel):
    rng = np.random.default_rng(h + d)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    want = jax_ops.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                 window=window, kv_offset=off, use_kernel=use_kernel)
    got = ops.mha_attention(_t(q), _t(k), _t(v), causal=True, window=window, kv_offset=off)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("fn", ["_dense_attention", "_blockwise_attention"])
@pytest.mark.parametrize("causal,window,off", [(True, 0, 0), (True, 300, 0), (False, 0, 5)])
def test_model_attention_paths_match_jax(fn, causal, window, off):
    """Both CPU paths over more than one of the blockwise path's blocks."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 1100, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1100, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)
    want = getattr(jax_layers, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = getattr(layers, fn)(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP_TOL)


def _ssd_inputs(bz, s, h, p, g, n, seed, init=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bz, s, h, p)).astype(np.float32)
    dt = (rng.random((bz, s, h)) * 0.5 + 0.01).astype(np.float32)
    A = (-rng.random(h) - 0.1).astype(np.float32)
    B = rng.standard_normal((bz, s, g, n)).astype(np.float32)
    C = rng.standard_normal((bz, s, g, n)).astype(np.float32)
    st = rng.standard_normal((bz, h, p, n)).astype(np.float32) if init else None
    return x, dt, A, B, C, st


@pytest.mark.parametrize("S,P,N,chunk", [(64, 16, 8, 16), (100, 32, 16, 32), (33, 8, 4, 16)])
def test_ssd_chunked_ref_matches_ssd_scan_pallas(S, P, N, chunk):
    x, dt, A, B, C, _ = _ssd_inputs(1, S, 1, P, 1, N, S)
    a = dt * A
    want_y, want_st = ssd_scan_pallas(jnp.asarray(x[0, :, 0]), jnp.asarray(a[0, :, 0]),
                                      jnp.asarray(dt[0, :, 0]), jnp.asarray(B[0, :, 0]),
                                      jnp.asarray(C[0, :, 0]), chunk=chunk)
    y, st = ssd_chunked_ref(_t(x), _t(a), _t(dt), _t(B), _t(C), chunk=chunk)
    np.testing.assert_allclose(_np(y[0, :, 0]), np.asarray(want_y), **OP_TOL)
    np.testing.assert_allclose(_np(st[0, 0]), np.asarray(want_st), **OP_TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [(48, 16), (50, 16), (7, 16)])
def test_ssd_chunked_ref_matches_ssd_chunked_jnp(S, chunk, init):
    """Grouped B/C (G = 2 < H = 4), ragged S, and a nonzero initial state."""
    x, dt, A, B, C, st = _ssd_inputs(2, S, 4, 8, 2, 6, S, init)
    a = dt * A
    want_y, want_st = ssd_chunked_jnp(
        *(jnp.asarray(t) for t in (x, a, dt, B, C)), chunk=chunk,
        init_state=None if st is None else jnp.asarray(st),
    )
    y, state = ssd_chunked_ref(_t(x), _t(a), _t(dt), _t(B), _t(C), chunk=chunk,
                               init_state=None if st is None else _t(st))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **OP_TOL)
    np.testing.assert_allclose(_np(state), np.asarray(want_st), **OP_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_ssd_scan_matches_jax(use_kernel):
    x, dt, A, B, C, _ = _ssd_inputs(2, 40, 4, 8, 2, 6, 11)
    want = jax_ops.ssd_scan(*(jnp.asarray(t) for t in (x, dt, A, B, C)), chunk=16,
                            use_kernel=use_kernel)
    y, _ = ops.ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk=16)
    np.testing.assert_allclose(_np(y), np.asarray(want), **SCAN_TOL)


def test_ssd_scan_ref_matches_jax_and_the_chunked_form():
    from repro.kernels.ref import ssd_scan_ref as jax_ssd_scan_ref

    x, dt, A, B, C, _ = _ssd_inputs(1, 45, 4, 8, 2, 6, 3)
    want = jax_ssd_scan_ref(*(jnp.asarray(t[0]) for t in (x, dt)), jnp.asarray(A),
                            *(jnp.asarray(t[0]) for t in (B, C)))
    got = ssd_scan_ref(_t(x[0]), _t(dt[0]), _t(A), _t(B[0]), _t(C[0]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP_TOL)
    y, _ = ssd_chunked_ref(_t(x), _t(dt * A), _t(dt), _t(B), _t(C), chunk=16)
    np.testing.assert_allclose(_np(y[0]), _np(got), **SCAN_TOL)


# ---------------------------------------------------------------------------
# numerics the layers pin
# ---------------------------------------------------------------------------


def test_rms_norm_rope_and_mm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(_np(layers.rms_norm(_t(x), _t(w))),
                               np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    pos = np.tile(np.arange(7, 12, dtype=np.int32), (2, 1))
    np.testing.assert_allclose(
        _np(layers.apply_rope(_t(x), _t(pos), 10000.0)),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=1e-5, atol=1e-5,
    )
    # times w, not 1 + w; halves rotated, not interleaved pairs
    xt = _t(x)
    assert torch.allclose(layers.rms_norm(xt, torch.zeros(16)), torch.zeros_like(xt))
    rot = layers.apply_rope(torch.ones(1, 1, 1, 4), torch.tensor([[1]]), 1.0)
    c, s = np.cos(1.0), np.sin(1.0)
    np.testing.assert_allclose(_np(rot[0, 0, 0]), [c - s, c - s, c + s, c + s], rtol=1e-6)
    # a weight stored in the activation dtype gives mm the bits of a cast at use
    xb = _t(x[0, :, 0]).to(torch.bfloat16)
    wf = _t(rng.standard_normal((16, 8)).astype(np.float32))
    assert torch.equal(layers.mm(xb, wf), layers.mm(xb, wf.to(torch.bfloat16)))


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "gelu"])
def test_mlp_matches_jax(activation):
    jp = jax_layers.init_mlp(jax.random.PRNGKey(1), 32, 64, activation)
    p = {k: _t(v) for k, v in jax.tree.map(np.asarray, jp).items()}
    x = np.random.default_rng(1).standard_normal((2, 3, 32)).astype(np.float32)
    want = jax_layers.mlp_forward(jp, jnp.asarray(x), activation)
    np.testing.assert_allclose(_np(layers.mlp_forward(p, _t(x), activation)), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model: forward, prefill + decode, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["gemma-2b", "internlm2-1.8b", "mamba2-130m",
                                  "deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_forward_logits_match_jax(arch, use_kernel):
    """Logits and the MoE auxiliary loss (0.0 without experts)."""
    cfg, jcfg, jparams, params = _pair(arch)
    tok = _tokens(cfg, 2, 24, 1)
    want, want_aux, _ = jax_model.forward(jparams, jcfg, jnp.asarray(tok),
                                          use_kernel=use_kernel)
    got, aux, cache = model.forward(params, cfg, _t(tok).long())
    assert cache is None and got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **LOGIT_TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)


def test_padded_vocab_is_masked_and_the_head_is_tied():
    cfg, jcfg, jparams, params = _pair("gemma-2b", vocab_size=500)
    assert cfg.padded_vocab_size == 512 and "head" not in params
    tok = _tokens(cfg, 1, 6, 2)
    got, _, _ = model.forward(params, cfg, _t(tok).long(), last_only=True)
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(tok), last_only=True)
    assert got.shape == (1, 1, 512)
    assert torch.all(got[..., 500:] == -1e30)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-130m", "deepseek-v2-lite-16b",
                                  "mixtral-8x7b"])
def test_load_jax_params_layout(arch):
    cfg, jcfg, jparams, params = _pair(arch)
    assert model.param_count(params) == jax_model.param_count(jparams)
    assert len(params["layers"]) == cfg.num_layers
    drawn = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)  # noqa: E731
    assert shapes(drawn) == shapes(params)
    # bf16: matrices and norms in bf16, Mamba-2's float32 leaves kept
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bp = model.load_jax_params(jax.tree.map(np.asarray, jparams), bcfg, device="cpu")
    layer = bp["layers"][0]
    assert bp["embed"].dtype == torch.bfloat16 and layer["norm1"].dtype == torch.bfloat16
    for key, leaf in layer["mixer"].items():
        f32 = key in ("conv", "A_log", "D", "dt_bias")
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), key
    if cfg.moe is not None:  # router, [E, d, f] experts and shared experts, unstacked
        assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(layer["mlp"]))
        assert params["layers"][1]["mlp"]["w_down"].shape == (
            cfg.moe.num_experts, cfg.moe.expert_d_ff, cfg.d_model)


def test_unstack_layers_orders_a_pattern_with_a_remainder():
    cfg = dataclasses.replace(get_config("gemma-2b", reduced=True), num_layers=5,
                              pattern=("attn", "local_attn"))
    plan = model.stage_plan(cfg)
    assert plan == [(("attn", "local_attn"), 2), (("attn",), 1)]
    stages = [[{"i": np.array([0, 2])}, {"i": np.array([1, 3])}], [{"i": np.array([4])}]]
    assert [int(t["i"]) for t in model.unstack_layers(stages, cfg)] == [0, 1, 2, 3, 4]


def _jax_layers(cache, cfg):
    return model.unstack_layers(jax.tree.map(np.asarray, cache), cfg)


def _check_caches(got, want_jax, jcfg, cfg):
    want = _jax_layers(want_jax, jcfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            if key in ("pos", "kpos"):
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
            else:
                np.testing.assert_allclose(_np(g[key]), np.asarray(w[key], np.float32),
                                           err_msg=key, **LOGIT_TOL)


@pytest.mark.parametrize(
    "arch,window,prompt",
    [
        ("gemma-2b", 0, 12),
        ("mamba2-130m", 0, 40),
        ("gemma-2b", 16, 20),  # prefill past the window: rolled; decode wraps
        ("gemma-2b", 16, 32),  # prefill a multiple of the window: no roll
        ("gemma-2b", 16, 12),  # prefill inside the window, decode past it
        ("deepseek-v2-lite-16b", 0, 12),  # MLA caches, MoE at decode capacity
        ("mixtral-8x7b", 64, 12),  # its own window
        ("mixtral-8x7b", 16, 20),  # MoE with a rolled window cache
    ],
)
def test_prefill_and_decode_match_jax(arch, window, prompt):
    cfg, jcfg, jparams, params = _pair(arch, window=window)
    b, steps = 2, 8
    tok = _tokens(cfg, b, prompt, 5)
    jcache = jax_model.init_cache(jcfg, b, prompt + steps)
    cache = model.init_cache(cfg, b, prompt + steps, device="cpu")
    if window:
        assert cache[0]["k"].shape[1] == min(window, prompt + steps)
    jl, jcache = jax.jit(jax_specs.make_prefill_step(jcfg))(jparams, jcache,
                                                            {"inputs": jnp.asarray(tok)})
    logits, cache = specs.make_prefill_step(cfg)(params, cache, {"inputs": _t(tok).long()})
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
    _check_caches(cache, jcache, jcfg, cfg)
    jdecode = jax.jit(jax_specs.make_decode_step(jcfg))
    decode = specs.make_decode_step(cfg)
    nxt = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], -1)).astype(np.int32)
    for i in range(steps):
        pos = prompt + i
        jl, jcache = jdecode(jparams, jcache, {"inputs": jnp.asarray(nxt[:, None])}, jnp.int32(pos))
        logits, cache = decode(params, cache, {"inputs": _t(nxt[:, None]).long()}, pos)
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], -1)).astype(np.int32)
    _check_caches(cache, jcache, jcfg, cfg)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-130m", "deepseek-v2-lite-16b",
                                  "mixtral-8x7b"])
def test_serve_matches_the_jax_greedy_loop(arch):
    cfg, jcfg, jparams, params = _pair(arch)
    b, prompt_len, gen, seed = 2, 16, 6, 3
    out = serve(cfg, batch=b, prompt_len=prompt_len, gen=gen, seed=seed, device="cpu",
                params=params)
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, prompt_len))
    cache = jax_model.init_cache(jcfg, b, prompt_len + gen)
    logits, cache = jax.jit(jax_specs.make_prefill_step(jcfg))(
        jparams, cache, {"inputs": jnp.asarray(tok, jnp.int32)})
    np.testing.assert_allclose(_np(out["logits"]), np.asarray(logits), **LOGIT_TOL)
    toks = [jnp.argmax(logits[:, : cfg.vocab_size], -1)]
    decode = jax.jit(jax_specs.make_decode_step(jcfg))
    for i in range(gen):
        logits, cache = decode(jparams, cache, {"inputs": toks[-1][:, None]},
                               jnp.int32(prompt_len + i))
        toks.append(jnp.argmax(logits[:, : cfg.vocab_size], -1))
    np.testing.assert_array_equal(out["tokens"], np.stack([np.asarray(t) for t in toks], 1))
    assert out["prefill_ms"] > 0 and out["decode_ms_per_token"] > 0


def test_serve_cli_and_devices(capsys):
    main(["--arch", "mamba2-130m", "--device", "cpu", "--prompt-len", "8", "--gen", "2"])
    assert "mamba2-130m-reduced" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--no-reduced", "--arch", "no-such-flag", "--bogus"])
    if not torch.cuda.is_available():  # entry points default to the card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve(get_config("gemma-2b", reduced=True), gen=1)


def test_specs_and_what_is_not_ported():
    gemma = get_config("gemma-2b")
    assert specs.resolve_config(gemma, "long_500k").window == gemma.long_context_window
    assert specs.resolve_config(gemma, "prefill_32k") == gemma
    assert specs.SHAPES == jax_specs.SHAPES
    # a mesh's model axis: head padding as the reference resolves it
    jgemma = jax_get_config("gemma-2b")
    for model_axis in (4, 16):
        for shape in specs.SHAPES:
            got = specs.resolve_config(gemma, shape, model_axis=model_axis)
            want = jax_specs.resolve_config(jgemma, shape, model_axis=model_axis)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.tp_size == model_axis
    gen = torch.Generator().manual_seed(0)
    # RG-LRU builds (it raised before it was ported), with the JAX tree's size
    for reduced in (True, False):
        cfg = get_config("recurrentgemma-2b", reduced=reduced)
        jcfg = jax_get_config("recurrentgemma-2b", reduced=reduced)
        params = model.init_params(cfg, gen, device="cpu" if reduced else "meta")
        shapes = jax.eval_shape(lambda c=jcfg: jax_model.init_params(c, jax.random.PRNGKey(0)))
        assert model.param_count(params) == jax_model.param_count(shapes)
        assert len(model.init_cache(cfg, 1, 8, device="meta")) == cfg.num_layers
    for arch in ("mixtral-8x7b", "deepseek-v2-lite-16b"):  # the MoE family builds
        cfg = get_config(arch, reduced=True)
        params = model.init_params(cfg, gen, device="cpu")
        assert model.param_count(params) == cfg.num_params()
        assert len(model.init_cache(cfg, 1, 8, device="cpu")) == cfg.num_layers
