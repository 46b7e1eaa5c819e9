"""LM training and RG-LRU in the port against the JAX package, on the CPU.

Configs are the reduced ones (float32). Parameters come from
``repro.models.transformer.model.init_params(cfg, PRNGKey(seed))`` and are
carried across with ``load_jax_params``, never redrawn from torch; both
sides get the same numpy inputs.

Tolerances: rtol 1e-4 / atol 1e-5 for losses, gradients, an AdamW step and
a 3-step trajectory (two frameworks' float32 matmuls and sums in another
order, through the forward and its backward); RG-LRU's doubling scan
against ``jax.lax.associative_scan`` rtol 1e-5 / atol 1e-6 (the same
combine in another tree, float32 rounding); RG-LRU model logits and
caches rtol 2e-5 / atol 2e-5, as ``tests/test_torch_lm.py`` holds the
other families. The token stream bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.tokens import SyntheticTokenStream as JaxStream  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models.transformer import model as jax_model  # noqa: E402
from repro.models.transformer import ssm as jax_ssm  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro.train.loop import LMTrainer as JaxLMTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticTokenStream  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.transformer import model, ssm  # noqa: E402
from repro_torch.train import LMTrainer, optim  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)

TRAIN_ARCHS = ["gemma-2b", "mamba2-130m", "recurrentgemma-2b", "deepseek-v2-lite-16b",
               "mixtral-8x7b"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _pair(arch, seed=0, **changes):
    """(port cfg, JAX cfg, JAX params, port params) for a reduced config."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    params = model.load_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jcfg, jparams, params


def _jax_grads_by_layer(grads, jcfg):
    """The JAX gradient tree with its stages unstacked into the port's
    layout (one dict per layer), as numpy."""
    g = jax.tree.map(np.asarray, grads)
    out = {k: g[k] for k in g if k != "stages"}
    out["layers"] = model.unstack_layers(g["stages"], jcfg)
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 2, 16, 0), (1000, 3, 33, 7),
                                                  (256000, 1, 8, 3)])
def test_token_stream_is_the_references_bit_for_bit(vocab, batch, seq, seed):
    ours, ref = SyntheticTokenStream(vocab, batch, seq, seed), JaxStream(vocab, batch, seq, seed)
    for _ in range(3):
        (a, b), (c, d) = ours.next_batch(), ref.next_batch()
        assert a.dtype == c.dtype == np.int32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        np.testing.assert_array_equal(a[:, 1:], b[:, :-1])


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 7, 64, 300])
def test_linear_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    # log a down to -18.5 a step: the cumulative products underflow at once
    a = np.exp(-18.5 * rng.random((2, s, 5))).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)

    def op(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    want = jax.lax.associative_scan(op, (jnp.asarray(a), jnp.asarray(b)), axis=1)[1]
    got = ssm.linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), **SCAN_TOL)
    h, loop = np.zeros((2, 5), np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(_np(got), np.stack(loop, 1), **SCAN_TOL)


def _rglru_pair(seed=0):
    jcfg = jax_get_config("recurrentgemma-2b", reduced=True)
    cfg = get_config("recurrentgemma-2b", reduced=True)
    jp = jax_ssm.init_rglru(jax.random.PRNGKey(seed), jcfg)
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return cfg, jcfg, jp, p


def test_rglru_forward_prefill_and_decode_match_jax():
    cfg, jcfg, jp, p = _rglru_pair(3)
    rng = np.random.default_rng(0)
    b, s, d = 2, 40, cfg.d_model
    x = rng.standard_normal((b, s + 3, d)).astype(np.float32)
    # full sequence, no cache
    want, _ = jax_ssm.rglru_forward(jp, jcfg, jnp.asarray(x[:, :s]))
    got, none = ssm.rglru_forward(p, cfg, _t(x[:, :s]))
    assert none is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    # prefill from a nonzero cache, then three decode steps
    state = rng.standard_normal((b, d)).astype(np.float32)
    conv = rng.standard_normal((b, 3, d)).astype(np.float32)
    jcache = {"state": jnp.asarray(state), "conv": jnp.asarray(conv), "pos": jnp.int32(0)}
    cache = {"state": _t(state), "conv": _t(conv), "pos": 0}
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2), (s + 2, s + 3)):
        want, jcache = jax_ssm.rglru_forward(jp, jcfg, jnp.asarray(x[:, lo:hi]), cache=jcache)
        got, cache = ssm.rglru_forward(p, cfg, _t(x[:, lo:hi]), cache=cache)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
        for key in ("state", "conv"):
            np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]), err_msg=key,
                                       **LOGIT_TOL)
        assert cache["pos"] == int(jcache["pos"]) == hi


def test_rglru_params_count_and_dtypes():
    cfg, jcfg, jparams, params = _pair("recurrentgemma-2b")
    assert model.param_count(params) == jax_model.param_count(jparams)
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bp = model.load_jax_params(jax.tree.map(np.asarray, jparams), bcfg, device="cpu")
    mixer = bp["layers"][0]["mixer"]
    for key, leaf in mixer.items():  # lam and the conv taps stay float32
        assert leaf.dtype == (torch.float32 if key in ("lam", "conv") else torch.bfloat16), key
    cache = model.init_cache(bcfg, 2, 8, device="cpu")
    assert cache[0]["state"].dtype == torch.float32 and cache[0]["conv"].shape == (2, 3, 256)
    assert cache[2]["k"].shape[1] == 8  # the local attention's window caps it at 64


# ---------------------------------------------------------------------------
# the five configs no other test holds: forward, prefill and 4 decode steps
# ---------------------------------------------------------------------------


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return jnp.asarray(x), _t(x)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return jnp.asarray(tok), _t(tok).long()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llava-next-34b", "musicgen-medium",
                                  "granite-3-2b", "granite-20b"])
def test_forward_prefill_and_decode_of_the_other_configs_match_jax(arch):
    cfg, jcfg, jparams, params = _pair(arch)
    b, prompt, steps = 2, 12, 4
    jx, x = _inputs(cfg, b, prompt, 1)
    want, want_aux, _ = jax_model.forward(jparams, jcfg, jx)
    got, aux, _ = model.forward(params, cfg, x)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **LOGIT_TOL)
    jcache = jax_model.init_cache(jcfg, b, prompt + steps)
    cache = model.init_cache(cfg, b, prompt + steps, device="cpu")
    jl, jcache = jax.jit(jax_specs.make_prefill_step(jcfg))(jparams, jcache, {"inputs": jx})
    logits, cache = specs.make_prefill_step(cfg)(params, cache, {"inputs": x})
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
    jdecode = jax.jit(jax_specs.make_decode_step(jcfg))
    decode = specs.make_decode_step(cfg)
    for i in range(steps):
        if cfg.input_mode == "embeddings":  # fed embeddings: a fresh one a step
            jn, n = _inputs(cfg, b, 1, 10 + i)
        else:
            nxt = np.asarray(jnp.argmax(jl[:, : cfg.vocab_size], -1)).astype(np.int32)[:, None]
            jn, n = jnp.asarray(nxt), _t(nxt).long()
        jl, jcache = jdecode(jparams, jcache, {"inputs": jn}, jnp.int32(prompt + i))
        logits, cache = decode(params, cache, {"inputs": n}, prompt + i)
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
    want_cache = model.unstack_layers(jax.tree.map(np.asarray, jcache), jcfg)
    for g, w in zip(cache, want_cache):
        assert sorted(g) == sorted(w)
        for key in g:
            if key in ("pos", "kpos"):
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
            else:
                np.testing.assert_allclose(_np(g[key]), np.asarray(w[key], np.float32),
                                           err_msg=key, **LOGIT_TOL)


# ---------------------------------------------------------------------------
# lm_loss, its gradients, AdamW, the trainer
# ---------------------------------------------------------------------------


def _batch(cfg, b, s, seed):
    inp, tgt = SyntheticTokenStream(cfg.vocab_size, b, s, seed).next_batch()
    return inp, tgt


def _torch_loss_and_grads(params, cfg, inp, tgt, remat):
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss, (nll, aux) = model.lm_loss(params, cfg, _t(inp).long(), _t(tgt).long(), remat=remat)
    loss.backward()
    return loss, nll, aux


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_loss_and_every_gradient_match_jax(arch, remat):
    cfg, jcfg, jparams, params = _pair(arch)
    inp, tgt = _batch(cfg, 2, 24, 5)
    (jloss, (jnll, jaux)), jgrads = jax.value_and_grad(
        lambda p: jax_model.lm_loss(p, jcfg, jnp.asarray(inp), jnp.asarray(tgt), remat=remat),
        has_aux=True)(jparams)
    loss, nll, aux = _torch_loss_and_grads(params, cfg, inp, tgt, remat)
    for got, want in ((loss, jloss), (nll, jnll), (aux, jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want), **GRAD_TOL)
    assert (float(aux.detach()) > 0) == (cfg.moe is not None)
    want = _jax_grads_by_layer(jgrads, jcfg)
    got_leaves = [p.grad for p in optim.tree_leaves(params)]
    want_leaves = optim.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    assert sum(w.size for w in want_leaves) == jax_model.param_count(jgrads)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert g is not None and g.shape == w.shape, i
        np.testing.assert_allclose(_np(g), w, err_msg=f"leaf {i}", **GRAD_TOL)


def test_the_loss_heads_gradient_is_autograds_bit_for_bit():
    """``lm_loss``'s logsumexp and target logits (one buffer for their
    gradient) against autograd of ``torch.logsumexp`` and ``gather``."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 5, 37), generator=g) * 4
    tgt = torch.randint(0, 37, (2, 5), generator=g)
    g_z, g_t = torch.randn((2, 5), generator=g), torch.randn((2, 5), generator=g)
    a = logits.clone().requires_grad_(True)
    z, t = model._LogitTerms.apply(a, tgt)
    torch.autograd.backward((z, t), (g_z, g_t))
    b = logits.clone().requires_grad_(True)
    wz = torch.logsumexp(b, dim=-1)
    wt = torch.gather(b, -1, tgt[..., None])[..., 0]
    torch.autograd.backward((wz, wt), (g_z, g_t))
    assert torch.equal(z, wz) and torch.equal(t, wt) and torch.equal(a.grad, b.grad)


def test_remat_gives_the_same_bits_on_the_cpu():
    cfg, _, _, params = _pair("recurrentgemma-2b")
    inp, tgt = _batch(cfg, 2, 20, 2)
    grads = []
    for remat in (False, True):
        loss, _, _ = _torch_loss_and_grads(params, cfg, inp, tgt, remat)
        grads.append((loss.detach(), [p.grad.clone() for p in optim.tree_leaves(params)]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b"])
def test_one_adamw_step_matches_jax(arch):
    """The step's parameters. eps 1e-4 (the config's default is 1e-8): a
    first step moves each element by lr g / (|g| + eps), whose slope at
    g = 0 is lr / eps, and some gradient elements are sums that cancel to
    under 1e-6, where the two frameworks' float32 gradients differ by
    1e-9: at eps 1e-8 that moves the step by up to lr itself, at 1e-4 by
    1e-7."""
    cfg, jcfg, jparams, params = _pair(arch)
    inp, tgt = _batch(cfg, 2, 16, 9)
    opt = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1, eps=1e-4)
    jgrads = jax.grad(lambda p: jax_model.lm_loss(p, jcfg, jnp.asarray(inp), jnp.asarray(tgt))[0])(
        jparams)
    jnew, _, _ = jax_optim.adamw_update(jparams, jgrads, jax_optim.adamw_init(jparams),
                                        jax_optim.AdamWConfig(**opt))
    from repro_torch.train.loop import descend

    state = optim.adamw_init(params)
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    descend(params, lambda: model.lm_loss(params, cfg, _t(inp).long(), _t(tgt).long())[0],
            state, optim.AdamWConfig(**opt))
    want = optim.tree_leaves(_jax_grads_by_layer(jnew, jcfg))
    for i, (g, w) in enumerate(zip(optim.tree_leaves(params), want)):
        np.testing.assert_allclose(_np(g), w, err_msg=f"leaf {i}", **GRAD_TOL)


def test_adamw_update_in_slices_matches_jax(monkeypatch):
    """``adamw_update`` writes in place, in slices (here of 7 elements,
    cutting rows), the reference's parameters and moments over 3 steps,
    bf16 leaves included: float32 at rtol 1e-6 as
    ``tests/test_torch_train.py`` holds one step, bf16 within one bf16
    rounding (2^-8 relative) of the reference's, since float32 results
    1 ulp apart can round to neighbouring bf16 values."""
    monkeypatch.setattr(optim, "_SLICE", 7)
    rng = np.random.default_rng(0)

    def tree(scale):
        return {"a": scale * rng.standard_normal((5, 7)).astype(np.float32),
                "b": [scale * rng.standard_normal(3).astype(np.float32),
                      scale * rng.standard_normal((4, 4)).astype(np.float32)]}

    def jax_tree(t):
        return {"a": jnp.asarray(t["a"], jnp.bfloat16), "b": [jnp.asarray(x) for x in t["b"]]}

    def torch_tree(t):
        return {"a": _t(t["a"]).to(torch.bfloat16), "b": [_t(x) for x in t["b"]]}

    params = tree(1)
    jparams, tparams = jax_tree(params), torch_tree(params)
    jstate, tstate = jax_optim.adamw_init(jparams), optim.adamw_init(tparams)
    cfg = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)
    for _ in range(3):
        grads = tree(3)
        jparams, jstate, _ = jax_optim.adamw_update(jparams, jax_tree(grads), jstate,
                                                    jax_optim.AdamWConfig(**cfg))
        out, tstate, _ = optim.adamw_update(tparams, torch_tree(grads), tstate,
                                            optim.AdamWConfig(**cfg))
        assert out is tparams
    assert tparams["a"].dtype == torch.bfloat16
    for key in ("mu", "nu"):
        for a, b in zip(optim.tree_leaves(tstate[key]), jax.tree.leaves(jstate[key])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(_np(tparams["a"]), np.asarray(jparams["a"], np.float32),
                               rtol=2.0**-8)
    for a, b in zip(tparams["b"], jparams["b"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-130m", "recurrentgemma-2b"])
def test_lm_trainer_matches_the_reference_trainer(arch):
    """Losses and the final parameters after 3 steps; eps 1e-4 for the
    reason ``test_one_adamw_step_matches_jax`` gives. The parameters at
    atol 1e-2 lr: each step moves an element by up to lr m / (sqrt(v) +
    eps), and after three steps an embedding row that one token reached
    once has m and v from a single gradient, which the two frameworks'
    float32 sums give 1e-9 apart."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    opt = dict(lr=1e-2, warmup_steps=2, eps=1e-4)
    ref = JaxLMTrainer(jcfg, batch=2, seq_len=16, seed=4, opt=jax_optim.AdamWConfig(**opt))
    params = model.load_jax_params(jax.tree.map(np.asarray, ref.params), cfg, device="cpu")
    ours = LMTrainer(cfg, batch=2, seq_len=16, seed=4, opt=optim.AdamWConfig(**opt),
                     device="cpu", params=params)
    want = ref.train(3, log_every=1)
    got = ours.train(3, log_every=1)
    assert got.steps == want.steps == [0, 1, 2]
    np.testing.assert_allclose(got.losses, want.losses, **GRAD_TOL)
    assert got.losses[-1] < got.losses[0] and got.compute_time > 0
    final = optim.tree_leaves(_jax_grads_by_layer(ref.params, jcfg))
    for i, (g, w) in enumerate(zip(optim.tree_leaves(ours.params), final)):
        np.testing.assert_allclose(_np(g), w, err_msg=f"leaf {i}", rtol=1e-4,
                                   atol=1e-2 * opt["lr"])


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-130m", "recurrentgemma-2b"])
def test_bf16_forward_on_float32_weights_is_the_stored_bf16_forward(arch):
    """The trainer's float32 master weights under a bf16 config give the
    bits of the bf16-stored weights (the forward casts at use), and a
    trainer step on them runs in bf16 and updates float32 weights."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
    trainer = LMTrainer(cfg, batch=2, seq_len=12, seed=3, device="cpu")
    master = trainer.params
    assert all(p.dtype == torch.float32 for p in optim.tree_leaves(master))
    stored = model._store(master, torch.bfloat16)
    tok = _t(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))).long()
    with torch.no_grad():
        want, _, _ = model.forward(stored, cfg, tok)
        got, _, _ = model.forward(master, cfg, tok)
    assert torch.equal(got, want)
    before = [p.detach().clone() for p in optim.tree_leaves(master)]
    log = trainer.train(2, log_every=1)
    assert np.all(np.isfinite(log.losses))
    moved = [not torch.equal(a, p) for a, p in zip(before, optim.tree_leaves(master))]
    assert all(p.dtype == torch.float32 for p in optim.tree_leaves(master)) and any(moved)


def test_lm_trainer_draws_from_its_generator_and_saves(tmp_path):
    cfg = get_config("gemma-2b", reduced=True)
    a = LMTrainer(cfg, batch=1, seq_len=8, seed=1, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    b = LMTrainer(cfg, batch=1, seq_len=8, seed=1, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(optim.tree_leaves(a.params),
                                                 optim.tree_leaves(b.params)))
    la, lb = a.train(2), b.train(2)
    assert la.losses == lb.losses  # the CPU step repeats bit for bit
    path = a.save(str(tmp_path / "lm.npz"), step=2)
    from repro_torch.train import load_checkpoint

    tree, step = load_checkpoint(path, {"params": a.params, "opt": a.opt_state})
    assert step == 2
    assert all(torch.equal(x, y) for x, y in zip(optim.tree_leaves(tree["params"]),
                                                 optim.tree_leaves(a.params)))
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA"):
            LMTrainer(cfg, batch=1, seq_len=8)
