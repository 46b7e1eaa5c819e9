"""The port's MoE and MLA layers against the JAX package, on the CPU.

Reduced configs (float32): deepseek-v2-lite (MLA, 4 experts top-2 with a
shared expert) and mixtral-8x7b (GQA with a sliding window, 4 experts
top-2). Parameters come from the JAX package's ``init_moe``/``init_mla``
(``PRNGKey`` seeds) and go across as numpy arrays; both sides get the same
numpy inputs. The full model (forward, prefill + decode, greedy serving)
is held against JAX in ``tests/test_torch_lm.py``; the full configs'
parameter counts are checked here without building a weight.

Tolerances: rtol 2e-5 / atol 2e-5 (``LOGIT_TOL`` of ``test_torch_lm.py``:
matmuls and sums in another order), with the absolute part taken relative
to the output's largest magnitude for a lone MoE layer: the reference
draws expert weights with scale 1/sqrt(E) (``dense_init`` takes the fan-in
from the leading expert axis), so its outputs reach a few hundred and an
element near zero carries the rounding of its large terms. The chosen
experts must be equal exactly, ties included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import layers as jax_layers  # noqa: E402
from repro.models.transformer import model as jax_model  # noqa: E402
from repro.models.transformer import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import layers, model, moe  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
MOE_ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x7b"]


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _close(got, want):
    """rtol 2e-5, atol 2e-5 times the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **changes)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    return cfg, jcfg


def _with_moe(arch, **moe_changes):
    cfg, jcfg = _cfgs(arch)
    return (dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes)),
            dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes)))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _jax_experts(jp, jcfg, x):
    """The experts ``jax.lax.top_k`` picks in the reference's routing."""
    xt = jnp.asarray(x).reshape(1, -1, x.shape[-1])
    logits = jnp.einsum("gtd,de->gte", xt, jp["router"]).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)[1])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, capacity_factor, groups):
    """y and the aux loss, in one dispatch group or two, at the config's
    capacity and at one low enough that slots drop."""
    changes = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    cfg, jcfg = _with_moe(arch, **changes)
    cfg = dataclasses.replace(cfg, moe_dispatch_groups=groups)
    jcfg = dataclasses.replace(jcfg, moe_dispatch_groups=groups)
    jp = jax_moe.init_moe(jax.random.PRNGKey(2), jcfg)
    p = _torch_tree(jp)
    x = _x(cfg, 2, 24, 5)
    want_y, want_aux = jax_moe.moe_forward(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_forward(p, cfg, torch.tensor(x))
    assert y.shape == x.shape and aux.dtype == torch.float32 and aux.dim() == 0
    _close(y, want_y)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    r = moe.route(p, cfg, torch.tensor(x).reshape(groups, -1, cfg.d_model))
    assert r.cap == max(1, int(48 // groups * cfg.moe.top_k / cfg.moe.num_experts
                               * cfg.moe.capacity_factor))
    assert bool(r.keep.all()) == (capacity_factor is None)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_pick_the_lower_expert_as_jax_top_k(arch):
    """Three of four router columns equal: every token ties between
    experts 0, 1 and 3. The port picks what ``jax.lax.top_k`` picks (the
    lower index first), and y and aux follow."""
    cfg, jcfg = _cfgs(arch)
    jp = jax_moe.init_moe(jax.random.PRNGKey(4), jcfg)
    r = np.array(jp["router"])
    r[:, 1] = r[:, 0]
    r[:, 3] = r[:, 0]
    jp = {**jp, "router": jnp.asarray(r)}
    p = _torch_tree(jp)
    x = _x(cfg, 2, 16, 6)
    got = moe.route(p, cfg, torch.tensor(x).reshape(1, -1, cfg.d_model))
    want = _jax_experts(jp, jcfg, x)
    probs = got.probs.numpy()
    assert (probs[..., 0] == probs[..., 1]).all() and (probs[..., 0] == probs[..., 3]).all()
    np.testing.assert_array_equal(got.gate_idx.numpy(), want)
    assert {0, 1}.issubset(set(got.gate_idx.numpy().ravel().tolist()))
    want_y, want_aux = jax_moe.moe_forward(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_forward(p, cfg, torch.tensor(x))
    _close(y, want_y)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_slot_positions_count_earlier_slots_of_the_same_expert():
    """pos is the reference's ``(cumsum(one_hot) * one_hot - 1).max(-1)``:
    the slot's rank among its expert's slots in token-major order."""
    cfg, _ = _with_moe("mixtral-8x7b", capacity_factor=0.25)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    xt = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    r = moe.route(p, cfg, xt)
    flat = r.gate_idx.reshape(2, -1)
    for g in range(2):
        for i in range(flat.shape[1]):
            assert int(r.pos[g, i]) == int((flat[g, :i] == flat[g, i]).sum())
    assert r.cap == max(1, int(16 * 2 / 4 * 0.25))
    assert torch.equal(r.keep, r.pos < r.cap) and not bool(r.keep.all())
    np.testing.assert_allclose(r.gate_vals.sum(-1).numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_pair(seed=3):
    cfg, jcfg = _cfgs("deepseek-v2-lite-16b")
    jp = jax_layers.init_mla(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, _torch_tree(jp)


def test_mla_forward_without_a_cache_matches_jax():
    cfg, jcfg, jp, p = _mla_pair()
    assert sorted(p) == ["w_dkv", "w_krope", "w_uk", "w_uv", "wo", "wq"]
    x = _x(cfg, 2, 20, 1)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want, _ = jax_layers.mla_forward(jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos))
    got, cache = layers.attention_forward(p, cfg, torch.tensor(x), positions=torch.tensor(pos))
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_mla_prefill_and_decode_match_jax(window):
    """Prefill 12 tokens, then 8 decode steps, each expanding the whole
    latent cache; the latent, RoPE-key and position caches as the JAX
    package's, within the window's rolling layout when ``window > 0``."""
    cfg, jcfg, jp, p = _mla_pair()
    b, prompt, steps = 2, 12, 8
    L = min(window, prompt + steps) if window else prompt + steps
    jc = {"ckv": jnp.zeros((b, L, cfg.kv_lora_rank)), "krope": jnp.zeros((b, L, cfg.rope_head_dim)),
          "kpos": jnp.full((L,), -1, jnp.int32), "pos": 0}
    c = {"ckv": torch.zeros(b, L, cfg.kv_lora_rank), "krope": torch.zeros(b, L, cfg.rope_head_dim),
         "kpos": torch.full((L,), -1, dtype=torch.int32), "pos": 0}
    rng = np.random.default_rng(2)
    for i, s in enumerate([prompt] + [1] * steps):
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        start = 0 if i == 0 else prompt + i - 1
        pos = np.tile(np.arange(start, start + s, dtype=np.int32), (b, 1))
        want, jc = jax_layers.mla_forward(jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                                          cache=jc, window=window)
        got, c = layers.mla_forward(p, cfg, torch.tensor(x), positions=torch.tensor(pos),
                                    cache=c, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert c["pos"] == int(jc["pos"])
        np.testing.assert_array_equal(c["kpos"].numpy(), np.asarray(jc["kpos"]))
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(_np(c[key]), np.asarray(jc[key]), err_msg=key, **TOL)


# ---------------------------------------------------------------------------
# parameter counts of the full configs, without building a weight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,count", [("deepseek-v2-lite-16b", 16_000_595_968),
                                        ("mixtral-8x7b", 46_571_720_704)])
def test_full_config_parameter_counts_match_jax(arch, count):
    """``num_params()`` as the JAX config's; ``param_count`` of the port's
    parameters (built on the meta device) as the JAX tree's (abstract
    shapes). mixtral's vocabulary of 32,000 is padded to 32,256 rows, so
    its built count exceeds the analytic one by 256 embedding rows."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.num_params() == jcfg.num_params() == count
    shapes = jax.eval_shape(lambda: jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    built = model.init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    assert model.param_count(built) == want
    assert want == count + (cfg.padded_vocab_size - cfg.vocab_size) * cfg.d_model
    layer = built["layers"][0]
    assert layer["mlp"]["w_gate"].shape == (cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(layer["mlp"]))
