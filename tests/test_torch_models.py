"""The port's GNN layer slices against the JAX package's, on the CPU.

Parameters come from ``GNNModel.init`` in JAX and are carried across with
``load_jax_params``; the same numpy batch goes to both sides. The JAX slice
runs with its Pallas kernels (interpret mode) and with its jnp path.
Tolerance: float32 rtol 1e-4 / atol 1e-5 (two frameworks' matmuls and sum
orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.gnn import GNNModel as JaxGNN  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.gnn import GNNModel, load_jax_params  # noqa: E402

IN_DIM, HIDDEN, HEADS, ETYPES = 16, 16, 2, 4


def _pair(kind, seed=0):
    jm = JaxGNN(kind, IN_DIM, hidden=HIDDEN, num_layers=2, num_heads=HEADS, num_etypes=ETYPES)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GNNModel(
        kind, IN_DIM, hidden=HIDDEN, num_layers=2, num_heads=HEADS, num_etypes=ETYPES,
        device="cpu",
    )
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(k, seed=0, n=24, valid=70, m=96):
    """A padded engine batch: seg sorted with a -1 tail; rows 0, 5 and the
    last two have no edges (the empty-segment trap)."""
    rng = np.random.default_rng(seed)
    din = IN_DIM if k == 0 else HIDDEN
    rows = np.setdiff1d(np.arange(n), [0, 5, n - 2, n - 1])
    seg = np.full(m, -1, np.int32)
    seg[:valid] = np.sort(rng.choice(rows, valid))
    h_self = rng.standard_normal((n, din)).astype(np.float32)
    h_nbr = rng.standard_normal((m, din)).astype(np.float32)
    h_nbr[valid:] = 0.0
    et = rng.integers(0, ETYPES, m).astype(np.int32)
    return h_self, h_nbr, seg, et


def _torch_slice(tm, k, b):
    return tm.layer_slice(k, *(torch.as_tensor(x) for x in b)).numpy()


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gat", "hgt"])
def test_layer_slice_matches_jax(kind, k, use_kernel):
    jm, params, tm = _pair(kind)
    b = _batch(k, seed=k)
    want = jm.embed_layer_fn(params, k).jax(*(jnp.asarray(x) for x in b), use_kernel=use_kernel)
    got = _torch_slice(tm, k, b)
    assert got.shape == (24, HIDDEN)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat", "hgt"])
def test_embed_layer_fn_numpy_adapter(kind):
    jm, params, tm = _pair(kind, seed=1)
    h_self, h_nbr, seg, et = _batch(0, seed=2)
    jf, tf = jm.embed_layer_fn(params, 0), tm.embed_layer_fn(0)
    assert tf.needs_etype == jf.needs_etype == (kind == "hgt")
    args = (0, h_self, h_nbr[:70], seg[:70]) + ((et[:70],) if kind == "hgt" else ())
    np.testing.assert_allclose(tf(*args), jf(*args), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["gat", "hgt"])
def test_empty_segments_give_the_same_rows(kind):
    """The jnp softmax uses -inf plus an isfinite fix, the kernels a -1e30
    sentinel; an edgeless row must agree either way (gat: elu(0) = 0)."""
    jm, params, tm = _pair(kind, seed=3)
    b = _batch(0, seed=4)
    got = _torch_slice(tm, 0, b)
    for use_kernel in (True, False):
        want = np.asarray(
            jm.embed_layer_fn(params, 0).jax(*(jnp.asarray(x) for x in b), use_kernel=use_kernel)
        )
        np.testing.assert_allclose(got[[0, 5, 22, 23]], want[[0, 5, 22, 23]], rtol=1e-4, atol=1e-6)
    if kind == "gat":
        assert np.all(got[[0, 5, 22, 23]] == 0.0)


def test_hgt_uses_the_tanh_gelu():
    """jax.nn.gelu defaults to the tanh form, torch's gelu to the erf form:
    the port must follow JAX, and the two forms differ at this tolerance."""
    x = np.linspace(-4, 4, 257).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.as_tensor(x), approximate="tanh").numpy()
    erf = torch.nn.functional.gelu(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(tanh, want, rtol=1e-5, atol=1e-6)
    assert np.abs(erf - want).max() > 1e-4


def test_load_jax_params_checks_keys_and_shapes():
    _, params, tm = _pair("sage")
    tree = jax.tree.map(np.asarray, params)
    np.testing.assert_array_equal(tm.layers[1]["w"].detach().numpy(), tree["layers"][1]["w"])
    np.testing.assert_array_equal(tm.out.detach().numpy(), tree["out"])
    bad = {"layers": [dict(tree["layers"][0], extra=np.zeros(1)), tree["layers"][1]]}
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)
    bad = {"layers": [dict(tree["layers"][0], w=np.zeros((3, 3))), tree["layers"][1]]}
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)
    with pytest.raises(ValueError):
        load_jax_params(tm, {"layers": tree["layers"][:1]})


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat", "hgt"])
def test_numpy_init_has_the_jax_shapes(kind):
    jm, params, tm = _pair(kind)
    tree = tm.init_numpy(0)
    for jl, tl in zip(params["layers"], tree["layers"]):
        assert {k: v.shape for k, v in jl.items()} == {k: v.shape for k, v in tl.items()}


def test_cuda_default_refuses_a_machine_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        GNNModel("sage", 8)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        GNNModel("gin", 8, device="cpu")
