"""The attention and SSD backward kernels' plain twins against the JAX
package, and the kernels' wrappers on CPU tensors, on the CPU.

The backward kernels (``csrc/flash_attention_backward.cu``,
``csrc/ssd_scan_backward.cu``) have no TPU counterpart: the JAX package
trains through its plain attention and ``ssd_chunked_jnp`` and lets autodiff
differentiate them. Their twins here are ``torch.autograd`` of the port's
plain versions (``ref.attention_backward_ref``, ``ref.ssd_backward_ref``),
held against ``jax.vjp`` of the JAX functions on the same numpy inputs;
``ref.ssd_chunk_grads_ref``, the SSD backward kernels' algorithm written
out in plain PyTorch, is held against autograd; ``ref.attention_lse_ref``
against ``jax.nn.logsumexp`` of the JAX package's masked scores. The
kernels themselves run on the card (``tests/test_torch_gpu.py``).

Tolerances: float32 rtol 2e-5 / atol 2e-5 for one attention or SSD call's
gradients (two frameworks' sums in another order); the chunk algorithm
against autograd rtol 1e-4 / atol 1e-4 (another algorithm: chunk-local
quadratic forms and two state passes; da a difference of sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models.transformer.ssm import ssd_chunked_jnp  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402

OP_TOL = dict(rtol=2e-5, atol=2e-5)
ALGO_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.detach().float().numpy()


# (B, Sq, Skv, H, Hkv, D, causal, window, kv_offset)
ATTN_CASES = [
    (2, 40, 40, 4, 1, 32, True, 0, 0),  # MQA
    (1, 50, 50, 6, 2, 16, True, 17, 0),  # GQA, a window
    (2, 20, 70, 4, 4, 16, True, 0, 50),  # queries after a cache
    (1, 30, 30, 2, 2, 8, False, 0, 0),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_ref_matches_jax_vjp(case):
    b, sq, skv, h, hkv, d, causal, window, off = case
    rng = np.random.default_rng(sq + d)
    q, dout = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, kv_offset=off)
    _, vjp = jax.vjp(lambda *t: jax_ops.mha_attention(*t, use_kernel=False, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = ref.attention_backward_ref(*(torch.tensor(t) for t in (q, k, v, dout)), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **OP_TOL)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_lse_ref_is_the_logsumexp_of_the_masked_scores(case):
    b, sq, skv, h, hkv, d, causal, window, off = case
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    kr = np.repeat(k, h // hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / d**0.5
    qp = off + np.arange(sq)[:, None]
    kp = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    want = jax.nn.logsumexp(jnp.where(keep, s, -1e30), axis=-1)
    got = ref.attention_lse_ref(torch.tensor(q), torch.tensor(k), causal=causal, window=window,
                                kv_offset=off)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP_TOL)


def _ssd_inputs(bz, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    dt = (rng.random((bz, s, h)) * 0.5 + 0.01).astype(np.float32)
    A = (-rng.random(h) - 0.1).astype(np.float32)
    return (f(bz, s, h, p), dt * A, dt, f(bz, s, g, n), f(bz, s, g, n), f(bz, h, p, n),
            f(bz, s, h, p), f(bz, h, p, n))


# (Bz, S, H, P, G, N, chunk, init, final state's gradient)
SSD_CASES = [
    (2, 48, 4, 8, 2, 6, 16, True, True),
    (1, 50, 2, 4, 1, 4, 16, False, True),  # ragged
    (1, 33, 3, 4, 3, 4, 16, True, False),
    (2, 7, 2, 4, 1, 4, 16, False, False),  # shorter than a chunk
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_backward_ref_matches_jax_vjp(case):
    bz, s, h, p, g, n, chunk, init, final = case
    x, a, dt, B, C, st, dy, dfinal = _ssd_inputs(bz, s, h, p, g, n, s + p)
    jst = jnp.asarray(st) if init else None

    def fn(x, a, dt, B, C, st):
        return ssd_chunked_jnp(x, a, dt, B, C, chunk=chunk, init_state=st)

    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (x, a, dt, B, C)), jst)
    zero = np.zeros_like(dfinal)
    want = vjp((jnp.asarray(dy), jnp.asarray(dfinal if final else zero)))
    T = torch.tensor
    got = ref.ssd_backward_ref(T(x), T(a), T(dt), T(B), T(C), T(dy),
                               T(dfinal) if final else None, chunk=chunk,
                               init_state=T(st) if init else None)
    for name, gg, w in zip(("dx", "da", "ddt", "dB", "dC", "dinit"), got, want):
        if not init and name == "dinit":
            assert gg is None
            continue
        np.testing.assert_allclose(_np(gg), np.asarray(w), err_msg=name, **OP_TOL)


@pytest.mark.parametrize("kernel_chunk", [16, 64])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunk_grads_ref_is_the_gradient(case, kernel_chunk):
    """The backward kernels' algorithm at their chunk length (64) and at
    another, against autograd of the plain version."""
    bz, s, h, p, g, n, chunk, init, final = case
    T = torch.tensor
    x, a, dt, B, C, st, dy, dfinal = (T(t) for t in _ssd_inputs(bz, s, h, p, g, n, s + 1))
    kw = dict(init_state=st if init else None)
    want = ref.ssd_backward_ref(x, a, dt, B, C, dy, dfinal if final else None, chunk=chunk,
                                **kw)
    got = ref.ssd_chunk_grads_ref(x, a, dt, B, C, dy, dfinal if final else None,
                                  chunk=kernel_chunk, **kw)
    for name, gg, w in zip(("dx", "da", "ddt", "dB", "dC", "dinit"), got, want):
        if w is None:
            assert gg is None
            continue
        np.testing.assert_allclose(_np(gg), _np(w), err_msg=name, **ALGO_TOL)


def test_cpu_autograd_goes_through_the_plain_versions():
    """On CPU tensors the forward wrappers run the plain versions, which
    autograd differentiates: no launch is counted, forward or backward,
    and the backward kernels' wrappers refuse CPU tensors."""
    fa.reset_launches()
    sk.reset_launches()
    assert set(fa.LAUNCHES) == {"flash_attention", "flash_attention_backward"}
    assert set(sk.LAUNCHES) == {"ssd_scan", "ssd_scan_backward"}
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 9, 2, 8), generator=g, requires_grad=True) for _ in range(3))
    fa.flash_attention(q, k, v, window=4).sum().backward()
    x = torch.randn((1, 9, 2, 4), generator=g, requires_grad=True)
    dt = torch.rand((1, 9, 2), generator=g) * 0.5
    B, C = (torch.randn((1, 9, 1, 4), generator=g) for _ in range(2))
    y, final = sk.ssd_scan_fused(x, -dt, dt, B, C)
    (y.sum() + final.sum()).backward()
    assert q.grad is not None and x.grad is not None
    assert not any(fa.LAUNCHES.values()) and not any(sk.LAUNCHES.values())
    o = q.detach()
    lse = torch.zeros((1, 2, 9))
    with pytest.raises(ValueError, match="runs on the card"):
        fa.flash_attention_backward(q.detach(), k.detach(), v.detach(), o, o, lse)
    with pytest.raises(ValueError, match="runs on the card"):
        sk.ssd_scan_backward(x.detach(), -dt, dt, B, C, torch.ones_like(x))
