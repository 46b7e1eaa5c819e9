"""The SSD kernels' three phases in plain PyTorch against the JAX package.

``csrc/ssd_scan.cu`` splits the chunked SSD into the chunk states, the
state passing and the chunk output; ``kernels/ref.py`` models each phase
(``ssd_chunk_states_ref``, ``ssd_state_pass_ref``, ``ssd_chunk_out_ref``,
composed by ``ssd_phases_ref``). They are held here against
``repro/models/transformer/ssm.py::ssd_chunked_jnp`` and against the Pallas
kernel ``ssd_scan_pallas`` in interpret mode, on the CPU, at the
tolerances of ``tests/test_torch_lm.py``: rtol 2e-5 / atol 2e-5 (one op,
sums in another order); the fast-decay case states its own, from the
rounding of its large running sums. The card tests hold the kernels
themselves.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models.transformer.ssm import ssd_chunked_jnp  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ssd_chunk_states_ref,
    ssd_chunked_ref,
    ssd_phases_ref,
    ssd_state_pass_ref,
)

OP_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _inputs(bz, s, h, p, g, n, seed, init=False, a_scale=1.0):
    """numpy inputs: a = dt * A with A in [-1.1, -0.1) times ``a_scale``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bz, s, h, p)).astype(np.float32)
    dt = (rng.random((bz, s, h)) * 0.5 + 0.01).astype(np.float32)
    A = ((-rng.random(h) - 0.1) * a_scale).astype(np.float32)
    B = rng.standard_normal((bz, s, g, n)).astype(np.float32)
    C = rng.standard_normal((bz, s, g, n)).astype(np.float32)
    st = rng.standard_normal((bz, h, p, n)).astype(np.float32) if init else None
    return x, (dt * A).astype(np.float32), dt, B, C, st


def _jnp(x, a, dt, B, C, st, chunk):
    y, state = ssd_chunked_jnp(*(jnp.asarray(t) for t in (x, a, dt, B, C)), chunk=chunk,
                               init_state=None if st is None else jnp.asarray(st))
    return np.asarray(y), np.asarray(state)


@pytest.mark.parametrize("S,chunk,h,g,init", [
    (48, 16, 4, 2, False), (50, 16, 4, 2, True), (7, 16, 4, 1, True), (64, 64, 8, 2, True),
    (65, 64, 8, 4, False), (129, 64, 6, 3, True), (127, 128, 4, 4, True), (257, 128, 2, 1, False),
])
def test_ssd_phases_ref_matches_ssd_chunked_jnp(S, chunk, h, g, init):
    """Ragged S around the kernels' chunk lengths, G < H, an initial state."""
    x, a, dt, B, C, st = _inputs(2, S, h, 8, g, 6, S + h, init)
    want_y, want_st = _jnp(x, a, dt, B, C, st, chunk)
    y, state = ssd_phases_ref(*(_t(v) for v in (x, a, dt, B, C)), chunk=chunk,
                              init_state=_t(st))
    np.testing.assert_allclose(y.numpy(), want_y, **OP_TOL)
    np.testing.assert_allclose(state.numpy(), want_st, **OP_TOL)


@pytest.mark.parametrize("S,P,N,chunk", [(64, 16, 8, 16), (100, 32, 16, 32), (33, 8, 4, 16)])
def test_ssd_phases_ref_matches_ssd_scan_pallas(S, P, N, chunk):
    x, a, dt, B, C, _ = _inputs(1, S, 1, P, 1, N, S)
    want_y, want_st = ssd_scan_pallas(*(jnp.asarray(t[0, :, 0]) for t in (x, a, dt, B, C)),
                                      chunk=chunk)
    y, state = ssd_phases_ref(*(_t(v) for v in (x, a, dt, B, C)), chunk=chunk)
    np.testing.assert_allclose(y[0, :, 0].numpy(), np.asarray(want_y), **OP_TOL)
    np.testing.assert_allclose(state[0, 0].numpy(), np.asarray(want_st), **OP_TOL)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_ssd_phases_ref_does_not_depend_on_the_chunk_length(chunk):
    """The kernels' L is their own: any chunk length gives the same function
    as the plain version's chunk of 32."""
    x, a, dt, B, C, st = _inputs(2, 150, 4, 8, 2, 6, 5, True)
    want_y, want_st = _jnp(x, a, dt, B, C, st, 32)
    y, state = ssd_phases_ref(*(_t(v) for v in (x, a, dt, B, C)), chunk=chunk,
                              init_state=_t(st))
    np.testing.assert_allclose(y.numpy(), want_y, **OP_TOL)
    np.testing.assert_allclose(state.numpy(), want_st, **OP_TOL)


@pytest.mark.parametrize("S", [16, 11])
def test_ssd_chunk_states_ref_of_one_chunk_is_the_scan_state(S):
    """One chunk from a zero state: its own state is the scan's final state
    and its decay exp(sum a), with a ragged chunk padded by a = 0."""
    x, a, dt, B, C, _ = _inputs(2, S, 4, 8, 2, 6, S)
    _, want_st = _jnp(x, a, dt, B, C, None, 16)
    states, decay = ssd_chunk_states_ref(*(_t(v) for v in (x, a, dt, B)), chunk=16)
    assert states.shape == (2, 4, 1, 8, 6) and decay.shape == (2, 4, 1)
    np.testing.assert_allclose(states[:, :, 0].numpy(), want_st, **OP_TOL)
    np.testing.assert_allclose(decay[:, :, 0].numpy(), np.exp(a.sum(axis=1)), **OP_TOL)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_state_pass_ref_gives_the_state_at_each_chunk_start(init):
    """Slot c of the pass is the scan's state after the first c chunks."""
    x, a, dt, B, C, st = _inputs(2, 48, 4, 8, 2, 6, 9, init)
    states, decay = ssd_chunk_states_ref(*(_t(v) for v in (x, a, dt, B)), chunk=16)
    entering, final = ssd_state_pass_ref(states, decay, _t(st))
    want0 = np.zeros((2, 4, 8, 6), np.float32) if st is None else st
    np.testing.assert_allclose(entering[:, :, 0].numpy(), want0, **OP_TOL)
    for c in (1, 2):
        cut = [v[:, :16 * c] for v in (x, a, dt, B, C)]
        _, want = _jnp(*cut, st, 16)
        np.testing.assert_allclose(entering[:, :, c].numpy(), want, **OP_TOL)
    _, want_final = _jnp(x, a, dt, B, C, st, 16)
    np.testing.assert_allclose(final.numpy(), want_final, **OP_TOL)


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_phases_ref_fast_decay_underflows_without_nan(chunk):
    """a down to -30 a step: decays underflow to 0 within a chunk, and
    nothing overflows (every exponent taken is <= 0). The exponents are
    differences of float32 running sums of up to 30 L, which the two
    packages add in another order: each is off by up to |csum| 2^-24, so
    the tolerance is twice that, relative (2e-5 where that is smaller)."""
    x, a, dt, B, C, st = _inputs(1, chunk + 9, 4, 8, 1, 6, 3, True, a_scale=54.0)
    assert a.min() < -25
    y, state = ssd_phases_ref(*(_t(v) for v in (x, a, dt, B, C)), chunk=chunk,
                              init_state=_t(st))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want_y, want_st = _jnp(x, a, dt, B, C, st, chunk)
    csum = float(-a[:, :chunk].sum(axis=1).min())
    tol = max(2e-5, 2 * csum * 2.0**-24)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=tol, atol=tol)
    np.testing.assert_allclose(state.numpy(), want_st, rtol=tol, atol=tol)


def test_ssd_phases_ref_of_an_empty_sequence_keeps_the_state():
    x, a, dt, B, C, st = _inputs(2, 0, 4, 8, 2, 6, 1, True)
    y, state = ssd_phases_ref(*(_t(v) for v in (x, a, dt, B, C)), chunk=16, init_state=_t(st))
    assert y.shape == (2, 0, 4, 8)
    np.testing.assert_array_equal(state.numpy(), st)
    want_y, want_st = ssd_chunked_ref(*(_t(v) for v in (x, a, dt, B, C)), chunk=16,
                                      init_state=_t(st))
    assert want_y.shape == y.shape and torch.equal(want_st, state)
