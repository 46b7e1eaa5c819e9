"""The port's plain kernel versions against the JAX package's oracles and
its Pallas kernels (interpret mode), on the CPU.

The sweep follows ``tests/test_fused_kernels.py``: ragged edge counts,
padding tails, all-padding and zero-edge inputs, empty segments, float32
(rtol 1e-5 / atol 1e-4) and bfloat16 (rtol 1e-2 / atol 1e-2, about one
rounding of the output). The same numpy inputs go to both sides. The port
sums bfloat16 in float32 and rounds once, so for bfloat16 it is held
against the JAX oracle run on the inputs upcast to float32 and rounded to
bfloat16 (the oracle itself sums in bfloat16), and against the Pallas
kernel as it is. CPU tensors take the plain version and never count as a
kernel launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fused_gnn import (  # noqa: E402
    gat_softmax_aggregate_pallas,
    segment_max_pallas,
    segment_spmm_ragged_pallas,
)
from repro.kernels.ref import gat_softmax_aggregate_ref as jax_gat_ref  # noqa: E402
from repro.kernels.ref import segment_max_ref as jax_max_ref  # noqa: E402
from repro.kernels.ref import segment_spmm_ref as jax_seg_ref  # noqa: E402
from repro_torch.kernels import fused_gnn, ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    gat_softmax_aggregate_ref,
    segment_max_ref,
    segment_spmm_ragged_ref,
)

_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype, tol=None):
    rtol, atol = tol or _TOL[dtype]
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol
    )


def _np(t):
    return t.float().numpy()


def _edges(m, n, valid, seed, d, dtype, shuffle=False):
    """Both sides' seg/msg/logits from one numpy draw: seg sorted with a
    padding tail after ``valid`` edges (or shuffled)."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, max(m, 1))).astype(np.int32)[:m]
    seg[valid:] = -1
    if shuffle:
        seg = rng.permutation(seg)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    logits = rng.standard_normal(m).astype(np.float32)
    jx = (jnp.asarray(seg), jnp.asarray(msg, _JNP[dtype]), jnp.asarray(logits, _JNP[dtype]))
    th = (
        torch.as_tensor(seg),
        torch.as_tensor(msg).to(_TORCH[dtype]),
        torch.as_tensor(logits).to(_TORCH[dtype]),
    )
    return jx, th


# (edges, segments, width, valid fraction, seed)
SWEEP = [
    (0, 4, 5, 1.0, 0),  # zero edges
    (1, 1, 1, 1.0, 1),
    (37, 11, 3, 1.0, 2),
    (64, 40, 8, 0.0, 3),  # all padding
    (96, 7, 24, 0.5, 4),  # padding tail over whole tiles
    (120, 40, 16, 0.93, 5),
    (50, 200, 4, 1.0, 6),  # mostly empty segments
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_segment_spmm_ragged_plain_matches_jax(m, n, d, frac, seed, dtype):
    (jseg, jmsg, _), (tseg, tmsg, _) = _edges(m, n, int(m * frac), seed, d, dtype)
    got = segment_spmm_ragged_ref(tmsg, tseg, n)
    assert got.dtype == _TORCH[dtype] and got.shape == (n, d)
    want = jax_seg_ref(jmsg.astype(jnp.float32), jseg, n).astype(_JNP[dtype])
    _close(_np(got), want, dtype)
    _close(_np(got), segment_spmm_ragged_pallas(jmsg, jseg, n, block_edges=32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_gat_softmax_aggregate_plain_matches_jax(m, n, d, frac, seed, dtype):
    (jseg, jmsg, jlog), (tseg, tmsg, tlog) = _edges(m, n, int(m * frac), seed, d, dtype)
    got = gat_softmax_aggregate_ref(tlog, tmsg, tseg, n)
    assert got.dtype == _TORCH[dtype] and got.shape == (n, d)
    # softmax-weighted sums amplify error a touch vs plain sums (as in
    # tests/test_fused_kernels.py)
    tol = (1e-4, 1e-3) if dtype == "float32" else None
    _close(_np(got), jax_gat_ref(jlog, jmsg, jseg, n), dtype, tol)
    pallas = gat_softmax_aggregate_pallas(jlog, jmsg, jseg, n, block_edges=32)
    _close(_np(got), pallas, dtype, tol)


@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_unsorted_segments_match_jax(m, n, d, frac, seed):
    (jseg, jmsg, jlog), (tseg, tmsg, tlog) = _edges(
        m, n, int(m * frac), seed, d, "float32", shuffle=True
    )
    _close(_np(ops.gnn_aggregate(tmsg, tseg, n)), jax_seg_ref(jmsg, jseg, n), "float32")
    _close(
        _np(ops.gnn_gat_aggregate(tlog, tmsg, tseg, n)),
        jax_gat_ref(jlog, jmsg, jseg, n),
        "float32",
        (1e-4, 1e-3),
    )


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_aggregate_and_count_matches_jax(m, n, d, frac, seed, shuffle):
    """The sum and the degree column gcn/sage divide by, as the JAX model
    counts it (``_seg_count``: a segment sum of ones over valid edges)."""
    (jseg, jmsg, _), (tseg, tmsg, _) = _edges(
        m, n, int(m * frac), seed, d, "float32", shuffle=shuffle
    )
    agg, cnt = ops.gnn_aggregate_and_count(tmsg, tseg, n)
    assert agg.shape == (n, d) and cnt.shape == (n, 1) and cnt.dtype == torch.float32
    _close(_np(agg), jax_seg_ref(jmsg, jseg, n), "float32")
    ones = (jseg >= 0).astype(jnp.float32)[:, None]
    np.testing.assert_array_equal(_np(cnt), np.asarray(jax_seg_ref(ones, jseg, n)))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (_, _, _), (tseg, tmsg, tlog) = _edges(80, 9, 70, 3, 6, "float32")
    fused_gnn.reset_launches()
    a = ops.gnn_aggregate(tmsg, tseg, 9)
    b = ops.gnn_gat_aggregate(tlog, tmsg, tseg, 9)
    agg, cnt = ops.gnn_aggregate_and_count(tmsg, tseg, 9)
    heads = ops.gnn_gat_aggregate(
        torch.stack([tlog, 2 * tlog], 1), torch.stack([tmsg, -tmsg], 1), tseg, 9
    )
    mx = ops.gnn_segment_max(tlog, tseg, 9)
    assert set(fused_gnn.LAUNCHES.values()) == {0}
    assert torch.equal(mx, segment_max_ref(tlog, tseg, 9))
    assert torch.equal(a, segment_spmm_ragged_ref(tmsg, tseg, 9)) and torch.equal(agg, a)
    assert torch.equal(cnt[:, 0], torch.bincount(tseg[tseg >= 0], minlength=9).float())
    assert torch.equal(b, gat_softmax_aggregate_ref(tlog, tmsg, tseg, 9))
    assert heads.shape == (9, 2, 6) and torch.equal(heads[:, 0], b)
    assert torch.equal(heads[:, 1], gat_softmax_aggregate_ref(2 * tlog, -tmsg, tseg, 9))


def test_mixed_devices_and_bad_shapes_raise():
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.gnn_gat_aggregate(torch.zeros(4), torch.zeros(5, 3), seg, 2)
    with pytest.raises(ValueError):
        ops.gnn_gat_aggregate(torch.zeros(4, 2), torch.zeros(4, 3), seg, 2)
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        ops.gnn_aggregate(meta, seg, 2)


# ---------------------------------------------------------------------------
# segment max: ids in any order, padding (-1) and ids >= n ignored
# ---------------------------------------------------------------------------


def _max_inputs(m, n, seed, pad=0.1, over=0.05, sort=False):
    """x [m] float32 and seg [m] int32 from one numpy draw: ids uniform in
    [0, n) (sorted or not), a ``pad`` share set to -1 and an ``over`` share
    to ids >= n."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, max(n, 1), m).astype(np.int32)
    if sort:
        seg = np.sort(seg)
    pick = rng.random(m)
    seg[pick < pad] = -1
    seg[(pick >= pad) & (pick < pad + over)] = n + rng.integers(0, 3, m)[
        (pick >= pad) & (pick < pad + over)]
    return rng.standard_normal(m).astype(np.float32) * 3, seg


# (edges, segments, padding share, ids >= n share, sorted, seed)
MAX_SWEEP = [
    (0, 4, 0.0, 0.0, False, 0),  # zero edges
    (1, 1, 0.0, 0.0, False, 1),
    (37, 11, 0.0, 0.0, True, 2),
    (64, 40, 1.0, 0.0, False, 3),  # all padding
    (300, 17, 0.1, 0.05, False, 4),  # shuffled ids, padding and ids >= n inside
    (200, 500, 0.1, 0.0, False, 5),  # mostly empty segments
    (1000, 64, 0.3, 0.1, True, 6),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,pad,over,sort,seed", MAX_SWEEP)
def test_segment_max_plain_matches_jax(m, n, pad, over, sort, seed, dtype):
    """A max has no rounding: the port equals the JAX reference and the
    Pallas kernel exactly (bf16 values are exact in float32)."""
    x, seg = _max_inputs(m, n, seed, pad, over, sort)
    jx = jnp.asarray(x, _JNP[dtype])
    tx = torch.as_tensor(x).to(_TORCH[dtype])
    got = ops.gnn_segment_max(tx, torch.as_tensor(seg), n)
    assert got.dtype == _TORCH[dtype] and got.shape == (n,)
    want = np.asarray(jax_max_ref(jx, jnp.asarray(seg), n), np.float32)
    np.testing.assert_array_equal(_np(got), want)
    pallas = segment_max_pallas(jx, jnp.asarray(seg), n, block_edges=32)
    np.testing.assert_array_equal(_np(got), np.asarray(pallas, np.float32))
    assert torch.equal(got, segment_max_ref(tx, torch.as_tensor(seg), n))


def test_segment_max_keeps_the_references_semantics_below_minus_5e29():
    """The Pallas kernel starts from -1e30 and zeroes any max <= -5e29; the
    jnp reference starts from -inf and zeroes only non-finite maxima. The
    port keeps the reference's: a segment of -1e30 and -7e29 gives -7e29
    (the Pallas kernel gives 0.0); -inf alone gives 0.0 in all three."""
    x = np.array([-1e30, -7e29, 2.0, -np.inf, 1.5], np.float32)
    seg = np.array([0, 0, 1, 2, 1], np.int32)
    got = _np(ops.gnn_segment_max(torch.as_tensor(x), torch.as_tensor(seg), 4))
    want = np.asarray(jax_max_ref(jnp.asarray(x), jnp.asarray(seg), 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([-7e29, 2.0, 0.0, 0.0], np.float32))
    pallas = np.asarray(segment_max_pallas(jnp.asarray(x), jnp.asarray(seg), 4, block_edges=8))
    np.testing.assert_array_equal(pallas, np.array([0.0, 2.0, 0.0, 0.0], np.float32))


def test_segment_max_orders_nan_above_inf_and_minus_zero_below_zero():
    """NaN or +-inf in a segment give 0.0, as the JAX reference's NaN that
    propagates and its ``isfinite`` fix give; -0.0 survives only where no
    +0.0 shares its segment, in any edge order."""
    x = np.array([1.0, np.nan, -0.0, 0.0, -0.0, np.inf, -np.nan, 3.0, -0.0, 0.0], np.float32)
    seg = np.array([0, 0, 1, 1, 2, 3, 4, 4, 5, 5], np.int32)
    want = np.asarray(jax_max_ref(jnp.asarray(x), jnp.asarray(seg), 7))
    for perm in (np.arange(10), np.random.default_rng(0).permutation(10)):
        got = ops.gnn_segment_max(torch.as_tensor(x[perm]), torch.as_tensor(seg[perm]), 7)
        np.testing.assert_array_equal(_np(got), want)
        assert torch.signbit(got).tolist() == [False, False, True, False, False, False, False]
