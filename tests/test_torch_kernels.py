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
    segment_spmm_ragged_pallas,
)
from repro.kernels.ref import gat_softmax_aggregate_ref as jax_gat_ref  # noqa: E402
from repro.kernels.ref import segment_spmm_ref as jax_seg_ref  # noqa: E402
from repro_torch.kernels import fused_gnn, ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    gat_softmax_aggregate_ref,
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
    assert fused_gnn.LAUNCHES == {"segment_spmm_ragged": 0, "gat_softmax_aggregate": 0}
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
