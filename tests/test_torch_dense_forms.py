"""The dense call forms (ids in any order) of the port against the JAX
package, on the CPU.

``ops.gnn_aggregate(..., ragged=False)`` and
``ops.gnn_gather_aggregate(..., ragged=False)`` take CPU tensors to their
plain versions; they are held against the JAX oracles and against
``segment_spmm_pallas`` and ``gather_spmm_pallas`` in interpret mode with
small blocks, as ``tests/test_kernels.py`` and
``tests/test_fused_kernels.py`` run them. The same numpy inputs go to both
sides: shuffled ids, padding (-1) inside the array, ids >= n, edge counts
that fill no whole block, no edges and a single segment. Tolerances:
float32 rtol 1e-5 / atol 1e-5 (sums in another order); bfloat16 rtol 1e-2
/ atol 1e-2, about one rounding of the output, against the oracle and the
Pallas kernels run on the inputs upcast to float32, their results rounded
to bfloat16: the port sums in float32 and rounds once, where the oracle
and the Pallas kernels sum in bfloat16, which at a few hundred edges
drifts past one rounding (the trap ``ROADMAP.md`` pins). The sort the card
runs first has its plain version here too: ``segment_sort_ref`` against
``np.argsort(kind="stable")`` of the same key.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fused_gnn import gather_spmm_pallas  # noqa: E402
from repro.kernels.ref import gather_spmm_ref as jax_gather_ref  # noqa: E402
from repro.kernels.ref import segment_spmm_ref as jax_seg_ref  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm_pallas  # noqa: E402
from repro_torch.kernels import fused_gnn, ops  # noqa: E402
from repro_torch.kernels.ref import segment_sort_ref  # noqa: E402

_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype):
    rtol, atol = _TOL[dtype]
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol
    )


def _inputs(m, n, f, d, seed, pad=0.15, over=0.05):
    """numpy ids in any order: a ``pad`` share of seg -1 anywhere, an
    ``over`` share of ids >= n, 10% idx -1; feats [f, d], msg [m, d]."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, m)
    pick = rng.random(m)
    seg[pick < pad] = -1
    high = (pick >= pad) & (pick < pad + over)
    seg[high] = n + rng.integers(0, 5, int(high.sum()))
    idx = np.where(rng.random(m) < 0.1, -1, rng.integers(0, f, m))
    feats = rng.standard_normal((f, d)).astype(np.float32)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    return seg.astype(np.int32), idx.astype(np.int32), feats, msg


# (edges, segments, rows of feats, width, seed)
DENSE_CASES = [
    (0, 4, 3, 5, 0),  # no edges
    (1, 1, 1, 1, 1),  # one edge, one segment
    (100, 1, 20, 8, 2),  # one segment, many edges
    (37, 11, 9, 3, 3),  # fills no whole block
    (250, 40, 30, 16, 4),
    (333, 200, 50, 4, 5),  # mostly empty segments
    (512, 64, 64, 24, 6),  # whole blocks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,f,d,seed", DENSE_CASES)
def test_dense_segment_sum_matches_jax_and_pallas(m, n, f, d, seed, dtype):
    seg, _, _, msg = _inputs(m, n, f, d, seed)
    got = ops.gnn_aggregate(torch.as_tensor(msg).to(_TORCH[dtype]), torch.as_tensor(seg), n,
                            ragged=False)
    assert got.dtype == _TORCH[dtype] and got.shape == (n, d)
    jmsg = jnp.asarray(msg, _JNP[dtype]).astype(jnp.float32)
    want = jax_seg_ref(jmsg, jnp.asarray(seg), n).astype(_JNP[dtype])
    _close(got.float().numpy(), want, dtype)
    if m:  # the Pallas kernel takes no empty edge array (its first block slices 16 edges)
        pallas = segment_spmm_pallas(jmsg, jnp.asarray(seg), n, block_rows=8, block_edges=16)
        _close(got.float().numpy(), pallas.astype(_JNP[dtype]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,f,d,seed", DENSE_CASES)
def test_dense_gather_sum_matches_jax_and_pallas(m, n, f, d, seed, dtype):
    seg, idx, feats, _ = _inputs(m, n, f, d, seed)
    got = ops.gnn_gather_aggregate(torch.as_tensor(feats).to(_TORCH[dtype]),
                                   torch.as_tensor(idx), torch.as_tensor(seg), n, ragged=False)
    assert got.dtype == _TORCH[dtype] and got.shape == (n, d)
    jfeats = jnp.asarray(feats, _JNP[dtype]).astype(jnp.float32)
    jidx, jseg = jnp.asarray(idx), jnp.asarray(seg)
    want = jax_gather_ref(jfeats, jidx, jseg, n).astype(_JNP[dtype])
    _close(got.float().numpy(), want, dtype)
    pallas = gather_spmm_pallas(jfeats, jidx, jseg, n, block_edges=16)
    _close(got.float().numpy(), pallas.astype(_JNP[dtype]), dtype)


@pytest.mark.parametrize("m,n,f,d,seed", DENSE_CASES)
def test_dense_and_ragged_forms_agree_on_sorted_input(m, n, f, d, seed):
    """Over the stable-sorted edges the dense form is the ragged form: the
    card computes it just so (sort, then the CSR kernel)."""
    seg, idx, feats, msg = _inputs(m, n, f, d, seed)
    t_seg, t_idx = torch.as_tensor(seg), torch.as_tensor(idx)
    order = segment_sort_ref(t_seg, n).long()
    t_msg, t_feats = torch.as_tensor(msg), torch.as_tensor(feats)
    np.testing.assert_allclose(
        ops.gnn_aggregate(t_msg, t_seg, n, ragged=False).numpy(),
        ops.gnn_aggregate(t_msg[order], t_seg[order], n).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ops.gnn_gather_aggregate(t_feats, t_idx, t_seg, n, ragged=False).numpy(),
        ops.gnn_gather_aggregate(t_feats, t_idx[order], t_seg[order], n).numpy(),
        rtol=1e-6, atol=1e-6)


def test_dense_forms_launch_nothing_on_cpu_and_take_no_idx_order():
    seg, idx, feats, msg = _inputs(64, 10, 12, 4, 7)
    fused_gnn.reset_launches()
    ops.gnn_aggregate(torch.as_tensor(msg), torch.as_tensor(seg), 10, ragged=False)
    ops.gnn_gather_aggregate(torch.as_tensor(feats), torch.as_tensor(idx),
                             torch.as_tensor(seg), 10, ragged=False)
    assert set(fused_gnn.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="idx_order"):
        ops.gnn_gather_aggregate(torch.as_tensor(feats), torch.as_tensor(idx),
                                 torch.as_tensor(seg), 10,
                                 fused_gnn.sort_order(torch.as_tensor(idx)), ragged=False)


# (edges, key bound n, kind): the sort's passes change at n = 256, 65536
# and 2**24 (1 to 4 passes)
SORT_CASES = [
    (0, 5, "uniform"),
    (1, 1, "uniform"),
    (300, 1, "uniform"),
    (5000, 255, "uniform"),
    (5000, 256, "uniform"),
    (9000, 65536, "uniform"),
    (9000, 2**24 + 1, "uniform"),
    (5000, 300, "all padding"),
    (5000, 300, "one hot key"),
]


@pytest.mark.parametrize("m,n,kind", SORT_CASES)
def test_plain_stable_order_is_numpys_stable_argsort(m, n, kind):
    rng = np.random.default_rng(m + n)
    seg = rng.integers(-2, n + 3, m)
    if kind == "all padding":
        seg[:] = -1
    elif kind == "one hot key":
        seg[rng.random(m) < 0.9] = n // 2
    seg = seg.astype(np.int32)
    key = np.where((seg < 0) | (seg >= n), n, seg)
    got = fused_gnn.segment_sort(torch.as_tensor(seg), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(segment_sort_ref(torch.as_tensor(seg), n).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("bound", [None, 40])
def test_sort_order_puts_padding_last_in_index_order(bound):
    """With or without a bound on the ids, the gather backward's order is
    numpy's stable argsort with the padding (idx < 0) last."""
    rng = np.random.default_rng(11)
    idx = rng.integers(-1, 40, 500)
    want = np.argsort(np.where(idx < 0, 2**31 - 1, idx), kind="stable")
    got = fused_gnn.sort_order(torch.as_tensor(idx), bound)  # int64 ids are cast
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,passes", [(0, 1), (1, 1), (255, 1), (256, 2), (65535, 2),
                                      (65536, 3), (150000, 3), (2**24, 4), (2**31 - 1, 4)])
def test_sort_passes_cover_the_keys(n, passes):
    """Keys run over [0, n]: the passes of 8 bits that hold n."""
    assert fused_gnn.sort_passes(n) == passes
