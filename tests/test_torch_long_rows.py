"""The CSR sum kernel's order of additions on long rows, on the CPU.

The card's sum kernel (``src/repro_torch/kernels/csrc/segment_sum.cu``)
cuts a row of more than L = ``ref.SUM_CHUNK`` edge slots into chunks of L
slots counted from the row's own first slot, sums each chunk in slot order
and adds the chunk sums in chunk order; a row of at most L slots is one
plain sum in slot order. ``ref.chunked_segment_sum_ref`` is that order in
plain PyTorch, the oracle the card tests hold the kernel to bit for bit.
Here the oracle is held against the JAX package's references
(``repro/kernels/ref.py``) and its Pallas kernels in interpret mode on the
same numpy inputs, and its own properties are pinned: a row's bits do not
depend on the rows around it, short rows are plain sequential float32
sums, long rows are chunk sums added in chunk order. The sort's digit
widths are checked here too.

Tolerance against the JAX side, per element: the float32 rounding bound
of the chunked order, 2 u (sum of |running sums within each chunk| + sum
of |running sums of the chunk combine after its first chunk|), u = 2^-24,
plus the JAX side's own float32 bound for a sum in an unknown order,
2 u (k - 1) sum |x| for a row of k terms (its scatter-add or one-hot
matmul adds in an order of its own); both against the float64 sum, whose
own rounding, k 2^-53 sum |x|, is added once.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fused_gnn import gather_spmm_pallas  # noqa: E402
from repro.kernels.ref import gather_spmm_ref as jax_gather_ref  # noqa: E402
from repro.kernels.ref import segment_spmm_ref as jax_seg_ref  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm_pallas  # noqa: E402
from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    SUM_CHUNK,
    chunked_segment_sum_ref,
    segment_sort_ref,
)

L = SUM_CHUNK
U32 = 2.0**-24
U64 = 2.0**-53
COMMON = Path(fused_gnn.__file__).resolve().parent / "csrc" / "common.cuh"


def test_chunk_length_mirrors_the_kernel_source():
    found = re.findall(r"^#define REPRO_SUM_CHUNK (\d+)$", COMMON.read_text(), re.M)
    assert found == [str(SUM_CHUNK)]
    assert fused_gnn.SUM_CHUNK == SUM_CHUNK
    assert "constexpr int kSumChunk = REPRO_SUM_CHUNK;" in COMMON.read_text()


def _edges(lengths, n, d, f, seed, pad=0.1, over=0.02, drop=0.05):
    """Rows with the given numbers of edge slots (row r has lengths[r]),
    plus a ``pad`` share of padding (-1) and an ``over`` share of ids >= n,
    shuffled; idx (rows of feats) with a ``drop`` share of -1; numpy."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(np.arange(len(lengths)), lengths)
    m = seg.shape[0]
    extra = np.concatenate([np.full(int(m * pad), -1), n + rng.integers(0, 4, int(m * over))])
    seg = rng.permutation(np.concatenate([seg, extra])).astype(np.int32)
    e = seg.shape[0]
    idx = np.where(rng.random(e) < drop, -1, rng.integers(0, f, e)).astype(np.int32)
    feats = rng.standard_normal((f, d)).astype(np.float32)
    msg = rng.standard_normal((e, d)).astype(np.float32)
    return seg, idx, feats, msg


def _model_inputs(seg, idx, feats, msg, n, gather):
    """The kernel's view: the slots stable-sorted by id (the card's sort),
    the rows it reads there, and which slots add."""
    order = segment_sort_ref(torch.as_tensor(seg), n).long()
    s_seg = torch.as_tensor(seg)[order]
    if not gather:
        return torch.as_tensor(msg)[order], s_seg, None
    s_idx = torch.as_tensor(idx)[order]
    terms = torch.as_tensor(feats)[s_idx.clamp_min(0).long()]
    return terms, s_seg, s_idx >= 0


def _exact_and_bounds(terms, s_seg, keep, n):
    """Per row (numpy float64): the exact sum, the chunked order's float32
    bound, and an any-order float32 bound, each [n, D]."""
    x = terms.double().numpy()
    if keep is not None:
        x = np.where(keep.numpy()[:, None], x, 0.0)
    key = s_seg.long().numpy()
    key = np.where((key >= 0) & (key < n), key, n)  # the padding's key: last
    d = x.shape[1]
    exact, chunked, any_order = (np.zeros((n, d)) for _ in range(3))
    for r in range(n):
        lo, hi = np.searchsorted(key, r), np.searchsorted(key, r, side="right")
        rows = x[lo:hi]
        if not len(rows):
            continue
        mag = np.abs(rows).sum(0)
        k = len(rows)
        spread = np.zeros(d)
        sums = []
        for c in range(0, k, L):
            running = np.cumsum(rows[c:c + L], 0)
            spread += np.abs(running).sum(0)
            sums.append(running[-1])
        spread += np.abs(np.cumsum(sums, 0)[1:]).sum(0)
        exact[r] = rows.sum(0)
        chunked[r] = 2 * U32 * spread + k * U64 * mag
        any_order[r] = 2 * U32 * max(k - 1, 0) * mag + k * U64 * mag
    return exact, chunked, any_order


def _assert_within(name, got, want, limit):
    got = np.asarray(got, np.float64)
    diff = np.abs(got - want)
    worst = np.unravel_index(np.argmax(diff - limit), diff.shape)
    assert np.all(diff <= limit), (name, worst, diff[worst], limit[worst])


HUB = 5003  # one row of at least 5,000 edges
LENGTHS = {
    # a power-law row profile: the hub, Zipf rows capped at 4L, empty rows
    "power law": [HUB] + list(np.minimum(np.random.default_rng(0).zipf(1.6, 80), 4 * L))
    + [0, 0],
    # every chunk edge: one short of a chunk, a whole one, one over, two
    "chunk edges": [L - 1, L, L + 1, 2 * L, 2 * L + 1, 1, 0, 3 * L - 1, 5 * L + 7],
}


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_order_model_matches_the_jax_references(case, gather):
    lengths = LENGTHS[case]
    n, d, f = len(lengths), 16, 700
    seg, idx, feats, msg = _edges(lengths, n, d, f, seed=len(case) + gather)
    terms, s_seg, keep = _model_inputs(seg, idx, feats, msg, n, gather)
    got = chunked_segment_sum_ref(terms, s_seg, n, keep).numpy()
    exact, chunked, any_order = _exact_and_bounds(terms, s_seg, keep, n)
    _assert_within("chunked order vs float64", got, exact, chunked)
    if gather:
        want = jax_gather_ref(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(seg), n)
    else:
        want = jax_seg_ref(jnp.asarray(msg), jnp.asarray(seg), n)
    _assert_within("JAX reference vs float64", want, exact, any_order)
    _assert_within("chunked order vs the JAX reference", got, np.asarray(want, np.float64),
                   chunked + any_order)


@pytest.mark.parametrize("gather", [False, True])
def test_order_model_matches_the_pallas_kernels_in_interpret_mode(gather):
    lengths = [L - 1, L, L + 1, 2 * L, 1, 0]
    n, d, f = len(lengths), 8, 50
    seg, idx, feats, msg = _edges(lengths, n, d, f, seed=3 + gather)
    terms, s_seg, keep = _model_inputs(seg, idx, feats, msg, n, gather)
    got = chunked_segment_sum_ref(terms, s_seg, n, keep).numpy()
    exact, chunked, any_order = _exact_and_bounds(terms, s_seg, keep, n)
    if gather:
        pallas = gather_spmm_pallas(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(seg), n,
                                    block_edges=64)
    else:
        pallas = segment_spmm_pallas(jnp.asarray(msg), jnp.asarray(seg), n, block_rows=8,
                                     block_edges=64)
    _assert_within("Pallas vs float64", pallas, exact, any_order)
    _assert_within("chunked order vs Pallas", got, np.asarray(pallas, np.float64),
                   chunked + any_order)


def _sorted_rows(lengths, d, seed, drop=0.0):
    """Rows already in slot order (seg non-decreasing, padding at the
    tail), float32 terms, and which slots add."""
    rng = np.random.default_rng(seed)
    seg = np.concatenate([np.repeat(np.arange(len(lengths)), lengths), np.full(5, -1)])
    terms = rng.standard_normal((seg.shape[0], d)).astype(np.float32)
    keep = rng.random(seg.shape[0]) >= drop
    return torch.as_tensor(seg.astype(np.int32)), torch.as_tensor(terms), torch.as_tensor(keep)


@pytest.mark.parametrize("before,after", [([], []), ([3], []), ([], [L + 5]),
                                          ([L - 1, 2 * L + 3, 7], [1, 4 * L]),
                                          ([1] * 37, [L] * 3), ([0, 0, 300], [0])])
@pytest.mark.parametrize("row", [L, L + 1, 10 * L + 13, 1000])
def test_a_rows_bits_do_not_depend_on_the_rows_around_it(row, before, after):
    """Chunks are counted from the row's own first slot, so the row sums
    to the same bits at any offset among any other rows."""
    lengths = before + [row] + after
    seg, terms, keep = _sorted_rows(lengths, 12, seed=row)
    alone_seg, alone_terms, alone_keep = _sorted_rows([row], 12, seed=row)
    start = sum(before)
    mine = slice(start, start + row)
    # the same row's terms in both
    terms[mine] = alone_terms[:row]
    keep[mine] = alone_keep[:row]
    got = chunked_segment_sum_ref(terms, seg, len(lengths), keep)[len(before)]
    want = chunked_segment_sum_ref(alone_terms, alone_seg, 1, alone_keep)[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_rows_of_at_most_l_edges_are_plain_sequential_sums(drop):
    lengths = [1, 2, 3, L // 2, L - 1, L, 0]
    seg, terms, keep = _sorted_rows(lengths, 9, seed=5, drop=drop)
    got = chunked_segment_sum_ref(terms, seg, len(lengths), keep).numpy()
    x, k = terms.numpy(), keep.numpy()
    at = 0
    for r, m in enumerate(lengths):
        acc = np.zeros(9, np.float32)
        for e in range(at, at + m):
            if k[e]:
                acc = acc + x[e]  # float32 + float32: one rounding each
        at += m
        np.testing.assert_array_equal(got[r].view(np.int32), acc.view(np.int32))


@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_long_rows_are_chunk_sums_added_in_chunk_order(drop):
    lengths = [L + 1, 2 * L, 2 * L + 1, 10 * L + 7, HUB]
    seg, terms, keep = _sorted_rows(lengths, 5, seed=6, drop=drop)
    got = chunked_segment_sum_ref(terms, seg, len(lengths), keep).numpy()
    x, k = terms.numpy(), keep.numpy()
    at = 0
    for r, m in enumerate(lengths):
        total = np.zeros(5, np.float32)
        for c in range(0, m, L):
            part = np.zeros(5, np.float32)
            for e in range(at + c, at + min(c + L, m)):
                if k[e]:
                    part = part + x[e]
            total = total + part
        at += m
        np.testing.assert_array_equal(got[r].view(np.int32), total.view(np.int32))


def test_order_model_takes_no_edges_no_rows_and_all_padding():
    assert chunked_segment_sum_ref(torch.zeros(0, 3), torch.zeros(0, dtype=torch.int32),
                                   4).abs().sum() == 0
    assert chunked_segment_sum_ref(torch.ones(5, 3), torch.zeros(5, dtype=torch.int32),
                                   0).shape == (0, 3)
    pad = torch.full((7,), -1, dtype=torch.int32)
    assert chunked_segment_sum_ref(torch.ones(7, 2), pad, 3).abs().sum() == 0


@pytest.mark.parametrize("n", [0, 1, 2, 255, 256, 65535, 65536, 150000, 2**18, 2**24,
                               2**24 + 1, 2**30, 2**31 - 1])
def test_sort_digit_widths_split_the_keys_evenly(n):
    """The sort's keys run over [0, n]: its passes of ``sort_digit_bits``
    bits hold every key, no digit is wider than 8 bits (256 counters a
    tile), and the widths differ from an even split by less than a bit."""
    passes, bits = fused_gnn.sort_passes(n), fused_gnn.sort_digit_bits(n)
    need = n.bit_length()
    assert 1 <= bits <= 8
    assert passes * bits >= need
    assert passes * bits - need < passes or need == 0
    assert passes == max(1, -(-need // 8))
