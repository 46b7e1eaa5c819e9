"""The port's Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA card: the ``cuda`` fixture skips without one
(decided at run time, so every pytest-xdist worker collects the same
tests). Run on a machine with a card with ``pytest -m gpu tests/test_torch_gpu.py``.
Imports nothing of JAX, so it runs where only PyTorch is installed.

Tolerances: float32 rtol 1e-5 / atol 1e-5 (the plain version sums with
atomics in another order). For bfloat16 the plain version runs on the
inputs upcast to float32 and its result is rounded to bfloat16, as the
kernels sum in float32 and round once: rtol 1e-2 / atol 1e-2, about one
rounding of the output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    gat_softmax_aggregate_ref,
    segment_spmm_ref,
)

pytestmark = pytest.mark.gpu

_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    rtol, atol = _TOL[dtype]
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=rtol, atol=atol
    )


def _plain(fn, *args):
    """``fn`` on the float tensors upcast to float32, rounded back to the
    messages' dtype (the last float argument)."""
    dtype = [a for a in args if torch.is_tensor(a) and a.is_floating_point()][-1].dtype
    up = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    return fn(*up).to(dtype)


def _inputs(m, n, valid, seed, row, dtype, dev, *, heads=0, shuffle=False):
    """seg sorted with a padding tail after ``valid`` edges (or shuffled),
    messages [m, row] or [m, heads, row], logits [m] or [m, heads]."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, m)).astype(np.int32)
    seg[valid:] = -1
    if shuffle:
        seg = rng.permutation(seg)
    lead = (m, heads) if heads else (m,)
    msg = rng.standard_normal(lead + (row,)).astype(np.float32)
    logits = rng.standard_normal(lead).astype(np.float32)
    return (
        torch.as_tensor(seg, device=dev),
        torch.as_tensor(msg, device=dev).to(dtype),
        torch.as_tensor(logits, device=dev),
    )


# (edges, segments, row width, valid fraction, seed): ragged edge counts,
# all-padding and zero-edge inputs, many empty segments, the path's widths
SWEEP = [
    (0, 5, 8, 1.0, 0),
    (37, 11, 1, 1.0, 1),
    (120, 40, 24, 0.7, 2),
    (128, 64, 3, 0.0, 3),
    (100, 400, 16, 1.0, 4),
    (16384, 4096, 1, 0.8, 5),
    (16384, 4096, 128, 0.9, 6),
    (65536, 4096, 256, 0.6, 7),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_segment_spmm_ragged_matches_plain(cuda, m, n, d, frac, seed, shuffle, dtype):
    seg, msg, _ = _inputs(m, n, int(m * frac), seed, d, dtype, cuda, shuffle=shuffle)
    before = fused_gnn.LAUNCHES["segment_spmm_ragged"]
    got = fused_gnn.segment_spmm_ragged(msg, seg, n)
    assert got.shape == (n, d) and got.dtype == dtype
    assert fused_gnn.LAUNCHES["segment_spmm_ragged"] == before + 1
    _close(got, _plain(segment_spmm_ref, msg, seg, n), dtype)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_segment_sum_and_count_matches_plain(cuda, m, n, d, frac, seed, shuffle):
    """Two launches of the sum kernel over one CSR index: the sum, and the
    edges per row exactly."""
    seg, msg, _ = _inputs(m, n, int(m * frac), seed, d, torch.float32, cuda, shuffle=shuffle)
    before = fused_gnn.LAUNCHES["segment_spmm_ragged"]
    agg, cnt = fused_gnn.segment_sum_and_count(msg, seg, n)
    assert fused_gnn.LAUNCHES["segment_spmm_ragged"] == before + 2
    _close(agg, segment_spmm_ref(msg, seg, n), torch.float32)
    want = torch.bincount(seg[seg >= 0].long(), minlength=n).float()[:, None]
    assert torch.equal(cnt, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("m,n,d,frac,seed", SWEEP)
def test_gat_softmax_aggregate_one_head_matches_plain(
    cuda, m, n, d, frac, seed, shuffle, dtype
):
    seg, msg, logits = _inputs(m, n, int(m * frac), seed, d, dtype, cuda, shuffle=shuffle)
    got = fused_gnn.gat_softmax_aggregate(logits, msg, seg, n)
    assert got.shape == (n, d) and got.dtype == dtype
    _close(got, _plain(gat_softmax_aggregate_ref, logits, msg, seg, n), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize(
    "m,n,heads,dh,frac", [(0, 7, 2, 8, 1.0), (300, 50, 4, 6, 0.5), (65536, 4096, 4, 64, 0.7)]
)
def test_gat_softmax_aggregate_all_heads_matches_plain(
    cuda, m, n, heads, dh, frac, shuffle, dtype
):
    seg, msg, logits = _inputs(
        m, n, int(m * frac), 9, dh, dtype, cuda, heads=heads, shuffle=shuffle
    )
    before = fused_gnn.LAUNCHES["gat_softmax_aggregate"]
    got = fused_gnn.gat_softmax_aggregate(logits, msg, seg, n)
    assert got.shape == (n, heads, dh)
    assert fused_gnn.LAUNCHES["gat_softmax_aggregate"] == before + 1
    want = torch.stack(
        [
            _plain(gat_softmax_aggregate_ref, logits[:, h], msg[:, h], seg, n)
            for h in range(heads)
        ],
        dim=1,
    )
    _close(got, want, dtype)


def test_kernels_are_deterministic_and_row_independent(cuda):
    """The same row gives the same bits whatever else is in the batch."""
    seg, msg, logits = _inputs(4096, 256, 4096, 3, 64, torch.float32, cuda)
    a = fused_gnn.segment_spmm_ragged(msg, seg, 256)
    b = fused_gnn.segment_spmm_ragged(msg, seg, 256)
    assert torch.equal(a, b)
    # the first rows alone: their edges are a prefix of the sorted batch
    cut = int((seg < 10).sum())
    head = fused_gnn.segment_spmm_ragged(msg[:cut].contiguous(), seg[:cut].contiguous(), 10)
    assert torch.equal(head, a[:10])
    g1 = fused_gnn.gat_softmax_aggregate(logits[:cut].contiguous(), msg[:cut].contiguous(),
                                         seg[:cut].contiguous(), 10)
    g2 = fused_gnn.gat_softmax_aggregate(logits, msg, seg, 256)
    assert torch.equal(g1, g2[:10])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    seg, msg, logits = _inputs(64, 8, 64, 0, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        fused_gnn.segment_spmm_ragged(msg.double(), seg, 8)
    with pytest.raises(TypeError):
        fused_gnn.segment_spmm_ragged(msg, seg.long(), 8)
    with pytest.raises(ValueError):
        fused_gnn.segment_spmm_ragged(msg.t(), seg[:16], 8)
    with pytest.raises(ValueError):
        fused_gnn.segment_spmm_ragged(msg, seg.cpu(), 8)
    with pytest.raises(ValueError):
        fused_gnn.gat_softmax_aggregate(logits[:5], msg, seg, 8)


def test_engine_and_server_launch_the_kernels(cuda, tmp_path):
    """sage launches the segment sum twice per engine batch (sum and
    count), gat the softmax aggregate once; the card's results match the
    CPU run of the same port, and served responses match solo ones."""
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph import power_law_graph
    from repro_torch.models.gnn import GNNModel

    g = power_law_graph(1500, avg_degree=8, seed=3, feat_dim=32, num_classes=4)
    system = GLISPSystem.build(g, GLISPConfig(num_parts=2, fanouts=(6, 4)))
    for kind, name, per_batch in (
        ("sage", "segment_spmm_ragged", 2),
        ("gat", "gat_softmax_aggregate", 1),
    ):
        results = {}
        for dev in ("cpu", "cuda"):
            model = GNNModel(kind, 32, hidden=32, num_layers=2, device=dev)
            fns = [model.embed_layer_fn(k) for k in range(2)]
            fused_gnn.reset_launches()
            res = system.infer_layerwise(
                fns, str(tmp_path / f"{kind}_{dev}"), out_dims=[32, 32],
                batch_size=512, device=dev,
            )
            launches = fused_gnn.LAUNCHES[name]
            if dev == "cuda":
                assert launches == per_batch * res.device_batches() > 0
            else:
                assert launches == 0
            results[dev] = res.final_store.read_rows(np.arange(g.num_vertices))
        np.testing.assert_allclose(results["cuda"], results["cpu"], rtol=1e-4, atol=1e-5)
        reqs = [np.arange(i, i + 5) * 7 for i in range(6)]
        solo = system.server(max_batch_delay_ms=0.0, deadline_ms=None)
        want = [solo.call(v).embeddings for v in reqs]
        batched = system.server(max_batch_delay_ms=0.0, deadline_ms=None)
        rids = [batched.submit(v) for v in reqs]
        batched.drain()
        for rid, w in zip(rids, want):
            np.testing.assert_allclose(batched.response(rid).embeddings, w, rtol=1e-5, atol=1e-6)
