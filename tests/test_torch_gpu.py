"""The port's Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA card: the ``cuda`` fixture skips without one
(decided at run time, so every pytest-xdist worker collects the same
tests). Run on a machine with a card with ``pytest -m gpu tests/test_torch_gpu.py``.
Imports nothing of JAX, so it runs where only PyTorch is installed.

Tolerances: float32 rtol 1e-5 / atol 1e-5 (the plain version sums with
atomics in another order). For bfloat16 the plain version runs on the
inputs upcast to float32 and its result is rounded to bfloat16, as the
kernels sum in float32 and round once: rtol 1e-2 / atol 1e-2, about one
rounding of the output. The GAT backward's logit gradient: float32 rtol
1e-4 / atol 1e-5 (a difference of two dot products, each summed in
another order). Training runs and served responses are compared bit for
bit. The LM kernels' tolerances are stated beside their tests below.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    SUM_CHUNK,
    chunked_segment_sum_ref,
    gat_softmax_aggregate_backward_ref,
    gat_softmax_aggregate_ref,
    gather_spmm_ragged_backward_ref,
    gather_spmm_ref,
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
        got.detach().float().cpu().numpy(), want.detach().float().cpu().numpy(),
        rtol=rtol, atol=atol,
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


# (edges, rows of feats, segments, width, valid fraction, seed), up to the
# training path's widths
GATHER_SWEEP = [
    (0, 4, 5, 8, 1.0, 0),
    (37, 9, 11, 3, 1.0, 1),
    (128, 20, 64, 6, 0.0, 2),
    (300, 50, 400, 16, 1.0, 3),
    (16384, 5000, 4096, 128, 0.9, 4),
    (65536, 20000, 4096, 256, 0.8, 5),
]


def _gather_inputs(m, f, n, d, frac, seed, dtype, dev, shuffle):
    rng = np.random.default_rng(seed)
    valid = int(m * frac)
    seg = np.sort(rng.integers(0, n, m)).astype(np.int32)
    idx = rng.integers(0, f, m).astype(np.int32)
    seg[valid:] = -1
    idx[valid:] = -1
    if shuffle:
        p = rng.permutation(m)
        seg, idx = seg[p], idx[p]
    feats = rng.standard_normal((f, d)).astype(np.float32)
    grad = rng.standard_normal((n, d)).astype(np.float32)
    return (
        torch.as_tensor(feats, device=dev).to(dtype),
        torch.as_tensor(idx, device=dev),
        torch.as_tensor(seg, device=dev),
        torch.as_tensor(grad, device=dev).to(dtype),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("m,f,n,d,frac,seed", GATHER_SWEEP)
def test_gather_spmm_ragged_and_backward_match_plain(cuda, m, f, n, d, frac, seed, shuffle, dtype):
    feats, idx, seg, grad = _gather_inputs(m, f, n, d, frac, seed, dtype, cuda, shuffle)
    x = feats.clone().requires_grad_(True)
    before = dict(fused_gnn.LAUNCHES)
    out = fused_gnn.gather_spmm_ragged(x, idx, seg, n)
    assert out.shape == (n, d) and out.dtype == dtype
    _close(out, _plain(gather_spmm_ref, feats, idx, seg, n), dtype)
    out.backward(grad)
    _close(x.grad, _plain(gather_spmm_ragged_backward_ref, grad, idx, seg, f), dtype)
    assert fused_gnn.LAUNCHES["gather_spmm_ragged"] == before["gather_spmm_ragged"] + 1
    assert (fused_gnn.LAUNCHES["gather_spmm_ragged_backward"]
            == before["gather_spmm_ragged_backward"] + (1 if f else 0))


@pytest.mark.parametrize("m,f,n,d,frac,seed", GATHER_SWEEP)
def test_gather_rows_backward_matches_plain(cuda, m, f, n, d, frac, seed):
    feats, idx, _, _ = _gather_inputs(m, f, n, d, frac, seed, torch.float32, cuda, True)
    x = feats.clone().requires_grad_(True)
    rows = fused_gnn.gather_rows(x, idx)
    want = torch.where((idx >= 0)[:, None], feats[idx.clamp_min(0).long()], 0.0)
    assert torch.equal(rows, want)
    g = torch.randn(m, d, device=cuda, generator=torch.Generator(cuda).manual_seed(seed))
    before = fused_gnn.LAUNCHES["gather_spmm_ragged_backward"]
    rows.backward(g)
    assert fused_gnn.LAUNCHES["gather_spmm_ragged_backward"] == before + 1
    each = torch.arange(m, dtype=torch.int32, device=cuda)  # edge e gathers gradient row e
    _close(x.grad, gather_spmm_ragged_backward_ref(g, idx, each, f), torch.float32)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize(
    "m,n,heads,dh,frac", [(0, 7, 2, 8, 1.0), (300, 50, 4, 6, 0.5), (65536, 4096, 4, 64, 0.7)]
)
def test_gat_softmax_aggregate_backward_matches_plain(cuda, m, n, heads, dh, frac, shuffle):
    """float32, the training path's dtype."""
    dtype = torch.float32
    seg, msg, logits = _inputs(m, n, int(m * frac), 13, dh, dtype, cuda, heads=heads,
                               shuffle=shuffle)
    lg = logits.clone().requires_grad_(True)
    mg = msg.clone().requires_grad_(True)
    grad = torch.randn(n, heads, dh, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = fused_gnn.LAUNCHES["gat_softmax_aggregate_backward"]
    fused_gnn.gat_softmax_aggregate(lg, mg, seg, n).backward(grad)
    assert fused_gnn.LAUNCHES["gat_softmax_aggregate_backward"] == before + 1
    for h in range(heads):
        dl, dm = gat_softmax_aggregate_backward_ref(grad[:, h], logits[:, h], msg[:, h], seg, n)
        _close(mg.grad[:, h], dm, dtype)
        torch.cuda.synchronize()
        np.testing.assert_allclose(lg.grad[:, h].cpu().numpy(), dl.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
    pad = seg < 0
    assert torch.all(lg.grad[pad] == 0) and torch.all(mg.grad[pad] == 0)


def test_gat_one_head_backward_and_determinism(cuda):
    seg, msg, logits = _inputs(20000, 3000, 18000, 7, 64, torch.float32, cuda)
    grads = []
    for _ in range(2):
        lg = logits.clone().requires_grad_(True)
        mg = msg.clone().requires_grad_(True)
        fused_gnn.gat_softmax_aggregate(lg, mg, seg, 3000).sum().backward()
        grads.append((lg.grad, mg.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    dl, dm = gat_softmax_aggregate_backward_ref(torch.ones(3000, 64, device=cuda), logits, msg,
                                                seg, 3000)
    _close(grads[0][1], dm, torch.float32)


def _small_system():
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph import power_law_graph

    g = power_law_graph(1500, avg_degree=8, seed=3, feat_dim=32, num_classes=4)
    return GLISPSystem.build(g, GLISPConfig(num_parts=2, fanouts=(6, 4)))


def _trained(system, kind, steps, *, path=None, save_at=None, resume=None):
    from repro_torch.models.gnn import GNNModel, load_jax_params

    model = GNNModel(kind, 32, hidden=32, num_layers=2, num_classes=4, device="cuda")
    load_jax_params(model, model.init_numpy(0))
    tr = system.trainer(model, np.arange(0, 1500, 2), batch_size=64, prefetch=0)
    if resume is not None:
        tr.resume(resume)
    tr.train(max_steps=save_at or steps, log_every=1)
    if save_at is not None:
        return tr.save(path, step=save_at)
    return [p.detach().clone() for p in tr.model.parameters()], tr.log.losses


def test_training_is_deterministic_and_resumes_bitwise(cuda, tmp_path):
    """Two runs from the same start, and a run checkpointed and resumed,
    end with the same bits; the kernels launch as the path implies
    (2 layers: sage 2 gathers + 1 backward per step; gat 2 softmax
    aggregates, 2 backwards and 4 row-gather backwards per step)."""
    system = _small_system()
    per_step = {
        "sage": {"gather_spmm_ragged": 2, "gather_spmm_ragged_backward": 1},
        "gat": {"gat_softmax_aggregate": 2, "gat_softmax_aggregate_backward": 2,
                "gather_spmm_ragged_backward": 4},
    }
    for kind, want in per_step.items():
        fused_gnn.reset_launches()
        a, la = _trained(system, kind, 4)
        launches = {k: v for k, v in fused_gnn.LAUNCHES.items() if v}
        assert launches == {k: 4 * v for k, v in want.items()}
        b, lb = _trained(system, kind, 4)
        assert la == lb and all(torch.equal(x, y) for x, y in zip(a, b))
        path = _trained(system, kind, 4, path=str(tmp_path / f"{kind}.npz"), save_at=2)
        c, _ = _trained(system, kind, 4, resume=path)
        assert all(torch.equal(x, y) for x, y in zip(a, c))
        assert np.all(np.isfinite(la))


def test_served_batched_equals_solo_bitwise_on_card(cuda, tmp_path):
    """Every served batch runs at one fixed shape, so a request's rows have
    the same bits alone and in any batch."""
    from repro_torch.models.gnn import GNNModel

    system = _small_system()
    rng = np.random.default_rng(4)
    reqs = [rng.choice(1500, size=int(rng.integers(1, 12)), replace=False) for _ in range(16)]
    for kind in ("sage", "gat"):
        model = GNNModel(kind, 32, hidden=32, num_layers=2, device="cuda")
        system.infer_layerwise([model.embed_layer_fn(k) for k in range(2)],
                               str(tmp_path / kind), out_dims=[32, 32], batch_size=256)
        solo = system.server(max_batch_delay_ms=0.0, deadline_ms=None)
        want = [solo.call(v).embeddings for v in reqs]
        batched = system.server(max_batch_delay_ms=1e6, deadline_ms=None)
        rids = [batched.submit(v) for v in reqs]
        batched.drain()
        assert batched.stats.mean_batch_requests() > 1.0
        for rid, w in zip(rids, want):
            assert np.array_equal(batched.response(rid).embeddings, w)


# ---------------------------------------------------------------------------
# LM kernels: flash attention and the SSD scan
# ---------------------------------------------------------------------------

# Flash attention: float32 rtol 1e-4 / atol 1e-5 (dot products of D terms
# and the softmax sums taken in another order); bfloat16 rtol 1e-2 / atol
# 1e-2 against the plain version on the bf16 inputs (it computes in
# float32 and rounds once; the kernel also rounds P to bf16 for P.V).
_ATTN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# SSD: float32 rtol 1e-4 / atol 1e-4 (the kernel runs the recurrence step
# by step, the plain version in chunks); bfloat16 as above (both compute in
# float32 and round y once).
_SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _allclose(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(), rtol=tol[0], atol=tol[1])


def _attn_inputs(b, sq, skv, h, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32),  # noqa: E731
                                   device="cuda").to(dtype)
    return t(b, sq, h, d), t(b, skv, hkv, d), t(b, skv, hkv, d)


# (B, Sq, Skv, H, Hkv, D, causal, window, kv_offset): ragged lengths, GQA
# and MQA, a window, queries after a cache (kv_offset > 0, Sq < Skv)
ATTN_SWEEP = [
    (2, 100, 100, 4, 1, 64, True, 0, 0),
    (1, 130, 130, 8, 2, 128, True, 37, 0),
    (2, 64, 64, 2, 2, 256, False, 0, 0),
    (1, 33, 200, 4, 4, 64, True, 0, 167),
    (1, 1, 77, 4, 2, 128, True, 16, 76),
    (2, 257, 257, 8, 1, 256, True, 100, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window,off", ATTN_SWEEP)
def test_flash_attention_matches_plain(cuda, b, sq, skv, h, hkv, d, causal, window, off, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    q, k, v = _attn_inputs(b, sq, skv, h, hkv, d, dtype, sq + d)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window, kv_offset=off)
    want = attention_ref(q, k, v, causal=causal, window=window, kv_offset=off)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _allclose(got, want, _ATTN_TOL[dtype])
    again = fa.flash_attention(q, k, v, causal=causal, window=window, kv_offset=off)
    assert torch.equal(got, again)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _attn_inputs(1, 16, 16, 4, 2, 64, torch.float32, 0)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)


def _ssd_inputs(b, s, h, p, g, n, dtype, seed, init):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")  # noqa: E731
    x = f(rng.standard_normal((b, s, h, p))).to(dtype)
    dt = f(rng.random((b, s, h)) * 0.5 + 0.01)
    A = f(-rng.random(h) - 0.1)
    B = f(rng.standard_normal((b, s, g, n))).to(dtype)
    C = f(rng.standard_normal((b, s, g, n))).to(dtype)
    st = f(rng.standard_normal((b, h, p, n))) if init else None
    return x, dt, A, B, C, st


# (B, S, H, P, G, N, chunk, init): ragged S, G > 1, a nonzero initial state
SSD_SWEEP = [
    (2, 128, 4, 64, 1, 128, 128, False),
    (1, 200, 6, 32, 2, 64, 64, True),
    (2, 33, 4, 16, 4, 32, 16, False),
    (1, 300, 24, 64, 1, 128, 128, True),
    (3, 1, 2, 32, 1, 32, 32, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", SSD_SWEEP)
def test_ssd_scan_matches_plain(cuda, b, s, h, p, g, n, chunk, init, dtype):
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.kernels.ref import ssd_chunked_ref

    x, dt, A, B, C, st = _ssd_inputs(b, s, h, p, g, n, dtype, s + p, init)
    before = ssd_scan.LAUNCHES["ssd_scan"]
    y, final = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=st)
    assert ssd_scan.LAUNCHES["ssd_scan"] == before + 1
    want_y, want_state = ssd_chunked_ref(x, dt * A, dt, B, C, chunk=chunk, init_state=st)
    assert y.dtype == dtype and final.dtype == torch.float32
    _allclose(y, want_y, _SSD_TOL[dtype])
    _allclose(final, want_state, _SSD_TOL[torch.float32])
    y2, final2 = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=st)
    assert torch.equal(y, y2) and torch.equal(final, final2)


def test_ssd_scan_takes_strided_slices(cuda):
    """x, B and C as slices of one wider projection, as Mamba-2 passes them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_chunked_ref

    b, s, h, p, g, n = 2, 70, 4, 32, 1, 64
    x, dt, A, B, C, _ = _ssd_inputs(b, s, h, p, g, n, torch.float32, 5, False)
    wide = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1), C.reshape(b, s, -1)], -1)
    xs = wide[..., : h * p].reshape(b, s, h, p)
    bs = wide[..., h * p: h * p + g * n].reshape(b, s, g, n)
    cs = wide[..., h * p + g * n:].reshape(b, s, g, n)
    assert not xs.is_contiguous()
    y, st = ops.ssd_scan(xs, dt, A, bs, cs, chunk=32)
    want_y, want_st = ssd_chunked_ref(x, dt * A, dt, B, C, chunk=32)
    _allclose(y, want_y, _SSD_TOL[torch.float32])
    _allclose(st, want_st, _SSD_TOL[torch.float32])


def _ssd_check(x, dt, A, B, C, st, tol=None):
    """One kernel launch per call, y and the final state against the plain
    version, finite, and a second call bitwise equal. ``tol``: the float32
    tolerance where the default's does not hold (fast decays)."""
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.kernels.ref import ssd_chunked_ref

    before = ssd_scan.LAUNCHES["ssd_scan"]
    y, final = ops.ssd_scan(x, dt, A, B, C, chunk=128, init_state=st)
    assert ssd_scan.LAUNCHES["ssd_scan"] == before + 1
    want_y, want_state = ssd_chunked_ref(x, dt * A, dt, B, C, chunk=128, init_state=st)
    assert torch.isfinite(y.float()).all() and torch.isfinite(final).all()
    f32 = tol or _SSD_TOL[torch.float32]
    _allclose(y, want_y, f32 if x.dtype == torch.float32 else _SSD_TOL[x.dtype])
    _allclose(final, want_state, f32)
    y2, final2 = ops.ssd_scan(x, dt, A, B, C, chunk=128, init_state=st)
    assert ssd_scan.LAUNCHES["ssd_scan"] == before + 2
    assert torch.equal(y, y2) and torch.equal(final, final2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", ["0", "L-1", "L", "L+1", "2L+1"])
def test_ssd_scan_at_the_kernel_chunk_edges(cuda, offset, dtype):
    """S around the kernels' own chunk length L: no step (the final state is
    the initial one), a partial chunk, exactly one, one step into a second,
    and a third chunk of one step."""
    from repro_torch.kernels.ssd_scan import kernel_chunk

    L = kernel_chunk(dtype)
    s = {"0": 0, "L-1": L - 1, "L": L, "L+1": L + 1, "2L+1": 2 * L + 1}[offset]
    _ssd_check(*_ssd_inputs(2, s, 4, 64, 1, 128, dtype, s, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_fast_decay_underflows_without_nan(cuda, dtype):
    """a down to -30 a step: decays underflow to 0 within a chunk. The
    exponents are differences of float32 running sums of up to 30 L, added
    in another order than the plain version's, each off by up to
    |csum| 2^-24: the float32 tolerance is twice that, relative (1e-4
    where that is larger)."""
    from repro_torch.kernels.ssd_scan import kernel_chunk

    L = kernel_chunk(dtype)
    x, dt, A, B, C, st = _ssd_inputs(2, L + 9, 4, 64, 1, 128, dtype, 17, True)
    A = torch.full_like(A, -60.0)  # a = dt A from -0.6 to -30.6
    assert float((dt * A).min()) < -25
    csum = float(-(dt * A)[:, :L].sum(dim=1).min())
    tol = max(1e-4, 2 * csum * 2.0**-24)
    _ssd_check(x, dt, A, B, C, st, tol=(tol, tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_tiny_dt(cuda, dtype):
    """dt near 0 (1e-6 to 1e-4): almost no input and almost no decay."""
    from repro_torch.kernels.ssd_scan import kernel_chunk

    L = kernel_chunk(dtype)
    x, dt, A, B, C, st = _ssd_inputs(2, 2 * L + 5, 4, 64, 1, 128, dtype, 23, True)
    dt = 1e-6 + dt * 2e-4
    _ssd_check(x, dt, A, B, C, st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,h", [(2, 8), (4, 16)])
def test_ssd_scan_groups_of_several_heads(cuda, g, h, dtype):
    """G = 2 and 4 with four heads a group, from an initial state."""
    from repro_torch.kernels.ssd_scan import kernel_chunk

    L = kernel_chunk(dtype)
    _ssd_check(*_ssd_inputs(2, L + 33, h, 32, g, 64, dtype, g + h, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [0, 8])
def test_ssd_scan_takes_strided_slices_with_an_initial_state(cuda, lead, dtype):
    """x, B and C as slices of one wider projection, with an initial state;
    ``lead`` bytes before them in each row (8: not 16-byte aligned, so the
    kernels stage by element loads)."""
    from repro_torch.kernels.ssd_scan import kernel_chunk

    b, s, h, p, g, n = 2, kernel_chunk(dtype) + 7, 4, 32, 1, 64
    x, dt, A, B, C, st = _ssd_inputs(b, s, h, p, g, n, dtype, 29, True)
    pad = x.new_zeros((b, s, lead // x.element_size()))
    wide = torch.cat([pad, x.reshape(b, s, -1), B.reshape(b, s, -1), C.reshape(b, s, -1)], -1)
    wide = wide[..., pad.shape[-1]:]
    xs = wide[..., : h * p].reshape(b, s, h, p)
    bs = wide[..., h * p: h * p + g * n].reshape(b, s, g, n)
    cs = wide[..., h * p + g * n:].reshape(b, s, g, n)
    assert not xs.is_contiguous() and not bs.is_contiguous()
    assert (xs.data_ptr() % 16 == 0) == (lead == 0)
    _ssd_check(xs, dt, A, bs, cs, st)


@pytest.mark.parametrize("arch,kernel", [("gemma-2b", "flash_attention"),
                                         ("mamba2-130m", "ssd_scan"),
                                         ("deepseek-v2-lite-16b", "flash_attention"),
                                         ("mixtral-8x7b", "flash_attention")])
def test_lm_serving_on_card_matches_cpu_and_repeats_bitwise(cuda, arch, kernel):
    """The reduced configs (float32) served on the card go through one
    kernel launch per layer's prefill, give the same bits twice, and agree
    with the same weights served on the CPU through the plain versions
    (rtol 1e-4 / atol 1e-4: logits through two layers)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer.model import init_params

    counts = {"flash_attention": flash_attention.LAUNCHES, "ssd_scan": ssd_scan.LAUNCHES}[kernel]
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(1), device="cuda")
    before = counts[kernel]
    kw = dict(batch=3, prompt_len=70, gen=5, seed=2)
    out = serve(cfg, device="cuda", params=params, **kw)
    assert counts[kernel] == before + cfg.num_layers
    again = serve(cfg, device="cuda", params=params, **kw)
    assert np.array_equal(out["tokens"], again["tokens"])
    assert torch.equal(out["logits"], again["logits"])
    cpu = serve(cfg, device="cpu", params=_to_cpu(params), **kw)
    np.testing.assert_allclose(out["logits"].cpu().numpy(), cpu["logits"].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert np.array_equal(out["tokens"], cpu["tokens"])


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# segment max: bit for bit (a max has no rounding; the plain version and the
# kernel share one total order: NaN above +inf, -0.0 below +0.0)
# ---------------------------------------------------------------------------


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _max_inputs(m, n, pad, over, seed, dtype, special):
    """x [m] and seg [m] int32 in no order, a ``pad`` share of -1 and an
    ``over`` share of ids >= n; ``special`` salts x with NaN, +-inf, -0.0
    and +0.0, and gives some segments only zeros of either sign."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, max(n, 1), m).astype(np.int32)
    pick = rng.random(m)
    seg[pick < pad] = -1
    high = (pick >= pad) & (pick < pad + over)
    seg[high] = n + rng.integers(0, 3, int(high.sum()))
    x = rng.standard_normal(m).astype(np.float32)
    if special and m:
        vals = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
        salt = rng.random(m) < 0.05
        x[salt] = rng.choice(vals, int(salt.sum()))
        zeros = np.isin(seg, np.arange(0, n, 7))  # every 7th segment: zeros only
        x[zeros] = np.where(rng.random(int(zeros.sum())) < 0.7, -0.0, 0.0)
    return torch.as_tensor(x, device="cuda").to(dtype), torch.as_tensor(seg, device="cuda")


# (edges, segments, padding share, ids >= n share, seed)
MAX_SWEEP = [
    (0, 5, 0.0, 0.0, 0),  # zero edges
    (1, 1, 0.0, 0.0, 1),
    (1000, 37, 0.1, 0.05, 2),
    (5000, 20000, 0.1, 0.0, 3),  # mostly empty segments
    (100000, 4096, 0.1, 0.02, 4),
    (64, 8, 1.0, 0.0, 5),  # all padding
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("m,n,pad,over,seed", MAX_SWEEP)
def test_segment_max_is_bitwise_its_plain_version(cuda, m, n, pad, over, seed, special, dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_max_ref

    x, seg = _max_inputs(m, n, pad, over, seed, dtype, special)
    before = fused_gnn.LAUNCHES["segment_max"]
    got = ops.gnn_segment_max(x, seg, n)
    assert fused_gnn.LAUNCHES["segment_max"] == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(segment_max_ref(x, seg, n)))
    assert torch.equal(_bits(got).cpu(), _bits(segment_max_ref(x.cpu(), seg.cpu(), n)))
    assert torch.equal(_bits(ops.gnn_segment_max(x, seg, n)), _bits(got))


def test_segment_max_rejects_what_the_kernel_does_not_take(cuda):
    x, seg = _max_inputs(64, 8, 0.0, 0.0, 0, torch.float32, False)
    with pytest.raises(TypeError):
        fused_gnn.segment_max(x.double(), seg, 8)
    with pytest.raises(TypeError):
        fused_gnn.segment_max(x, seg.long(), 8)
    with pytest.raises(ValueError):
        fused_gnn.segment_max(x[:, None], seg, 8)
    with pytest.raises(TypeError):
        fused_gnn.segment_max(x, seg[:10], 8)
    with pytest.raises(ValueError):
        fused_gnn.segment_max(x, seg.cpu(), 8)


# The scatter kernel folds equal ids in a thread and a warp and sends no
# key that its block's shared-memory cache shows would not raise the
# segment's key; these cases aim at that: one segment holding every edge,
# hot rows whose values rise or fall along the edges (the cache never or
# always holds a key as large), hot rows of special values, inputs off the
# 16-byte alignment of the vector loads, and E = 0.


def _max_check(x, seg, n):
    from repro_torch.kernels.ref import segment_max_ref

    got = fused_gnn.segment_max(x, seg, n)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (n,)
    assert torch.equal(_bits(got), _bits(segment_max_ref(x, seg, n)))
    assert torch.equal(_bits(got).cpu(), _bits(segment_max_ref(x.cpu(), seg.cpu(), n)))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,at", [(200_003, 1, 0), (200_000, 4096, 4095), (33, 7, 3)])
def test_segment_max_one_segment_holds_every_edge(cuda, m, n, at, dtype):
    rng = np.random.default_rng(m + n)
    x = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device="cuda").to(dtype)
    seg = torch.full((m,), at, dtype=torch.int32, device="cuda")
    got = _max_check(x, seg, n)
    assert float(got[at]) == float(x.float().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_segment_max_hot_row_values_in_order(cuda, order, shuffle, dtype):
    """A hot row of 60,000 edges among 40,000 others over 1,000 rows, its
    values strictly rising (every read finds a smaller key) or falling
    along the edges; the ids in place or the whole edge list shuffled."""
    rng = np.random.default_rng(7)
    hot, m_hot, m_rest, n = 17, 60_000, 40_000, 1000
    seg = np.concatenate([np.full(m_hot, hot), rng.integers(0, n, m_rest)]).astype(np.int32)
    vals = np.linspace(-50.0, 50.0, m_hot, dtype=np.float32)  # distinct in bf16 too, in part
    x = np.concatenate([vals if order == "ascending" else vals[::-1],
                        rng.standard_normal(m_rest).astype(np.float32)])
    if shuffle:
        perm = rng.permutation(seg.shape[0])
        seg, x = seg[perm], x[perm]
    got = _max_check(torch.as_tensor(x, device="cuda").to(dtype),
                     torch.as_tensor(seg, device="cuda"), n)
    assert float(got[hot]) == 50.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values,want", [
    ((-0.0, 0.0), "+0"),
    ((-0.0,), "-0"),
    ((-0.0, 0.0, -np.inf), "+0"),
    ((np.inf, -np.inf, 0.0, -0.0), "zero"),
    ((np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0), "zero"),
    ((-np.nan, -np.inf), "zero"),
    ((-np.inf,), "zero"),
])
def test_segment_max_hot_row_of_special_values(cuda, values, want, dtype):
    """A hot row of 50,000 edges drawn from ``values`` (NaN, +-inf, signed
    zeros) beside random rows: +inf and NaN (above +inf in the kernel's
    order) give 0.0, and so does -inf alone; -0.0 lies below +0.0."""
    rng = np.random.default_rng(len(values))
    hot, m_hot, m_rest, n = 5, 50_000, 20_000, 300
    rest = rng.integers(0, n - 1, m_rest)
    rest[rest >= hot] += 1  # the hot row holds only the special values
    seg = np.concatenate([np.full(m_hot, hot), rest]).astype(np.int32)
    x = np.concatenate([rng.choice(np.array(values, np.float32), m_hot),
                        rng.standard_normal(m_rest).astype(np.float32)])
    perm = rng.permutation(seg.shape[0])
    got = _max_check(torch.as_tensor(x[perm], device="cuda").to(dtype),
                     torch.as_tensor(seg[perm], device="cuda"), n)
    v = got[hot : hot + 1].float()
    assert float(v) == 0.0
    if want != "zero":
        assert bool(torch.signbit(v)) == (want == "-0")


def test_segment_max_repeats_bit_for_bit_whatever_its_scratch_holds(cuda):
    """Ten calls on power-law ids (hub rows of thousands of edges) give one
    result, and so does the launch on a scratch full of stale keys."""
    rng = np.random.default_rng(11)
    n, m = 20_000, 400_000
    seg = np.minimum(rng.zipf(1.3, m) - 1, n + 5).astype(np.int32)  # some ids >= n
    seg[rng.random(m) < 0.1] = -1
    x = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device="cuda")
    seg = torch.as_tensor(rng.permutation(seg), device="cuda")
    first = _max_check(x, seg, n)
    for _ in range(9):
        assert torch.equal(_bits(fused_gnn.segment_max(x, seg, n)), _bits(first))
    keys = fused_gnn.segment_max_keys(n, "cuda").fill_(-1)  # above every key
    out = torch.empty_like(first)
    fused_gnn.launch_segment_max(x, seg, keys, out)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(first))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_segment_max_off_the_vector_alignment(cuda, offset, dtype):
    """x and seg starting 1-3 elements into their storage (the scalar
    loads), with E not a multiple of 4."""
    x, seg = _max_inputs(10_007 + offset, 300, 0.1, 0.02, offset, dtype, True)
    _max_check(x[offset:], seg[offset:], 300)
    _max_check(x[offset:], seg[:-offset].contiguous(), 300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_max_no_edges_one_segment(cuda, dtype):
    x = torch.zeros(0, dtype=dtype, device="cuda")
    seg = torch.zeros(0, dtype=torch.int32, device="cuda")
    got = _max_check(x, seg, 1)
    assert got.shape == (1,) and float(got[0]) == 0.0 and not bool(torch.signbit(got[0]))


# (B, Sq, Skv, H, D, Dv, window, kv_offset): MLA's widths (192 over 128) and
# the reduced deepseek config's (96 over 64), ragged, windowed, after a cache
MLA_ATTN_SWEEP = [
    (2, 300, 300, 16, 192, 128, 0, 0),
    (1, 130, 130, 4, 192, 128, 37, 0),
    (1, 33, 200, 4, 192, 128, 0, 167),
    (2, 100, 100, 4, 96, 64, 0, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,d,dv,window,off", MLA_ATTN_SWEEP)
def test_flash_attention_with_a_narrower_v_matches_plain(cuda, b, sq, skv, h, d, dv, window,
                                                         off, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    q, k, _ = _attn_inputs(b, sq, skv, h, h, d, dtype, sq + d)
    v = _attn_inputs(b, sq, skv, h, h, dv, dtype, sq + dv)[2]
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True, window=window, kv_offset=off)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, h, dv)
    _allclose(got, attention_ref(q, k, v, causal=True, window=window, kv_offset=off),
              _ATTN_TOL[dtype])
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=True, window=window,
                                               kv_offset=off))
    with pytest.raises(ValueError):  # widths the kernel is not built for
        fa.flash_attention(q, k, v[..., : dv // 2].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_layer_on_card_repeats_bitwise_and_matches_cpu(cuda, arch, dtype):
    """An MoE layer (reduced config, capacity lowered so slots drop) gives
    the same bits twice on the card: dispatch is a plain scatter and the
    combine sums in slot order, no float atomics. In float32 it agrees with
    the CPU (rtol 1e-5, atol 1e-5 times the output's largest magnitude,
    which reaches a few hundred: the experts' weights are drawn with scale
    1/sqrt(E), as the reference draws them) and picks the same experts,
    ties included (router columns repeated)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import moe

    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    p = moe.init_moe(torch.Generator("cuda").manual_seed(3), cfg, "cuda")
    p["router"][:, 1] = p["router"][:, 0]  # ties between experts 0 and 1
    p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dtype))
         for k, v in p.items()}
    x = torch.randn(3, 40, cfg.d_model, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4)).to(dtype)
    y, aux = moe.moe_forward(p, cfg, x)
    y2, aux2 = moe.moe_forward(p, cfg, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    r = moe.route(p, cfg, x.reshape(1, -1, cfg.d_model))
    assert not bool(r.keep.all())  # the lowered capacity drops slots
    if dtype == torch.float32:
        cpu = _to_cpu(p)
        y_cpu, aux_cpu = moe.moe_forward(cpu, cfg, x.cpu())
        r_cpu = moe.route(cpu, cfg, x.cpu().reshape(1, -1, cfg.d_model))
        assert torch.equal(r.gate_idx.cpu(), r_cpu.gate_idx)
        _allclose(y, y_cpu, (1e-5, 1e-5 * max(1.0, float(y_cpu.abs().max()))))
        _allclose(aux, aux_cpu, (1e-5, 1e-5))


# The bf16 route of the flash kernel (TMA + wgmma; 128 queries a block, KV
# tiles of 64 keys): every width it is built for, at lengths around those
# tile edges, against the plain version at _ATTN_TOL and bitwise run to run.
FLASH_EDGES = (1, 63, 64, 65, 127, 128, 129, 300)


def _flash_bf16(q, k, v, **kw):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape[:3] + (v.shape[3],)
    _allclose(got, attention_ref(q, k, v, **kw), _ATTN_TOL[torch.bfloat16])
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))
    return got


@pytest.mark.parametrize("sq", FLASH_EDGES)
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_flash_attention_bf16_every_width_at_tile_edges(cuda, d, dv, sq):
    q, k, _ = _attn_inputs(2, sq, sq, 4, 2, d, torch.bfloat16, sq + d)
    v = _attn_inputs(2, sq, sq, 4, 2, dv, torch.bfloat16, sq + dv + 1)[2]
    _flash_bf16(q, k, v, causal=True, window=0, kv_offset=0)
    _flash_bf16(q, k, v, causal=False, window=0, kv_offset=0)


# (Sq, Skv, kv_offset, window, causal): queries after a cache, a window
# that cuts tiles, no mask at all
FLASH_CACHED = [
    (65, 300, 235, 0, True),
    (129, 200, 71, 50, True),
    (1, 129, 128, 0, True),
    (100, 257, 0, 0, False),
]


@pytest.mark.parametrize("sq,skv,off,window,causal", FLASH_CACHED)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_flash_attention_bf16_after_a_cache_with_gqa(cuda, d, dv, group, sq, skv, off, window,
                                                     causal):
    hkv = 2
    q = _attn_inputs(1, sq, skv, hkv * group, hkv, d, torch.bfloat16, sq + skv)[0]
    k = _attn_inputs(1, sq, skv, hkv * group, hkv, d, torch.bfloat16, d + 7)[1]
    v = _attn_inputs(1, sq, skv, hkv * group, hkv, dv, torch.bfloat16, dv + 11)[2]
    _flash_bf16(q, k, v, causal=causal, window=window, kv_offset=off)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_flash_attention_bf16_reads_no_row_of_the_next_batch(cuda, d, dv, causal):
    """Skv 100 is not a multiple of the 64-key tile: the last tile's box
    runs past batch 0's keys. Batch 1's v is +inf, so a box that read its
    rows would turn batch 0's output into NaN."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    q, k, _ = _attn_inputs(2, 100, 100, 4, 4, d, torch.bfloat16, d)
    v = _attn_inputs(2, 100, 100, 4, 4, dv, torch.bfloat16, dv + 1)[2]
    v[1] = float("inf")
    got = fa.flash_attention(q, k, v, causal=causal)
    assert bool(torch.isfinite(got[0]).all())
    _allclose(got[:1], attention_ref(q[:1], k[:1], v[:1], causal=causal),
              _ATTN_TOL[torch.bfloat16])


# The dense call forms (ids in any order) through the stable radix sort of
# csrc/segment_sort.cu and the CSR gather kernel. The sort's permutation is
# unique, so it must equal torch.sort(stable=True)'s bit for bit; the sums
# must have the bits of the sorted-input kernels over host-sorted edges.
SORT_SEGMENTS = (1, 255, 256, 65535, 65536, 150000, 2**24 + 1)  # 1, 1, 2, 2, 3, 3, 4 passes
SORT_CASES = [(0, "uniform"), (1, "uniform"), (4095, "uniform"), (4096, "uniform"),
              (4097, "uniform"), (50000, "all padding"), (50000, "one hot key"),
              (50000, "power law")]


def _sort_ids(e, n, kind, seed):
    """int32 ids on the card: uniform over [-1, n + 2) (padding and ids >= n
    included), all -1, one id on 90% of the edges (hot in every tile), or
    power-law (Zipf) ids."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        ids = rng.integers(-1, n + 2, e)
    elif kind == "all padding":
        ids = np.full(e, -1)
    elif kind == "one hot key":
        ids = np.where(rng.random(e) < 0.9, n // 2, rng.integers(-1, n + 2, e))
    else:
        ids = np.minimum(rng.zipf(1.3, e) - 1, n + 1)
    return torch.as_tensor(ids.astype(np.int32), device="cuda")


def _sort_key(seg, n):
    return seg.long().masked_fill((seg < 0) | (seg >= n), n)


@pytest.mark.parametrize("e,kind", SORT_CASES)
@pytest.mark.parametrize("n", SORT_SEGMENTS)
def test_segment_sort_is_torch_sorts_permutation_bitwise(cuda, n, e, kind):
    seg = _sort_ids(e, n, kind, n + e)
    before = fused_gnn.LAUNCHES["segment_sort"]
    got = fused_gnn.segment_sort(seg, n)
    # three kernels a pass: count, scan, scatter
    assert fused_gnn.LAUNCHES["segment_sort"] == before + (3 * fused_gnn.sort_passes(n) if e else 0)
    want = torch.sort(_sort_key(seg, n), stable=True).indices.to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(fused_gnn.segment_sort(seg, n), got)


def test_segment_sort_with_random_delays_keeps_torch_sorts_permutation(cuda):
    """The sort built with -DREPRO_SORT_JITTER: every thread sleeps a random
    0-1023 ns wherever data passes between lanes, warps or blocks, so a
    missing barrier gives a wrong permutation (without the one between the
    ranking and the warps' combine, the first sort already fails)."""
    from repro_torch.kernels import build

    plain = build.library("segment_sort")
    try:
        build.load_variant("segment_sort", "-DREPRO_SORT_JITTER")
        for n in (255, 65535, 150000):
            for e, kind in SORT_CASES[1:] + [(1050000, "power law")]:
                seg = _sort_ids(e, n, kind, n + e)
                want = torch.sort(_sort_key(seg, n), stable=True).indices.to(torch.int32)
                for _ in range(2):
                    assert torch.equal(fused_gnn.segment_sort(seg, n), want), (n, e, kind)
    finally:
        build._LIBS["segment_sort"] = plain


# (edges, rows of feats, segments, width, seed): ragged counts around the
# sort's 4096-key tile, 1 to 3 passes, the widths of the paths
DENSE_SWEEP = [
    (0, 4, 5, 8, 0),
    (1, 3, 1, 4, 1),
    (37, 9, 11, 3, 2),
    (4097, 300, 700, 16, 3),
    (20000, 5000, 70000, 128, 4),
    (65536, 20000, 4096, 256, 5),
]


def _dense_inputs(m, f, n, d, seed, dtype):
    """Ids in any order: 10% padding (-1) and 2% ids >= n in seg, 5%
    padding in idx."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, m)
    pick = rng.random(m)
    seg[pick < 0.1] = -1
    seg[(pick >= 0.1) & (pick < 0.12)] = n + 3
    idx = np.where(rng.random(m) < 0.05, -1, rng.integers(0, f, m))
    feats = rng.standard_normal((f, d)).astype(np.float32)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return (t(feats).to(dtype), t(msg).to(dtype), t(idx.astype(np.int32)),
            t(seg.astype(np.int32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,f,n,d,seed", DENSE_SWEEP)
def test_dense_forms_match_plain_and_the_sorted_kernel_bitwise(cuda, m, f, n, d, seed, dtype):
    feats, msg, idx, seg = _dense_inputs(m, f, n, d, seed, dtype)
    sort_kernels = 3 * fused_gnn.sort_passes(n) if m else 0
    fused_gnn.reset_launches()
    dense = fused_gnn.segment_spmm(msg, seg, n)
    gathered = fused_gnn.gather_spmm(feats, idx, seg, n)
    assert {k: v for k, v in fused_gnn.LAUNCHES.items() if v} == {
        k: v for k, v in (("segment_spmm", 1), ("gather_spmm", 1),
                          ("segment_sort", 2 * sort_kernels)) if v}
    assert dense.shape == gathered.shape == (n, d) and dense.dtype == gathered.dtype == dtype
    _close(dense, _plain(segment_spmm_ref, msg, seg, n), dtype)
    _close(gathered, _plain(gather_spmm_ref, feats, idx, seg, n), dtype)
    order = torch.sort(_sort_key(seg, n), stable=True).indices
    s_seg = seg[order].contiguous()
    index = fused_gnn.segment_index(s_seg, n)
    assert int(index[n + 1]) == 0  # the sorted input takes the CSR rows, not the scan
    assert torch.equal(dense, fused_gnn.segment_spmm_ragged(msg[order].contiguous(), s_seg, n))
    assert torch.equal(gathered, fused_gnn.gather_spmm_ragged(feats, idx[order].contiguous(),
                                                              s_seg, n))
    assert torch.equal(fused_gnn.segment_spmm(msg, seg, n), dense)
    assert torch.equal(fused_gnn.gather_spmm(feats, idx, seg, n), gathered)


def test_dense_forms_take_the_entry_points_keyword(cuda):
    from repro_torch.kernels import ops

    feats, msg, idx, seg = _dense_inputs(5000, 700, 900, 64, 6, torch.float32)
    assert torch.equal(ops.gnn_aggregate(msg, seg, 900, ragged=False),
                       fused_gnn.segment_spmm(msg, seg, 900))
    assert torch.equal(ops.gnn_gather_aggregate(feats, idx, seg, 900, ragged=False),
                       fused_gnn.gather_spmm(feats, idx, seg, 900))
    # the ragged form of unsorted ids still gives the same bits (its scan)
    assert torch.equal(ops.gnn_aggregate(msg, seg, 900), fused_gnn.segment_spmm(msg, seg, 900))


def test_sort_order_keeps_its_bits_on_the_card(cuda):
    """The gather backward's order: the radix sort gives the permutation
    torch.sort gave, with no bound (four passes) and with the rows' bound."""
    rng = np.random.default_rng(7)
    for f, e in ((9, 200), (100000, 240000)):
        idx = rng.integers(-1, f, e).astype(np.int32)
        want = fused_gnn.sort_order(torch.as_tensor(idx))  # the CPU plain version
        key = torch.as_tensor(np.where(idx < 0, 2**31 - 1, idx))
        assert torch.equal(want, torch.sort(key, stable=True).indices.to(torch.int32))
        t = torch.as_tensor(idx, device="cuda")
        before = fused_gnn.LAUNCHES["segment_sort"]
        assert torch.equal(fused_gnn.sort_order(t).cpu(), want)
        assert torch.equal(fused_gnn.sort_order(t, f).cpu(), want)
        assert fused_gnn.LAUNCHES["segment_sort"] == before + 3 * (4 + fused_gnn.sort_passes(f))
    grad = torch.randn(300, 16, device="cuda", generator=torch.Generator("cuda").manual_seed(5))
    idx_t = torch.as_tensor(rng.integers(-1, 50, 4000).astype(np.int32), device="cuda")
    seg_t = torch.as_tensor(np.sort(rng.integers(0, 300, 4000)).astype(np.int32), device="cuda")
    assert torch.equal(
        fused_gnn.gather_spmm_ragged_backward(grad, idx_t, seg_t, 50),
        fused_gnn.gather_spmm_ragged_backward(grad, idx_t, seg_t, 50,
                                              fused_gnn.sort_order(idx_t)))


def test_dense_forms_capture_in_a_cuda_graph(cuda):
    """No host sync anywhere in the sort or the sums: a graph captures
    each dense form, and its replay gives the eager bits."""
    feats, msg, idx, seg = _dense_inputs(70000, 5000, 150000, 128, 8, torch.float32)
    calls = {"segment_spmm": lambda: fused_gnn.segment_spmm(msg, seg, 150000),
             "gather_spmm": lambda: fused_gnn.gather_spmm(feats, idx, seg, 150000)}
    for name, fn in calls.items():
        want = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), name


def _guarded_calls():
    """Every kernel wrapper without a backward, as (name, call on inputs
    that require grad). Flash attention and the SSD scan have theirs
    (the backward-kernel tests below)."""
    feats, msg, idx, seg = _dense_inputs(3000, 200, 300, 32, 9, torch.float32)
    s_seg = torch.sort(seg).values
    g = lambda t: t.clone().requires_grad_(True)  # noqa: E731
    return [
        ("segment_spmm_ragged", lambda: fused_gnn.segment_spmm_ragged(g(msg), s_seg, 300)),
        ("segment_sum_and_count", lambda: fused_gnn.segment_sum_and_count(g(msg), s_seg, 300)),
        ("segment_max", lambda: fused_gnn.segment_max(g(msg[:, 0].contiguous()), seg, 300)),
        ("segment_spmm", lambda: fused_gnn.segment_spmm(g(msg), seg, 300)),
        ("gather_spmm", lambda: fused_gnn.gather_spmm(g(feats), idx, seg, 300)),
    ]


@pytest.mark.parametrize("which", range(5))
def test_wrappers_without_a_backward_raise_under_autograd(cuda, which):
    name, call = _guarded_calls()[which]
    with pytest.raises(RuntimeError, match=name):
        call()
    with torch.no_grad():
        out = call()
    with torch.inference_mode():
        call()
    assert all(not t.requires_grad for t in (out if isinstance(out, tuple) else (out,)))


# The CSR kernel's long rows (csrc/segment_sum.cu): a row of more than L =
# SUM_CHUNK edge slots is summed in chunks of L slots counted from its own
# first slot, each chunk in slot order, then the chunk sums in chunk order.
# ref.chunked_segment_sum_ref is that order in plain PyTorch: the kernel
# must have its bits on every case, so a row's bits depend on its own
# edges only.
LONG_ROWS = (1, SUM_CHUNK - 1, SUM_CHUNK, SUM_CHUNK + 1, 10 * SUM_CHUNK, 100000)


def _row_batch(lengths, d, f, dtype, seed, drop=0.05, pad=7):
    """Rows of the given slot counts in order, ``pad`` padding slots at the
    tail; messages [E, d], feats [f, d] and idx (a ``drop`` share -1)."""
    rng = np.random.default_rng(seed)
    seg = np.concatenate([np.repeat(np.arange(len(lengths)), lengths), np.full(pad, -1)])
    e = seg.shape[0]
    idx = np.where(rng.random(e) < drop, -1, rng.integers(0, f, e))
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return (t(seg.astype(np.int32)), t(rng.standard_normal((e, d)).astype(np.float32)).to(dtype),
            t(rng.standard_normal((f, d)).astype(np.float32)).to(dtype),
            t(idx.astype(np.int32)))


def _same_bits(got, want):
    torch.cuda.synchronize()
    return torch.equal(_bits(got), _bits(want))


def _model(src, seg, n, idx=None):
    """The order model of either form, in the output's dtype."""
    if idx is None:
        return chunked_segment_sum_ref(src, seg, n).to(src.dtype)
    return chunked_segment_sum_ref(src[idx.clamp_min(0).long()], seg, n, idx >= 0).to(src.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", LONG_ROWS)
def test_csr_kernel_is_the_order_model_bitwise_on_long_rows(cuda, length, dtype):
    lengths = [3, length, 0, length, SUM_CHUNK + 2, 5]
    seg, msg, feats, idx = _row_batch(lengths, 128, 3000, dtype, seed=length)
    n = len(lengths)
    assert _same_bits(fused_gnn.segment_spmm_ragged(msg, seg, n), _model(msg, seg, n))
    with torch.no_grad():
        got = fused_gnn.gather_spmm_ragged(feats, idx, seg, n)
    assert _same_bits(got, _model(feats, seg, n, idx))
    # two launches over one index: the chunk counters are left ready for the next
    total, count = fused_gnn.segment_sum_and_count(msg, seg, n)
    assert _same_bits(total, _model(msg, seg, n))
    ones = (seg >= 0).float()[:, None]
    assert _same_bits(count, _model(ones, seg, n))


@pytest.mark.parametrize("d", [1, 3, 24, 256])
def test_csr_kernel_is_the_order_model_bitwise_at_every_width(cuda, d):
    lengths = [SUM_CHUNK * 3 + 1, 2, SUM_CHUNK + 1, 700]
    seg, msg, feats, idx = _row_batch(lengths, d, 500, torch.float32, seed=d)
    n = len(lengths)
    assert _same_bits(fused_gnn.segment_spmm_ragged(msg, seg, n), _model(msg, seg, n))
    with torch.no_grad():
        assert _same_bits(fused_gnn.gather_spmm_ragged(feats, idx, seg, n),
                          _model(feats, seg, n, idx))


@pytest.mark.parametrize("row", [SUM_CHUNK + 1, 10 * SUM_CHUNK + 3, 100000])
def test_a_long_rows_bits_do_not_depend_on_where_it_sits(cuda, row):
    """The same row after different rows (so at different edge offsets, and
    with its chunks in different windows) and before others: its sum has
    the same bits every time, in both forms."""
    _, msg_row, feats, idx_row = _row_batch([row], 64, 2000, torch.float32, seed=1, pad=0)
    want = want_gather = None
    rng = np.random.default_rng(row)
    for trial in range(6):
        before = [int(x) for x in rng.integers(0, 3 * SUM_CHUNK, trial)]
        after = [int(x) for x in rng.integers(0, 3 * SUM_CHUNK, 5 - trial)]
        lengths = before + [row] + after
        seg, msg, _, idx = _row_batch(lengths, 64, 2000, torch.float32, seed=trial)
        at = sum(before)
        msg[at:at + row] = msg_row
        idx[at:at + row] = idx_row
        got = fused_gnn.segment_spmm_ragged(msg, seg, len(lengths))[len(before)]
        with torch.no_grad():
            got_gather = fused_gnn.gather_spmm_ragged(feats, idx, seg, len(lengths))[len(before)]
        if want is None:
            want, want_gather = got, got_gather
            alone = torch.zeros(row, dtype=torch.int32, device="cuda")
            assert _same_bits(want, _model(msg_row, alone, 1)[0])
            assert _same_bits(want_gather, _model(feats, alone, 1, idx_row)[0])
        assert _same_bits(got, want) and _same_bits(got_gather, want_gather), (trial, at)


@functools.lru_cache(maxsize=1)
def _stand_in_edges():
    """The ogbn-paper stand-in's 1.05 M edges shuffled, on the card: idx =
    src, seg = dst (in-degrees up to 6,447), with 128-wide features."""
    from repro_torch.graph import named_dataset

    g = named_dataset("ogbn-paper", feat_dim=128, num_classes=16, seed=0, scale=1.0)
    rng = np.random.default_rng(4)
    perm = rng.permutation(g.num_edges)
    idx = torch.as_tensor(g.src[perm].astype(np.int32), device="cuda")
    seg = torch.as_tensor(g.dst[perm].astype(np.int32), device="cuda")
    feats = torch.as_tensor(rng.standard_normal((g.num_vertices, 128)).astype(np.float32),
                            device="cuda")
    return idx, seg, feats, g.num_vertices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_forms_on_the_stand_in_graph_are_the_order_model_bitwise(cuda, dtype):
    idx, seg, feats32, n = _stand_in_edges()
    feats = feats32.to(dtype)
    msg = feats[idx.long()].contiguous()
    order = torch.sort(_sort_key(seg, n), stable=True).indices
    s_seg = seg[order]
    assert int(torch.bincount(_sort_key(seg, n))[:n].max()) > 100 * SUM_CHUNK
    assert _same_bits(fused_gnn.segment_spmm(msg, seg, n), _model(msg[order], s_seg, n))
    assert _same_bits(fused_gnn.gather_spmm(feats, idx, seg, n),
                      _model(feats, s_seg, n, idx[order]))


def test_long_rows_capture_in_a_cuda_graph_and_replay_bitwise(cuda):
    """No host sync in the chunked sums: a graph captures them, and every
    replay (the chunk counters rearmed by the one before) gives the eager
    bits."""
    seg, msg, feats, idx = _row_batch([10 * SUM_CHUNK, 3, 100000, SUM_CHUNK + 1], 128, 3000,
                                      torch.float32, seed=9)
    calls = {"segment_spmm_ragged": lambda: fused_gnn.segment_spmm_ragged(msg, seg, 4),
             "gather_spmm_ragged": lambda: fused_gnn.gather_spmm_ragged(feats, idx, seg, 4)}
    with torch.no_grad():
        for name, fn in calls.items():
            want = fn()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
            for _ in range(3):
                graph.replay()
                assert _same_bits(out, want), name


def test_second_sort_of_padding_ids_holds_a_thousand_times(cuda):
    """The one unexplained card failure of the first sort (a second
    segment_sort of 50,000 padding ids at n = 65,535 raised a device
    error), repeated on the current sort: every permutation is the
    identity, and the card reports no error."""
    seg = torch.full((50000,), -1, dtype=torch.int32, device="cuda")
    want = torch.arange(50000, dtype=torch.int32, device="cuda")
    for i in range(1000):
        first = fused_gnn.segment_sort(seg, 65535)
        second = fused_gnn.segment_sort(seg, 65535)
        torch.cuda.synchronize()
        assert torch.equal(first, want) and torch.equal(second, want), i


def _lengths_beside_the_cut(side, dtype):
    """Rows with a long row among them whose mean slot count lies below the
    wrapper's cut between the sum kernel's builds (``side`` "lean") or
    above it ("batched"), the tail's 7 padding slots counted. Float32 has
    no cut (always lean): its rows average 6 slots."""
    cut = fused_gnn._BATCH_FROM.get(dtype, 7)
    long = 10 * SUM_CHUNK + 3
    if side == "lean":
        return [long] + [cut - 1] * (long + 8)
    return [long] + [cut + 1] * 50


@pytest.mark.parametrize("dtype, side", [(torch.float32, "lean"), (torch.bfloat16, "lean"),
                                         (torch.bfloat16, "batched")])
def test_both_builds_of_the_sum_kernel_give_the_same_bits(cuda, side, dtype):
    """The lean build (one edge at a time) and the batched build add in
    one order: on inputs on either side of the wrapper's cut, the build it
    picks gives the order model's bits, long row included."""
    lengths = _lengths_beside_the_cut(side, dtype)
    seg, msg, feats, idx = _row_batch(lengths, 128, 900, dtype, seed=len(lengths))
    n = len(lengths)
    assert fused_gnn._lean(seg.shape[0], n, dtype) == (side == "lean")
    index = fused_gnn.segment_index(seg, n)
    out = torch.empty((n, 128), dtype=dtype, device="cuda")
    fused_gnn.launch_segment_sum(msg, seg, index, out)
    assert _same_bits(out, _model(msg, seg, n))
    fused_gnn.launch_gather_sum(feats, idx, seg, index, out)
    assert _same_bits(out, _model(feats, seg, n, idx))


# The backward kernels of flash attention and the SSD scan
# (csrc/flash_attention_backward.cu, csrc/ssd_scan_backward.cu), held
# against torch.autograd of the plain versions on the same inputs. float32:
# rtol 1e-4 / atol 1e-4 for attention (dK and dV sum up to Sq x H / Hkv
# terms in another order), rtol 1e-3 / atol 1e-3 for the SSD (da is a
# difference of sums of up to S P N terms). bf16 SSD: the kernel computes
# in float32 from the bf16 inputs and rounds dx, dB and dC once, so they
# are held against autograd of the plain version on the inputs upcast to
# float32 at rtol 1e-2 and atol 1e-3 of the tensor's largest element (one
# bf16 rounding); da, ddt and dinit, float32 outputs, at the float32
# tolerance. (Autograd of the plain version on the bf16 tensors rounds
# each head's dB and dC to bf16 before the group sum, 10x further off.)
# bf16 attention: the kernel rounds P (and dS, as a high/low split) to
# bf16 for its tensor-core products, where autograd of the plain version
# keeps them float32; both are held against autograd of the plain version
# on the inputs upcast to float32, and the kernel's largest error may be at
# most ATTN_BF16_GRAD_RATIO times the plain version's own (the
# repository's bf16 rule, as chip_smoke.py holds the LM logits). Under
# autograd the forward hands the backward its float32 output for D =
# rowsum(dO o), as training does.
_GRAD_TOL = {"attention": {torch.float32: (1e-4, 1e-4)}, "ssd": {torch.float32: (1e-3, 1e-3)}}
ATTN_BF16_GRAD_RATIO = 2.0


def _grad_close(name, got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(),
                               rtol=tol[0], atol=tol[1], err_msg=name)


# (B, Sq, Skv, H, Hkv, D, Dv, causal, window, kv_offset): MQA 8:1 at D 256
# (gemma-2b), 10:1 with a window (recurrentgemma-2b's local attention),
# MLA's (192, 128), GQA with a window, queries after a cache, every other
# width, no mask
ATTN_BWD_SWEEP = [
    (2, 256, 256, 8, 1, 256, 256, True, 0, 0),
    (1, 300, 300, 10, 1, 256, 256, True, 128, 0),
    (1, 200, 200, 16, 16, 192, 128, True, 0, 0),
    (2, 130, 130, 8, 2, 128, 128, True, 37, 0),
    (1, 33, 200, 4, 4, 64, 64, True, 0, 167),
    (1, 100, 100, 4, 2, 96, 64, True, 0, 0),
    (1, 70, 70, 4, 4, 32, 32, False, 0, 0),
    # the tensor-core kernels' 64-row tiles: S one past a tile, a window
    # that cuts a tile, a kv_offset off the tile grid, S = 1
    (1, 129, 129, 8, 1, 256, 256, True, 0, 0),
    (2, 191, 191, 10, 1, 256, 256, True, 70, 0),
    (1, 65, 257, 4, 2, 192, 128, True, 50, 192),
    (1, 1, 2, 8, 1, 256, 256, True, 0, 1),
    (2, 1, 77, 4, 2, 128, 128, True, 0, 76),
]


def _attn_grad_inputs(b, sq, skv, h, hkv, d, dv, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32),  # noqa: E731
                                   device="cuda").to(dtype)
    return t(b, sq, h, d), t(b, skv, hkv, d), t(b, skv, hkv, dv), t(b, sq, h, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_BWD_SWEEP)
def test_flash_attention_backward_matches_autograd(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_backward_ref, attention_lse_ref

    b, sq, skv, h, hkv, d, dv, causal, window, off = case
    q, k, v, dout = _attn_grad_inputs(b, sq, skv, h, hkv, d, dv, dtype, sq + d)
    kw = dict(causal=causal, window=window, kv_offset=off)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves, **kw)
    out.backward(dout)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_backward"] == before["flash_attention_backward"] + 1
    want = attention_backward_ref(q, k, v, dout, **kw)
    if dtype == torch.float32:
        for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
            assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
            _grad_close(f"{name} {case} {dtype}", leaf.grad, w, _GRAD_TOL["attention"][dtype])
    else:
        up = attention_backward_ref(q.float(), k.float(), v.float(), dout.float(), **kw)
        for name, leaf, w, u in zip(("dq", "dk", "dv"), leaves, want, up):
            assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
            got_err = float((leaf.grad.float() - u).abs().max())
            plain_err = float((w.float() - u).abs().max())
            assert got_err <= ATTN_BF16_GRAD_RATIO * plain_err, (name, case, got_err, plain_err)
    # the forward's log-sum-exp and float32 output, which the backward reads
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    o32 = torch.empty(out.shape, dtype=torch.float32, device="cuda")
    fa.launch_flash_attention(q, k, v, torch.empty_like(out), lse, o32, **kw)
    _grad_close(f"lse {case} {dtype}", lse, attention_lse_ref(q, k, **kw),
                (1e-5, 1e-4) if dtype == torch.float32 else (1e-3, 1e-3))
    o = out.detach() if dtype == torch.float32 else o32
    # deterministic: the same bits again
    again = fa.flash_attention_backward(q, k, v, o, dout, lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(
        again, fa.flash_attention_backward(q, k, v, o, dout, lse, **kw)))


# (B, S, H, P, G, N, init, final grad): mamba2-130m's heads at a ragged S,
# G > 1, an initial state, every P and N
SSD_BWD_SWEEP = [
    (2, 256, 24, 64, 1, 128, False, True),
    (1, 200, 24, 64, 1, 128, True, True),
    (2, 100, 8, 32, 2, 64, True, False),
    (1, 64, 4, 16, 4, 32, False, True),
    (1, 1, 2, 64, 1, 128, True, True),
    # the chunk edges of the tensor-core kernels' 64-step chunks
    (1, 65, 24, 64, 1, 128, True, True),
    (2, 127, 8, 32, 2, 64, False, True),
    (1, 63, 4, 16, 1, 32, True, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_BWD_SWEEP)
def test_ssd_scan_backward_matches_autograd(cuda, case, dtype):
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_backward_ref

    b, s, h, p, g, n, init, final_grad = case
    x, dt, A, B, C, st = _ssd_inputs(b, s, h, p, g, n, dtype, s + p, init)
    a = dt * A
    rng = np.random.default_rng(s)
    dy = torch.as_tensor(rng.standard_normal((b, s, h, p)).astype(np.float32),
                         device="cuda").to(dtype)
    dfinal = (torch.as_tensor(rng.standard_normal((b, h, p, n)).astype(np.float32),
                              device="cuda") if final_grad else None)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, dt, B, C)]
    init_leaf = None if st is None else st.clone().requires_grad_(True)
    before = dict(sk.LAUNCHES)
    y, final = sk.ssd_scan_fused(*leaves, init_state=init_leaf)
    loss = (y.float() * dy.float()).sum()
    if dfinal is not None:
        loss = loss + (final * dfinal).sum()
    loss.backward()
    assert sk.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert sk.LAUNCHES["ssd_scan_backward"] == before["ssd_scan_backward"] + 1
    want = ssd_backward_ref(x.float(), a, dt, B.float(), C.float(), dy.float(), dfinal,
                            init_state=st)
    got = [t.grad for t in leaves] + [None if init_leaf is None else init_leaf.grad]
    for name, gg, w in zip(("dx", "da", "ddt", "dB", "dC", "dinit"), got, want):
        if w is None:
            continue
        assert gg.dtype == (dtype if name in ("dx", "dB", "dC") else torch.float32), name
        if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
            tol = (1e-2, 1e-3 * float(w.abs().max()))
        else:
            tol = _GRAD_TOL["ssd"][torch.float32]
        _grad_close(f"{name} {case} {dtype}", gg, w, tol)
    # deterministic: the same bits again
    one = sk.ssd_scan_backward(x, a, dt, B, C, dy, dfinal, init_state=st)
    two = sk.ssd_scan_backward(x, a, dt, B, C, dy, dfinal, init_state=st)
    assert all((u is None and w is None) or torch.equal(u, w) for u, w in zip(one, two))


def _kernel_names(fn) -> set:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_route_by_dtype(cuda, dtype):
    """bf16 runs the tensor-core kernels (``*_mma_*``), float32 the scalar
    ones: the symbols the card ran, a static choice, not a fallback."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    q, k, v, dout = _attn_grad_inputs(1, 130, 130, 4, 2, 128, 128, dtype, 0)
    lse = torch.empty((1, 4, 130), dtype=torch.float32, device="cuda")
    out = torch.empty_like(dout)
    o32 = torch.empty(out.shape, dtype=torch.float32, device="cuda")
    fa.launch_flash_attention(q, k, v, out, lse, o32, causal=True, window=0, kv_offset=0)
    o = out if dtype == torch.float32 else o32
    flash = _kernel_names(lambda: fa.flash_attention_backward(q, k, v, o, dout, lse))
    x, dt, A, B, C, _ = _ssd_inputs(1, 100, 4, 64, 1, 128, dtype, 0, False)
    ssd = _kernel_names(lambda: sk.ssd_scan_backward(x, dt * A, dt, B, C, torch.ones_like(x)))
    tc = dtype == torch.bfloat16
    for names, kernels in ((flash, ("dkv", "dq")), (ssd, ("chunk_state", "chunk_grad"))):
        prefix = "flash_bwd_kernel_" if names is flash else "ssd_bwd_kernel_"
        for kern in kernels:
            assert any(prefix + "mma_" + kern in n for n in names) == tc, (kern, names)
            assert any(prefix + kern + "<" in n for n in names) != tc, (kern, names)


def _host_batches(pipe, epochs):
    stream = pipe.host_batches(epochs)
    try:
        return list(stream)
    finally:
        stream.close()


def _completed_on_the_cpu(items, device):
    """Host batches completed by the plain versions, then moved to
    ``device``: what the card's completion must give, bit for bit."""
    from repro_torch.models.gnn.batching import complete_batch

    return [(s, complete_batch(b.to("cpu")).to(device)) for s, b in items]


def test_a_batch_moves_the_same_bits_from_pinned_and_pageable_memory(cuda, monkeypatch):
    """``GNNBatch.to`` gives the same tensors from a pageable batch and from
    one whose arrays lie in a pinned buffer, and pins only the pageable
    one's arrays."""
    from repro_torch.api.pipeline import _plan, _views, write_batch

    system = _small_system()
    pipe = system.loader(np.arange(0, 1500, 2), batch_size=64, prefetch=0, device="cpu")
    _, host = _host_batches(pipe, 1)[0]
    pinned = torch.empty(_plan(host)[1], dtype=torch.uint8, pin_memory=True)
    plan, _ = write_batch(pinned.numpy(), host)
    staged = _views(pinned.numpy(), plan)
    calls = []
    real = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t, *a, **kw: calls.append(t) or real(t, *a, **kw))
    a = host.to(cuda)
    pinned_calls = len(calls)
    b = staged.to(cuda)
    torch.cuda.synchronize()
    assert pinned_calls == sum(len(v) if isinstance(v, list) else v is not None
                               for v in vars(host).values())
    assert len(calls) == pinned_calls  # the staged batch pinned nothing
    for name, va in vars(a).items():
        vb = getattr(b, name)
        for x, y in zip(va if isinstance(va, list) else [va], vb if isinstance(vb, list) else [vb]):
            if x is None:  # counts and orders: a host batch has none
                assert y is None, name
                continue
            assert x.device.type == "cuda" and torch.equal(x, y), name


def test_forked_producers_to_the_card_give_the_serial_stream(cuda):
    """Three forked producers, each batch copied out of its slot into a
    reused pinned buffer and on to the card, completed there: every batch
    of two epochs, held to the end, is the serial stream's completed by
    the plain versions, bit for bit."""
    from repro_torch.api import BatchPipeline

    system = _small_system()

    def pipe(prefetch, device, cores=None):
        return BatchPipeline(system.backend, system.graph, np.arange(0, 1500, 2), (6, 4), 2,
                             batch_size=64, prefetch=prefetch, worker_cores=cores, device=device)

    want = _completed_on_the_cpu(_host_batches(pipe(0, "cpu"), 2), "cpu")
    ahead = pipe(2, "cuda", (0, 1, 2))
    try:
        got = list(ahead.batches(2))
        assert all(t.is_pinned() for t in ahead._pinned._tensors)
    finally:
        ahead.close()
    torch.cuda.synchronize()
    assert len(got) == len(want) == 22
    for (sa, ba), (sb, bb) in zip(want, got):
        assert np.array_equal(sa, sb)
        for name, va in vars(ba).items():
            vb = getattr(bb, name)
            for x, y in zip(va if isinstance(va, list) else [va],
                            vb if isinstance(vb, list) else [vb]):
                if x is None:  # vertex_ids: a completed batch has none
                    assert y is None, name
                    continue
                assert y.device.type == "cuda" and torch.equal(x, y.cpu()), name


# Completing a batch on the card (kernels/batch_finish.py,
# models/gnn/batching.py::complete_batch): bit for bit the plain versions'.


def _same_on_card(want, got):
    """Two batches of tensors on the card, every field bit for bit."""
    torch.cuda.synchronize()
    for name, va in vars(want).items():
        vb = getattr(got, name)
        for x, y in zip(va if isinstance(va, list) else [va],
                        vb if isinstance(vb, list) else [vb]):
            assert (x is None) == (y is None), name
            if x is not None:
                assert y.device.type == "cuda" and x.dtype == y.dtype, name
                assert torch.equal(x, y), name


def test_the_finishing_kernels_match_their_plain_versions(cuda):
    """Rows of a pinned host table (PyTorch's and a ``HostTable``'s
    registered copy) and of a table on the card, with padding and ids past
    the table, at row widths 128, 34 and 7 (16-, 8- and 4-byte loads);
    counts read off sorted keys with padding; the sort with a gathered
    second array: each bit for bit its plain version. ``HostTable.close``
    frees its copy, once."""
    from repro_torch.kernels import batch_finish
    from repro_torch.kernels.ref import sorted_counts_ref, table_rows_ref

    g = torch.Generator().manual_seed(0)
    for dim in (128, 34, 7):
        table = torch.randn(500, dim, generator=g)
        ids = torch.randint(-1, 520, (777,), generator=g)
        want = table_rows_ref(table, ids)
        host = batch_finish.HostTable(table.numpy())
        assert host.tensor.is_pinned() and host.nbytes == table.numel() * 4
        for where in (table.pin_memory(), host.tensor, table.to(cuda)):
            got = batch_finish.table_rows(where, ids.to(cuda))
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (dim, where.device)
        host.close()
        assert host.tensor is None and host.nbytes == 0
        host.close()
    with pytest.raises(ValueError, match="pinned"):
        batch_finish.table_rows(table, ids.to(cuda))  # pageable host memory
    for n, e in ((35840, 50176), (300, 4096), (5, 1024)):
        seg = torch.randint(-1, n + 3, (e,), generator=g, dtype=torch.int32)
        idx = torch.randint(-1, n, (e,), generator=g, dtype=torch.int32)
        want = batch_finish.sort_edges(seg, n, idx)
        got = batch_finish.sort_edges(seg.to(cuda), n, idx.to(cuda))
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu()), (n, e)
        counts = batch_finish.sorted_counts(got[0], n)
        torch.cuda.synchronize()
        assert torch.equal(counts.cpu(), sorted_counts_ref(seg, n)), (n, e)


def _shipped_pair(system, fanouts, layers, typed, vq, eq):
    from repro_torch.models.gnn.batching import subgraph_to_batch

    g = system.graph
    sub = system.backend.sample(np.arange(0, 1500, 23)[:64], list(fanouts))
    kw = dict(edge_types=g.edge_types if typed else None, vertex_quantum=vq, edge_quantum=eq)
    return (subgraph_to_batch(sub, g.vertex_feats, g.labels, layers, **kw),
            subgraph_to_batch(sub, g.vertex_feats, g.labels, layers, rows=False, **kw))


@pytest.mark.parametrize("plan", [((6, 4, 2), 3, False, 256, 1024), ((6, 4), 2, True, 64, 128)],
                         ids=["sage-like", "hetero"])
def test_a_shipped_batch_completed_on_the_card_is_the_host_batch(cuda, plan):
    """``complete_batch`` of a batch without rows moved with ``.to``: every
    field the plain versions' completion of the batch with rows, bit for
    bit, from a pinned table and from a table on the card; one launch of
    the rows kernel, per layer one of the counts kernel and two sorts,
    nothing of the model's kernels counted. The batch with rows completes
    to the same without the rows kernel."""
    from repro_torch.kernels import batch_finish
    from repro_torch.models.gnn.batching import complete_batch

    system = _small_system()
    whole, shipped = _shipped_pair(system, *plan)
    layers = plan[1]
    want = _completed_on_the_cpu([(None, whole)], cuda)[0][1]
    table = torch.from_numpy(system.graph.vertex_feats).pin_memory()
    passes = fused_gnn.sort_passes(whole.valid.shape[0])
    fused_gnn.reset_launches()
    for where in (table, table.to(cuda)):
        batch_finish.reset_launches()
        _same_on_card(want, complete_batch(shipped.to(cuda), where))
        assert batch_finish.LAUNCHES == {"table_rows": 1, "sorted_counts": layers,
                                         "segment_sort": 2 * layers * 3 * passes}
    batch_finish.reset_launches()
    _same_on_card(want, complete_batch(whole.to(cuda)))
    assert batch_finish.LAUNCHES == {"table_rows": 0, "sorted_counts": layers,
                                     "segment_sort": 2 * layers * 3 * passes}
    assert set(fused_gnn.LAUNCHES.values()) == {0}


def _stalling_pipeline(*a, **kw):
    """A ``BatchPipeline`` whose producer 1 stalls in its second batch until
    it is killed; the producer respawned in its place does not stall."""
    import multiprocessing as mp
    import time

    from repro_torch.api import BatchPipeline

    class Stalling(BatchPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.stalled = mp.get_context("fork").Event()
            self._index = None
            self._made = 0

        def _worker_loop(self, index, *a):
            self._index = index
            super()._worker_loop(index, *a)

        def _assemble(self, seeds, *args):
            if self._index == 1 and not self.stalled.is_set():
                self._made += 1
                if self._made == 2:
                    self.stalled.set()
                    time.sleep(120)
            return super()._assemble(seeds, *args)

    return Stalling(*a, **kw)


@pytest.mark.parametrize("respawn", [False, True], ids=["steady", "respawn"])
def test_two_producers_ship_to_the_card_the_host_stream(cuda, respawn):
    """Two forked producers leave the rows of eight batches to the card,
    which completes them: the batches of ``host_batches()`` completed by
    the plain versions, bit for bit; also when producer 1 is killed
    mid-run after the card path has run (CUDA initialised, the table and
    the staging buffers pinned) and respawned. Each batch is completed
    once in the consumer; the slot holds no rows."""
    from repro_torch import tracing
    from repro_torch.api import BatchPipeline
    from repro_torch.kernels import batch_finish

    system = _small_system()

    def pipe(device, stalling=False):
        args = (system.backend, system.graph, np.arange(0, 1024, 2), (6, 4), 2)
        kw = dict(batch_size=64, prefetch=2, worker_cores=(0, 1), device=device)
        return (_stalling_pipeline if stalling else BatchPipeline)(*args, **kw)

    host = pipe("cpu")
    try:
        want = _completed_on_the_cpu(_host_batches(host, 1), cuda)
        bare_slot = host.slot_bytes()
    finally:
        host.close()
    ahead = pipe("cuda", respawn)
    tracing.reset()
    batch_finish.reset_launches()
    got = []
    stream = ahead.batches(1)
    try:
        for item in stream:
            got.append(item)
            if respawn and len(got) == 2:
                assert ahead.stalled.wait(timeout=60)
                victim = ahead._producers[1].proc
                victim.kill()
                victim.join(timeout=10)
        assert ahead.respawn_count == int(respawn)
        assert ahead._rows_as_ids and host._rows_as_ids and ahead._table.tensor.is_pinned()
        assert ahead.slot_bytes() == bare_slot
        assert all(p.ring.slot_bytes == bare_slot for p in ahead._producers)
    finally:
        stream.close()
        ahead.close()
    assert ahead._table is None and ahead._pinned is None
    assert len(got) == len(want) == 8
    for (sa, a), (sb, b) in zip(want, got):
        assert np.array_equal(sa, sb)
        _same_on_card(a, b)
    assert batch_finish.LAUNCHES["table_rows"] == 8
    taken = tracing.roots("pipeline.next")
    assert [r.count.get("batch.complete") for r in taken] == [1] * 8
    assert not any("batch.complete" in r.count or "batch.features" in r.count
                   for r in tracing.roots("pipeline.produce"))


def test_a_store_backed_pipeline_gathers_on_the_host(cuda, tmp_path):
    """Over a ``StoreFeatureSource`` the forked producers gather the rows
    themselves; the card completes each batch without the rows kernel, and
    no table is pinned. The batches are the host stream's completed by the
    plain versions."""
    from repro_torch import tracing
    from repro_torch.api import BatchPipeline
    from repro_torch.core.storage import StoreFeatureSource
    from repro_torch.kernels import batch_finish

    system = _small_system()
    source = StoreFeatureSource.from_array(system.graph.vertex_feats, str(tmp_path / "feats"),
                                           chunk_rows=256)

    def pipe(device, prefetch):
        return BatchPipeline(system.backend, system.graph, np.arange(0, 1024, 2), (6, 4), 2,
                             batch_size=64, prefetch=prefetch, worker_cores=(0, 1),
                             feature_source=source, device=device)

    want = _completed_on_the_cpu(_host_batches(pipe("cpu", 0), 1), cuda)
    ahead = pipe("cuda", 2)
    tracing.reset()
    batch_finish.reset_launches()
    try:
        got = list(ahead.batches(1))
        assert ahead._table is None and not ahead._rows_as_ids
    finally:
        ahead.close()
    assert len(got) == len(want) == 8
    for (sa, a), (sb, b) in zip(want, got):
        assert np.array_equal(sa, sb)
        _same_on_card(a, b)
    assert batch_finish.LAUNCHES["table_rows"] == 0 and batch_finish.LAUNCHES["sorted_counts"] == 16
    assert all("batch.features" in r.count for r in tracing.roots("pipeline.produce"))
    assert [r.count.get("batch.complete") for r in tracing.roots("pipeline.next")] == [1] * 8
