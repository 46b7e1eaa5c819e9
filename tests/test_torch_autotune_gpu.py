"""The launch-shape autotuner on the card.

Every test here needs a CUDA card: the ``cuda`` fixture skips without one
(decided at run time, so every pytest-xdist worker collects the same
tests). Run on a machine with a card with
``pytest -m gpu tests/test_torch_autotune_gpu.py``. Imports nothing of JAX.

No tolerance: every launch shape adds each column in edge order and a
long row in chunk order, so each must give the heuristic's bits, and the
sums the bits of ``ref.chunked_segment_sum_ref`` (the kernel's order in
plain PyTorch).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import fused_gnn  # noqa: E402
from repro_torch.kernels.ref import SUM_CHUNK, chunked_segment_sum_ref  # noqa: E402

pytestmark = pytest.mark.gpu

# an engine bucket, rows of about 3 x SUM_CHUNK slots (long-row chunks), the count (D = 1)
SHAPES = [(4096, 512, 128), (16384, 64, 64), (4096, 512, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    at.reset()
    yield torch.device("cuda")
    at.reset()


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def _same_bits(a, b):
    torch.cuda.synchronize()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _order_model(op, inp):
    """The sum kernels' bits: ``ref.chunked_segment_sum_ref`` over the
    terms each edge slot reads (the inputs' seg is sorted, padding last,
    so the dense forms' stable sort keeps the order)."""
    seg, idx, n = inp["seg"], inp["idx"], inp["n"]
    if op.startswith("segment"):
        terms, keep = inp["msg"], None
    else:
        terms, keep = inp["feats"][idx.clamp_min(0).long()], idx >= 0
    return chunked_segment_sum_ref(terms, seg, n, keep).to(terms.dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=["bucket", "long-rows", "count"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", [op for op in at.TUNED_OPS if op != "segment_max"])
def test_every_candidate_gives_the_heuristic_s_bits(cuda, op, dtype, shape):
    inp = at._inputs(op, shape, dtype)
    if shape[1] == 64:
        rows = torch.bincount(inp["seg"][inp["seg"] >= 0].long(), minlength=64)
        assert int(rows.max()) > SUM_CHUNK
    launch = at._kernel(op, inp)
    cands = at.valid_candidates(op, shape, dtype)
    want = launch(cands[0]).clone()
    if op != "gat_softmax_aggregate":
        assert _same_bits(want, _order_model(op, inp))
    if dtype == torch.float32 and op != "gat_softmax_aggregate":
        assert any(c.lean == 0 for c in cands)  # the float32 batched build runs
    for cfg in cands[1:]:
        assert _same_bits(launch(cfg), want), cfg


def test_segment_max_has_one_candidate_and_tunes(cuda, tmp_path):
    shape = (4096, 512, 1)
    assert at.valid_candidates("segment_max", shape, torch.float32) == (
        at.KernelConfig(1, 1, 1),)
    assert at.autotune("segment_max", shape, torch.float32) == at.KernelConfig(1, 1, 1)


class _Recorder:
    """The real library with its sum and GAT entries' arguments recorded."""

    def __init__(self, lib, calls):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in ("segment_sum", "gather_segment_sum", "gat_softmax_aggregate"):
            return fn

        def call(*args):
            self._calls.append((name, args))
            return fn(*args)

        return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuned_launches_pass_the_winner_to_the_library(cuda, monkeypatch, dtype):
    calls = []
    real = fused_gnn.library
    monkeypatch.setattr(fused_gnn, "library", lambda stem: _Recorder(real(stem), calls))
    e, n, d = 4096, 512, 128
    inp = at._inputs("segment_spmm_ragged", (e, n, d), dtype)
    seg, msg, feats, idx = inp["seg"], inp["msg"], inp["feats"], inp["idx"]
    untuned = [fused_gnn.segment_spmm_ragged(msg, seg, n),
               fused_gnn.gather_spmm_ragged(feats, idx, seg, n),
               fused_gnn.gat_softmax_aggregate(inp["logits"], msg, seg, n)]
    wins = {"segment_spmm_ragged": at.KernelConfig(2, 4, 0),
            "gather_spmm_ragged": at.KernelConfig(1, 8, 0),
            "gat_softmax_aggregate": at.KernelConfig(2, 2, 1)}
    for op, cfg in wins.items():
        at._TUNED[at.tuned_key(op, (e, n, d), dtype)] = cfg
    calls.clear()
    with torch.no_grad():
        tuned = [fused_gnn.segment_spmm_ragged(msg, seg, n),
                 fused_gnn.gather_spmm_ragged(feats, idx, seg, n),
                 fused_gnn.gat_softmax_aggregate(inp["logits"], msg, seg, n)]
    # (vec, tpr, lean) follow the dtype code in the sums' C signatures;
    # (vec, tpr) in the aggregate's
    got = [args[-7:-4] if name != "gat_softmax_aggregate" else args[-5:-3]
           for name, args in calls]
    assert got == [(2, 4, 0), (1, 8, 0), (2, 2)]
    for a, b in zip(tuned, untuned):
        assert _same_bits(a, b)


def test_a_misaligned_view_caps_the_tuned_vec(cuda):
    e, n, d = 4096, 512, 128
    inp = at._inputs("segment_spmm_ragged", (e, n, d), torch.bfloat16)
    seg, msg = inp["seg"], inp["msg"]
    want = fused_gnn.segment_spmm_ragged(msg, seg, n)
    at._TUNED[at.tuned_key("segment_spmm_ragged", (e, n, d), torch.bfloat16)] = \
        at.KernelConfig(8, 16, 0)
    buf = torch.empty(e * d + 2, dtype=torch.bfloat16, device="cuda")
    off = buf[2:].view(e, d)  # 4 bytes past a 16-byte boundary
    off.copy_(msg)
    assert fused_gnn._launch_shape("segment_spmm_ragged", None, e, n, d, off) == (2, 16, 0)
    assert fused_gnn._launch_shape("segment_spmm_ragged", None, e, n, d, msg) == (8, 16, 0)
    assert _same_bits(fused_gnn.segment_spmm_ragged(off, seg, n), want)


def test_the_artifact_is_reused_after_reset(cuda, tmp_path):
    shape, cache = (4096, 512, 64), str(tmp_path)
    first = at.autotune("gather_spmm_ragged", shape, torch.float32, cache_dir=cache, repeats=2)
    assert at.stats() == {"memory_hits": 0, "artifact_hits": 0, "measured": 1}
    rec = at.sweeps()[at.tuned_key("gather_spmm_ragged", shape, torch.float32)]
    assert rec["winner"] == vars(first) and rec["winner_ms"] > 0 and rec["heuristic_ms"] > 0
    assert rec["winner_ms"] <= rec["heuristic_ms"]
    at.reset(clear_stats=False)
    again = at.autotune("gather_spmm_ragged", shape, torch.float32, cache_dir=cache)
    assert again == first
    assert at.stats() == {"memory_hits": 0, "artifact_hits": 1, "measured": 1}
    assert at.get_tuned("gather_spmm_ragged", shape, torch.float32) == first
