"""``repro_torch.analysis.recompile_guard`` on the card: the tuner's sweeps
over real tuned passes.

Every test here needs a CUDA card: the ``cuda`` fixture skips without one
(decided at run time, so every pytest-xdist worker collects the same
tests). Run on a machine with a card with
``pytest -m gpu tests/test_torch_analysis_gpu.py``. Imports nothing of JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as torch_api  # noqa: E402
from repro_torch.analysis import RecompileError, recompile_guard  # noqa: E402
from repro_torch.graph import power_law_graph  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.models.gnn import GNNModel  # noqa: E402

pytestmark = pytest.mark.gpu

GRAPH = dict(num_vertices=3000, avg_degree=8, seed=3, feat_dim=32, num_classes=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    at.reset()
    yield torch.device("cuda")
    at.reset()


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_a_repeated_tuned_pass_sweeps_nothing(cuda, kind, tmp_path):
    system = torch_api.GLISPSystem.build(
        power_law_graph(**GRAPH), torch_api.GLISPConfig(num_parts=2, fanouts=(6, 4), seed=0))
    model = GNNModel(kind, GRAPH["feat_dim"], hidden=32, num_layers=2, num_heads=2,
                     device="cuda")
    fns = [model.embed_layer_fn(k) for k in range(2)]
    kw = dict(out_dims=[32, 32], batch_size=256, device="cuda", kernel_autotune=True,
              kernel_cache_dir=str(tmp_path / "tune"))
    with recompile_guard(system) as first:
        system.infer_layerwise(fns, str(tmp_path / "run"), **kw)
    engine = system.infer_engine
    stored = engine.layer_stores[-1].read_rows(np.arange(GRAPH["num_vertices"]))
    assert first.compiles == first.new_shapes == len(at.sweeps()) > 0
    assert first.compiles == engine.sweep_count() == at.stats()["measured"]
    with recompile_guard(system) as again:
        system.infer_layerwise(fns, str(tmp_path / "run"), **kw)
    assert system.infer_engine is engine
    assert (again.compiles, again.new_shapes, again.bound) == (0, 0, 0)
    again_rows = engine.layer_stores[-1].read_rows(np.arange(GRAPH["num_vertices"]))
    assert np.array_equal(stored.view(np.uint32), again_rows.view(np.uint32))


class _Counting:
    """An engine's two counters over direct tuner calls."""

    def __init__(self):
        self.sweeps = 0
        self.keys = set()

    def sweep_count(self):
        return self.sweeps

    def tuned_key_count(self):
        return len(self.keys)

    def tune(self, shape):
        measured = at.stats()["measured"]
        at.autotune("segment_spmm_ragged", shape, torch.float32, repeats=1)
        self.sweeps += at.stats()["measured"] - measured
        self.keys.add(at.tuned_key("segment_spmm_ragged", shape, torch.float32))


def test_a_key_swept_twice_trips_the_guard(cuda):
    shape = (4096, 512, 64)
    eng = _Counting()
    with pytest.raises(RecompileError, match="2 sweep"):
        with recompile_guard(eng):
            eng.tune(shape)
            at.reset()  # the table dropped: the same key is swept again
            eng.tune(shape)
    at.reset()
    eng = _Counting()
    with recompile_guard(eng, extra=1) as rec:  # extra= admits the second sweep
        eng.tune(shape)
        at.reset()
        eng.tune(shape)
    assert (rec.compiles, rec.new_shapes, rec.bound) == (2, 1, 2)
