"""The per-layer metrics that read the program's own spans
(``harness/spans.py`` and its five readers): hand-built roots with known
shares, and every training and inference cell at the tiny size on the CPU
with its per-layer metrics read (``trace=True``)."""
from __future__ import annotations

import os
import time
from unittest import mock

import pytest

from glisp_bench.harness.core import cells, execute, read_metric
from glisp_bench.tests.tiny import TINY_CONFIG, TINY_TRAFFIC, get_cell

tracing = pytest.importorskip("repro_torch.tracing")

# metric -> (its kind, its root, the self-time names it sums)
SPAN_METRICS = {
    "producer_sampling_share.train": ("train", "pipeline.produce", ("sampling.submit",
                                                                    "sampling.round")),
    "producer_assemble_share.train": ("train", "pipeline.produce", ("batch.assemble",
                                                                    "batch.features")),
    "producer_handoff_share.train": ("train", "pipeline.produce", ("pipeline.put",)),
    "engine_self_share.infer": ("infer", "engine.pass", ("engine.pass", "engine.layer")),
    "storage_io_share.infer": ("infer", "engine.pass", ("storage.chunk_read",
                                                        "storage.chunk_write",
                                                        "storage.fsync")),
}
# names no metric above sums
OTHERS = ("pipeline.x", "batches.other", "samplingx", "engine.slice", "storage.checksum")


def _root(name, names, share):
    """A root of 1000 ns whose ``names`` hold ``share`` % of it between
    them (5 ns each but the first), the rest on names no metric sums."""
    self_ns = {n: 5 for n in names}
    self_ns[names[0]] = share * 10 - 5 * (len(names) - 1)
    for n in OTHERS:
        self_ns[n] = 20
    self_ns["other.rest"] = 1000 - sum(self_ns.values())
    return tracing.Root(name, 1, 0, 1000, self_ns, {n: 1 for n in self_ns}, [])


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_reader_takes_the_median_share_of_its_roots(metric, monkeypatch):
    kind, root, names = SPAN_METRICS[metric]
    kept = [_root(root, names, s) for s in (30, 10, 70, 20, 40)]
    monkeypatch.setattr(tracing, "roots", lambda name: kept if name == root else [])
    assert read_metric(metric, {"kind": kind}) == pytest.approx(30.0)
    other = "infer" if kind == "train" else "train"
    assert read_metric(metric, {"kind": other}) is None
    monkeypatch.setattr(tracing, "roots", lambda name: [])
    assert read_metric(metric, {"kind": kind}) is None


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    import sys

    import repro_torch

    kept = [_root("pipeline.produce", ("pipeline.put",), 50)]
    monkeypatch.setattr(tracing, "roots", lambda name: kept)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # the import fails
    for metric, (kind, _, _) in SPAN_METRICS.items():
        assert read_metric(metric, {"kind": kind}) is None


@pytest.mark.parametrize("cell", [c for c in cells() if c.endswith((".train", ".infer"))])
def test_every_span_metric_reads_a_share_at_the_tiny_size(cell, tmp_path):
    c = get_cell(cell)
    c.config.update(TINY_CONFIG)
    c.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in c.traffic})
    tracing.reset()
    with mock.patch.dict(os.environ, {"TMPDIR": str(tmp_path)}):
        result, _ = execute(c, 2**31 + 91, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    mine = {m["name"] for m in c.per_layer if m["name"] in SPAN_METRICS}
    assert mine == {m for m, (kind, _, _) in SPAN_METRICS.items() if cell.endswith(kind)}
    for m in mine:
        assert 0 < result["metrics"][m]["value"] < 100, (m, result["metrics"])
