"""The harness's own arithmetic and wiring, on the CPU in seconds: cells
found by name, BENCHMARK.json against the benchmark's contract, the
traffic's determinism, the frozen op counts, exact percentiles and window
rates, the judgement of compared numbers, and run.py refusing to run
without a card."""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys

import numpy as np
import pytest

from glisp_bench.harness import stats, yardstick
from glisp_bench.harness.core import BENCH, ROOT, cells, judge, load_cell, load_module
from glisp_bench.harness.traffic import draws, schedule

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", cells())
def test_cell_files_found_by_name(cell):
    c = load_cell(cell)
    w = {x["name"]: x for x in BENCHMARK["workloads"]}[cell]
    assert c.config["name"] == w["config"]
    assert c.traffic["kind"] in ("train", "infer", "serve")
    assert hasattr(c.driver, "run")
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert set(c.limits) >= {"sample_faults", "sample_fill"}
    for lim in c.limits.values():
        assert lim["kind"] in ("max", "min")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in names


def test_benchmark_json_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["glisp_bench"] and b["command"][1].startswith("glisp_bench/")
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("glisp_bench/") and (ROOT / c["file"]).is_file()
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank")) and k != "hidden"
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_schedule_is_a_function_of_the_seed():
    mix = json.loads((BENCH / "traffic" / "serve-zipf.json").read_text())
    a = schedule(mix, 2**31 + 5, 4.0, 5000)
    b = schedule(mix, 2**31 + 5, 4.0, 5000)
    c = schedule(mix, 2**31 + 6, 4.0, 5000)
    assert np.array_equal(a.due, b.due)
    assert all(np.array_equal(x, y) for x, y in zip(a.vertices, b.vertices))
    assert not np.array_equal(a.due[:50], c.due[:50])
    assert np.all(np.diff(a.due) >= 0) and a.due[-1] < 4.0
    assert all(mix["min_vertices"] <= v.shape[0] <= mix["max_vertices"] for v in a.vertices)
    assert all(v.min() >= 0 and v.max() < 5000 for v in a.vertices)
    # every seed draws the same gaps and sizes, in its own order
    gaps_a, verts_a = draws(mix, 4000, 1, 5000)
    gaps_c, verts_c = draws(mix, 4000, 2, 5000)
    assert np.array_equal(np.sort(gaps_a), np.sort(gaps_c))
    assert not np.array_equal(gaps_a, gaps_c)
    assert sorted(v.shape[0] for v in verts_a) == sorted(v.shape[0] for v in verts_c)
    assert abs(4000 / gaps_a.sum() - mix["rate_per_s"]) / mix["rate_per_s"] < 0.05


def test_zipf_popularity_is_skewed():
    mix = json.loads((BENCH / "traffic" / "serve-zipf.json").read_text())
    s = schedule(mix, 3, 20.0, 5000)
    counts = np.bincount(np.concatenate(s.vertices), minlength=5000)
    top = np.sort(counts)[::-1]
    assert top[0] > 20 * max(1, np.median(counts))
    assert top[0] < 0.2 * counts.sum(), "no rank takes the clipped tail's mass"


@pytest.mark.parametrize("shape", [
    dict(edges=1024, segments=256, dim=128, valid_edges=1000, rows_read=700),
    dict(edges=65536, segments=4096, dim=64, valid_edges=60000, rows_read=30000, heads=4),
])
def test_frozen_op_counts_by_hand(shape):
    e, n, d = shape["edges"], shape["segments"], shape["dim"]
    ev, r, h = shape["valid_edges"], shape["rows_read"], shape.get("heads", 1)
    assert yardstick.op_flops_bytes("segment_spmm_ragged", shape) == (
        ev * d, ev * d * 4 + e * 4 + n * d * 4)
    assert yardstick.op_flops_bytes("gather_spmm_ragged", shape) == (
        ev * d, r * d * 4 + 2 * e * 4 + n * d * 4)
    assert yardstick.op_flops_bytes("gather_spmm_ragged_backward", shape) == (
        ev * d, r * d * 4 + 3 * e * 4 + n * d * 4)
    assert yardstick.op_flops_bytes("gat_softmax_aggregate", shape) == (
        ev * h * (2 * d + 3), ev * h * d * 4 + ev * h * 4 + e * 4 + n * h * d * 4)
    fl, by = yardstick.op_flops_bytes("gat_softmax_aggregate_backward", shape)
    assert fl == ev * h * (4 * d + 6)
    assert by == (ev * h * (4 + 4 * d) + 2 * n * h * d * 4 + 2 * n * h * 4 + e * 4
                  + e * h * (4 * d + 4))
    hw = yardstick.peaks("NVIDIA H100 80GB HBM3")
    fl, by = yardstick.op_flops_bytes("gather_spmm_ragged", shape)
    assert yardstick.bound_s("gather_spmm_ragged", shape, hw) == max(fl / 67e12, by / 3.35e12)


def test_unknown_card_and_op_raise():
    with pytest.raises(ValueError):
        yardstick.peaks("some other card")
    with pytest.raises(ValueError):
        yardstick.op_flops_bytes("flash_attention", {})


def test_step_flops_count_dense_three_times():
    dims, e = [128, 256, 256, 256], [1000, 300, 50]
    sage = yardstick.train_step_flops("sage", dims, 4, 172, 2000, e, 256)
    dense = sum(3 * 2.0 * 2000 * 2 * dims[k] * dims[k + 1] for k in range(3))
    head = 3 * 2.0 * 256 * 256 * 172
    agg = sum(e[k] * dims[k] for k in range(3)) + sum(e[k] * dims[k] for k in (1, 2))
    assert sage == pytest.approx(dense + head + agg, rel=1e-12)
    # the sum and the count (D = 1), then one product of the joined rows
    assert yardstick.slice_flops("sage", 128, 256, 4, 100, 900) == (
        900 * 128 + 900 + 2.0 * 100 * 256 * 256)


def test_exact_percentile_and_rates():
    lat = list(range(1, 101))
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert stats.percentile(lat, 50) == pytest.approx(50.5)
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    # a stall anywhere in the window lowers the rate: the count is over the
    # whole window's seconds, not a median of steps
    steady = [0.1] * 100
    stalled = [0.1] * 99 + [5.0]
    assert statistics.median(stalled) == statistics.median(steady)
    assert stats.rate(256 * 100, sum(stalled)) < 0.7 * stats.rate(256 * 100, sum(steady))
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)


def test_judge_needs_every_number_within_its_limit():
    limits = {"a": {"limit": 1.0, "kind": "max"}, "b": {"limit": 0.5, "kind": "min"}}
    ok, checks = judge({"a": 0.5, "b": 0.9}, limits)
    assert ok and checks["a"]["ok"] and checks["b"]["limit"] == 0.5
    assert not judge({"a": 1.5, "b": 0.9}, limits)[0]
    assert not judge({"a": 0.5, "b": 0.1}, limits)[0]
    assert not judge({"a": 0.5}, limits)[0], "a limit with no number"
    assert not judge({"a": 0.5, "b": 0.9, "c": 0.0}, limits)[0], "a number with no limit"


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "sage-papers100m.train",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_refuses_an_unknown_cell():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "no-such.cell", "--seed", "1",
         "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_answered_requests_are_timed_as_they_came():
    from types import SimpleNamespace

    from glisp_bench.harness.traffic import Schedule

    loop_cls = load_module(BENCH / "drivers" / "serve.py", "serve_driver").Loop
    sched = Schedule(np.array([0.0, 0.001]), [np.array([1]), np.array([2])])
    loop = loop_cls(None, sched, None, None, deadline_ms=100.0, keep=[0])
    ok = SimpleNamespace(status="ok", embeddings=np.zeros((1, 4)))
    loop._answer(0, ok, 0.005, 0.0)
    loop._answer(1, ok, 0.006, 0.0)
    assert loop.latency_ms == pytest.approx([5.0, 5.0])
    assert set(loop.embeddings) == {0}, "only the kept requests' answers are held"
    loop._answer(1, SimpleNamespace(status="timeout"), 0.006, 0.0)
    assert loop.latency_ms[1] == 100.0, "a failed request counts at no less than the deadline"
