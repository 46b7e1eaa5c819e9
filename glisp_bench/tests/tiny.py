"""A cell cut to a size a CPU test run can hold: the program's CPU path
(plain versions of the kernels) against the reference."""
from __future__ import annotations

import time

import json

from glisp_bench.harness.core import BENCH, Cell, cells, execute, load_cell, load_module

# the deadline is the CPU's: test workers share the host's cores
TINY_CONFIG = dict(num_vertices=3000, hidden=32, feat_dim=16, num_classes=8, num_parts=4,
                   batch_size=64, infer_batch_size=512, serve_deadline_ms=10_000.0)
TINY_TRAFFIC = dict(warmup_steps=2, warmup_seconds=0.3, rate_per_s=50.0, profile_steps=2)


SERVE = "sage-papers100m.serve"


def serve_cell() -> Cell:
    """The serving cell, held out of BENCHMARK.json until its tail reads
    steadily enough for a bound: the same files, found by name."""
    return Cell(
        SERVE, 1, json.loads((BENCH / "configs" / "sage-papers100m.json").read_text()),
        json.loads((BENCH / "traffic" / "serve-zipf.json").read_text()),
        json.loads((BENCH / "limits" / f"{SERVE}.json").read_text()),
        [{"name": "serve_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
        [{"name": m, "unit": "%"} for m in ("serve_occupancy.serve", "serve_cache_hit.serve",
                                            "device_idle_share.serve")],
        load_module(BENCH / "drivers" / "serve.py", "glisp_bench_driver_serve"))


def all_cells() -> list:
    """The benchmark's cells and the held-out serving cell."""
    return cells() + [SERVE]


def get_cell(name: str) -> Cell:
    return serve_cell() if name == SERVE else load_cell(name)


def run_tiny(cell_name: str, workdir, seed: int = 2**31 + 77, seconds: float = 0.3,
             control=False):
    """One run of ``cell_name`` cut to the tiny size, its stores under
    ``workdir`` (each test its own: tests run side by side)."""
    import os
    from unittest import mock

    cell = get_cell(cell_name)
    cell.config.update(TINY_CONFIG)
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in cell.traffic})
    with mock.patch.dict(os.environ, {"TMPDIR": str(workdir)}):
        return execute(cell, seed, seconds, False, "cpu", time.perf_counter(), control=control)
