"""Every cell (and the serving cell held out of BENCHMARK.json) at a tiny
size on the CPU: the program's run is correct
against the reference, and the control (the reference computed in TF32 in
the program's place) is not, by the cell's own limits."""
from __future__ import annotations

import pytest

from glisp_bench.harness.core import judge
from glisp_bench.tests.tiny import TINY_CONFIG, all_cells, get_cell, run_tiny


@pytest.mark.parametrize("cell", all_cells())
def test_program_matches_the_reference_and_the_control_does_not(cell, tmp_path):
    result, out = run_tiny(cell, tmp_path, control=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] < result["attempted"]
    if "serve_p95_ms" in result["metrics"]:
        # an answered request is timed as it came, never at the deadline
        assert result["metrics"]["serve_p95_ms"]["value"] < TINY_CONFIG["serve_deadline_ms"] / 10
    assert out.numbers["sample_faults"] == 0
    e2e = {m for m in result["metrics"]}
    assert "setup_s" in e2e and len(e2e) == 2
    limits = {k: v for k, v in get_cell(cell).limits.items() if k in out.control}
    ok, checks = judge(out.control, limits)
    assert not ok, f"the control passes every limit: {checks}"

