"""The comparison catches faults planted in the program underneath a run
at a tiny size on the CPU: each fault a cell can have makes ``correct``
false (the exchange between chips is not one: every cell has one card)."""
from __future__ import annotations

import pytest

from glisp_bench.harness.faults import plant
from glisp_bench.tests.tiny import run_tiny

CASES = [
    ("sage-papers100m.train", "frozen_step"),
    ("sage-papers100m.train", "half_batch"),
    ("sage-papers100m.train", "altered_sample"),
    ("gat-papers100m.train", "thin_sample"),
    ("gat-papers100m.infer", "half_rows"),
    ("gat-papers100m.infer", "altered_answer"),
    ("gat-papers100m.infer", "thin_sample"),
    ("sage-papers100m.serve", "altered_answer"),
    ("sage-papers100m.serve", "thin_sample"),
]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault, tmp_path):
    with plant(fault):
        result, out = run_tiny(cell, tmp_path)
    assert not result["correct"], (fault, out.numbers)


def test_unknown_fault_raises():
    with pytest.raises(ValueError):
        with plant("no such fault"):
            pass
