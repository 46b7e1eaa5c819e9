"""What the benchmark may load: nothing of JAX or of the JAX package
``repro`` anywhere under ``glisp_bench/`` (top-level names compared whole:
``repro_torch`` begins with ``repro``), nothing of the program in the
reference, and nothing read from ``benchmarks/``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from glisp_bench.harness.core import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set:
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_benchmarks_dir(path):
    assert not imported(path) & FORBIDDEN
    if path.name != "test_glisp_bench_imports.py":  # which names the directory
        assert "benchmarks" not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "math", "numpy", "torch", "glisp_bench"}, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "glisp_bench"):
            assert node.module.startswith("glisp_bench.reference"), node.module


def test_import_graph_loads_no_jax():
    """Every module of the harness, its drivers and metric readers, with the
    program they reach, loaded in a fresh process."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from glisp_bench.harness import core, calls, faults, passes, program, trace, timers
from glisp_bench.harness.core import load_cell, cells, load_module
for cell in cells():
    load_cell(cell)
for p in sorted(core.BENCH.glob("metrics/*.py")):
    load_module(p, "m_" + p.stem.replace(".", "_"))
import glisp_bench.run, glisp_bench.readings, glisp_bench.sweep
import repro_torch.api, repro_torch.train.loop, repro_torch.serve.server
import repro_torch.core.inference.engine, repro_torch.models.gnn
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "glisp_bench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
