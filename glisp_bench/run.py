"""The benchmark of the PyTorch and CUDA port of GLISP, one run of one cell:

    python3 glisp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the cell in ``BENCHMARK.json`` and
its files by name (``harness/core.py``), refuses to run without as many
CUDA cards as the cell asks for, runs the cell's driver on the first card,
and prints one JSON object as the last line of standard output: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, with the device trace's ``busy_s``, ``window_s`` and
``breakdown``), whether the timed path's output matched the reference
(``correct``), and under ``checks`` each compared number beside its limit,
which the last lines of standard error repeat.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        print(f"--seed must be >= 0, got {args.seed}", file=sys.stderr)
        return 2
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
    from glisp_bench.harness.core import execute, load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, _ = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that measured: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        op = "<=" if c["kind"] == "max" else ">="
        print(f"check {name} {c['value']} {op} {c['limit']} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
