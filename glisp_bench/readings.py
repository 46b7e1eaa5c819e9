"""The readings a cell's limits are set from: for each seed, the program's
compared numbers and the control's (the reference computed in TF32 in the
program's place), optionally with a fault planted in the program, at the
cell's own size, in one process:

    python3 glisp_bench/readings.py --workload <cell> --seconds <s> \\
        [--fault <name>] [--witness] --seeds <n> [<n> ...]

One JSON line a seed on standard output. The benchmark's own runs
(``run.py``) read no control and plant no fault. It needs a CUDA card,
as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--witness", action="store_true",
                   help="training cells: also a float32 reference's gaps (on stderr)")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from glisp_bench.harness.core import execute, load_cell
    from glisp_bench.harness.faults import plant

    import torch

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        cell = load_cell(args.workload, ROOT)
        t0 = time.perf_counter()
        with plant(args.fault):
            result, out = execute(cell, seed, args.seconds, False, "cuda:0", t0,
                                  control=args.fault is None, witness=args.witness)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": result["correct"], "numbers": out.numbers,
                          "control": out.control, "metrics": result["metrics"],
                          "attempted": out.attempted, "failed": out.failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
