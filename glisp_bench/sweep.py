"""The serving knee: one serving cell's traffic at each of several fixed
rates, set up once, one window a rate, in one process on the card:

    python3 glisp_bench/sweep.py --workload <serve cell> --seed <n> \\
        --seconds <s> --rates <r> [<r> ...]

One JSON line a rate: requests, failed, exact p50 / p95 / p99 of the
latency from due to answered, the generator's lateness, the most requests
outstanding at once, and the median latency of the window's last third
over its first third (above 1: a backlog that grows). The knee is the
highest rate whose p95 stays within the configuration's deadline with no
request failed and no growing backlog; a serving mix runs at a fixed
share of it. The benchmark's own runs (``run.py``) do not sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from glisp_bench.harness import inputs, program
    from glisp_bench.harness.core import load_cell
    from glisp_bench.harness.passes import SampleLog, one_pass, workdir
    from glisp_bench.harness.timers import Spans
    from glisp_bench.harness.traffic import schedule

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload, ROOT)
    loop_cls = cell.driver.Loop
    cfg, mix, dev = cell.config, dict(cell.traffic), "cuda:0"
    arrays = inputs.make_graph(cfg)
    n = arrays["num_vertices"]
    system = program.build_system(cfg, arrays, args.seed)
    model = program.make_model(cfg, inputs.make_weights(cfg, args.seed, dev), dev)
    fns = [model.embed_layer_fn(k) for k in range(cfg["num_layers"])]
    log = SampleLog(system.service)
    try:
        one_pass(system, fns, cfg, workdir(cell.name), dev, torch.cuda.synchronize)
        server = system.server()
        deadline = cfg["serve_deadline_ms"]
        for i, rate in enumerate(args.rates):
            mix["rate_per_s"] = rate
            loop_cls(server, schedule(mix, args.seed, mix["warmup_seconds"], n, stream=10 + i),
                     log, Spans(), deadline).run()
            loop = loop_cls(server, schedule(mix, args.seed, args.seconds, n, stream=100 + i),
                            log, Spans(), deadline)
            t0 = time.monotonic()
            loop.run()
            wall = time.monotonic() - t0
            lat = loop.latency_ms
            third = max(1, len(lat) // 3)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat), "wall_s": wall,
                "failed": sum(s != "ok" for s in loop.status),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "late_p99_ms": float(np.percentile(loop.late_s, 99) * 1e3),
                "max_outstanding": loop.max_pending,
                "trend": float(np.median(lat[-third:]) / np.median(lat[:third])),
            }), flush=True)
    finally:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
