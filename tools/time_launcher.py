"""Time ``chip_smoke.py``'s launcher phase at other graph scales.

    python3 tools/time_launcher.py [--scales 1.0 0.5]

Builds the port's kernels, then for each scale runs ``chip_smoke.py``'s
``launcher_train`` (``python -m repro_torch.launch.train gnn --config
<config> --scale <scale>`` in process, one epoch, on the card, launches
checked against the steps) for ``gcn-products`` and ``hgt-relnet``, and
prints the card's name and power limit and one JSON line: per scale and
config the phase's wall s (dataset, partition, training, evaluation),
steps, steady step wall ms, step device ms and the card's idle share. It
is how ``chip_smoke.py``'s ``LAUNCH_SCALE`` was chosen. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=float, nargs="+", default=[1.0, 0.5])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("time_launcher: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    chip_smoke.build_kernels()
    rows = []
    for scale in args.scales:
        chip_smoke.LAUNCH_SCALE = scale
        for config in chip_smoke.LAUNCH_PER_STEP:
            t0 = time.perf_counter()
            info = chip_smoke.launcher_train(config, collections.Counter())
            rows.append({"scale": scale, "config": config,
                         "phase_s": time.perf_counter() - t0,
                         **{k: info[k] for k in ("vertices", "steps",
                                                 "step_wall_ms_steady_median",
                                                 "step_device_ms_median",
                                                 "device_idle_share_steady")}})
    card = chip_smoke.device_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
