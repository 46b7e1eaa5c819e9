"""Print the production-mesh dry run's results as a markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh single --out experiments/dryrun_torch
    python3 tools/dryrun_table.py experiments/dryrun_torch [--log dryrun.log]

One row per result file (``<arch>_<shape>_<mesh>.json``): per-device peak
and argument GiB, the roofline's dominant term and step bound, the
collective bytes per device by kind, and the trace's seconds. With
``--log``, the ``[dryrun] FAIL`` lines of the CLI's output follow as rows
with their error.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A",
         "collective-permute": "CP"}


def rows(out_dir: Path) -> list[str]:
    lines = []
    for path in sorted(out_dir.glob("*.json")):
        r = json.loads(path.read_text())
        mem, rf, coll = r["memory"], r["roofline"], r["collectives"]
        kinds = ", ".join(f"{KINDS[k]} {v / 2**30:.2f}" for k, v in coll["bytes"].items() if v)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{mem['peak_bytes_per_device'] / 2**30:.2f} | {mem['argument_bytes'] / 2**30:.2f} | "
            f"{rf['dominant'].removesuffix('_s')} | {rf['step_time_bound_s'] * 1e3:.1f} | "
            f"{coll['total_bytes'] / 2**30:.2f} ({kinds or '-'}) | {r['trace_s']} |")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--log", type=Path, help="the CLI's output, for its FAIL lines")
    args = ap.parse_args(argv)
    print("| arch | shape | mesh | peak GiB/dev | args GiB/dev | dominant | bound ms | "
          "collective GiB/dev (by kind) | trace s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for line in rows(args.out_dir):
        print(line)
    if args.log:
        for m in re.finditer(r"\[dryrun\] FAIL (\S+) × (\S+) × (\S+): (.*)", args.log.read_text()):
            print(f"| {m[1]} | {m[2]} | {m[3]} | failed: {m[4][:160]} |||||| |")


if __name__ == "__main__":
    main()
