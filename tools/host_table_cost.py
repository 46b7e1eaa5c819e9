"""The host cost of the page-locked copy of the feature matrix that a CUDA
batch consumer gathers feature rows from.

    python3 tools/host_table_cost.py [--gib 0.0768 1 4 16]

For each size, a float32 matrix of 128 columns (0.0768 GiB is the
benchmark's 150,000 rows) is made, then ``batch_finish.HostTable`` of it:
prints one JSON line a size with the seconds to copy it, to page-lock and
map the copy (``host_register``) and to free it (``close``), the process's
resident and pinned memory (``VmRSS``, ``VmPin`` of ``/proc/self/status``)
with the matrix alone, with the copy and after ``close``, and one
``table_rows`` call over 35,840 of its rows to show the card reads it. The
last line gives the host's memory and the largest matrix
``api/pipeline.py``'s ``PINNED_TABLE_SHARE`` lets a pipeline ship. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DIM = 128


def status_kib(key: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return 0


def memory() -> dict:
    return {"rss_gib": status_kib("VmRSS") / 2**20, "pinned_gib": status_kib("VmPin") / 2**20}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gib", type=float, nargs="+", default=[0.0768, 1.0, 4.0, 16.0])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("host_table_cost: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.api import pipeline
    from repro_torch.kernels import batch_finish, build

    build.library("batch_finish")
    torch.cuda.init()
    for gib in args.gib:
        rows = int(gib * 2**30 / (DIM * 4))
        feats = np.ones((rows, DIM), np.float32)
        alone = memory()
        t0 = time.perf_counter()
        copy = np.array(feats, dtype=np.float32, order="C")
        copy_s = time.perf_counter() - t0
        del copy
        t0 = time.perf_counter()
        table = batch_finish.HostTable(feats)
        made_s = time.perf_counter() - t0
        held = memory()
        ids = torch.arange(0, rows, max(1, rows // 35840), device="cuda")[:35840].contiguous()
        got = batch_finish.table_rows(table.tensor, ids)
        torch.cuda.synchronize()
        read_ok = bool((got == 1.0).all())
        t0 = time.perf_counter()
        table.close()
        close_s = time.perf_counter() - t0
        print(json.dumps({"gib": rows * DIM * 4 / 2**30, "rows": rows, "copy_s": copy_s,
                          "host_table_s": made_s, "register_s": made_s - copy_s,
                          "close_s": close_s, "matrix_alone": alone, "with_copy": held,
                          "after_close": memory(), "card_read_ok": read_ok}), flush=True)
        del feats, table
    host = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    print(json.dumps({"host_gib": host / 2**30, "pinned_table_share": pipeline.PINNED_TABLE_SHARE,
                      "largest_shipped_matrix_gib": pipeline.PINNED_TABLE_SHARE * host / 2**30}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
