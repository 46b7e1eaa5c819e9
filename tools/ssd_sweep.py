"""Choose the SSD-scan kernels' chunk length on the card.

    python3 tools/ssd_sweep.py [--lengths 64 128]

Builds ``csrc/ssd_scan.cu`` once per bf16 chunk length L
(``-DREPRO_SSD_CHUNK=L``; the builds in parallel) and times each at the
mamba2-130m prefill's call (B 4, S 2048, H 24, P 64, G 1, N 128, bf16;
float32 once, at its fixed L = 64): the whole call by CUDA-graph replay
with inputs rotated over four copies, as ``chip_smoke.py`` times it, and
each of the three kernels by ``torch.profiler``. Every build is first held
against ``ref.ssd_chunked_ref`` (``chip_smoke.SSD_TOL``) and against itself
run twice (bitwise). Prints the card's name and power limit and one JSON
line. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 2048, 24, 64, 1, 128)  # B, S, H, P, G, N of the mamba2-130m prefill


def build_lengths(lengths) -> dict:
    """One library per chunk length, compiled in parallel; {L: CDLL}."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for length in lengths:
        fd, out = tempfile.mkstemp(prefix=f"ssd_scan-L{length}-", suffix=".so",
                                   dir=build.BUILD_DIR)
        os.close(fd)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DREPRO_SSD_CHUNK={length}",
               f"-I{build.CSRC}", "-o", out, str(build.CSRC / "ssd_scan.cu")]
        procs[length] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for length, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ssd_scan.cu at L = {length}:\n{log}")
        libs[length] = build._bind(ctypes.CDLL(out), "ssd_scan")
    return libs


def inputs(dtype, seed: int = 0):
    b, s, h, p, g, n = SHAPE
    gen = torch.Generator("cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x, B, C = r(b, s, h, p).to(dtype), r(b, s, g, n).to(dtype), r(b, s, g, n).to(dtype)
    dt = torch.rand(b, s, h, generator=gen, device="cuda") * 0.5 + 0.01
    A = -torch.rand(h, generator=gen, device="cuda") - 0.1
    return x, dt * A, dt, B, C


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", type=int, nargs="+", default=[64, 128])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SSD_TOL, check_close, device_line, graph_ms, kernels_ms, rotating
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_chunked_ref

    card = device_line()
    print(card, flush=True)
    libs = build_lengths(args.lengths)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        x, a, dt, B, C = inputs(dtype)
        with torch.no_grad():
            want_y, want_st = ssd_chunked_ref(x, a, dt, B, C, chunk=128)
        for lib in list(libs.values())[: 1 if dtype == torch.float32 else None]:
            build._LIBS["ssd_scan"] = lib
            label = f"L={sk.kernel_chunk(dtype)} {dtype}"
            y, st = sk.ssd_scan_fused(x, a, dt, B, C)
            y2, st2 = sk.ssd_scan_fused(x, a, dt, B, C)
            err = max(check_close(f"ssd_scan y {label}", y, want_y, tol=SSD_TOL[dtype]),
                      check_close(f"ssd_scan state {label}", st, want_st,
                                  tol=SSD_TOL[torch.float32]))
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                raise RuntimeError(f"{label}: two runs differ")
            ys, fs = torch.empty_like(y), torch.empty_like(st)
            fn = rotating(lambda *t: sk.launch_ssd_scan(*t, None, ys, fs), x, a, dt, B, C)
            row = {"dtype": str(dtype), "L": sk.kernel_chunk(dtype), "max_abs_err": err,
                   "kernel_ms": graph_ms(fn, iters=5),
                   "by_kernel_ms": kernels_ms(fn, "ssd_scan_kernel_")}
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(card)
    print(json.dumps({"card": card, "shape": dict(zip("BSHPGN", SHAPE)), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
