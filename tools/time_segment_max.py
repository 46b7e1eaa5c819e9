"""Time builds of the segment-max kernel side by side on one card.

    python3 tools/time_segment_max.py \
        --lib parent=build/parent/src/repro_torch/kernels/csrc/segment_max.cu \
        [--lib change=src/repro_torch/kernels/csrc/segment_max.cu] \
        [--lib variant=build/variant/segment_max.cu]

Each ``--lib LABEL=SOURCE`` is compiled with ``nvcc`` (the port's flags
and the source's own directory on the include path), all in parallel,
into ``build/segment_max_tool/``, and loaded with ``ctypes``. Every build
must export the C entry ``segment_max(x, seg, E, n, dtype, keys, out,
stream)`` (``keys`` a 32-bit scratch of n words rounded up to a multiple
of 32, which the call clears itself). Without ``--lib`` the tool times
this checkout's source alone. To try a variant of the design, edit a copy
of the source in a directory beside a copy of ``common.cuh`` (under
``build/``) and pass the copy.

Inputs (n = 150,000 segments, the ``ogbn-paper`` stand-in's vertices;
made with numpy from fixed seeds):

* ``path`` / ``path_bf16``: the stand-in graph's 1.05 M destination ids
  shuffled, 10% padding, 1% ids >= n (``chip_smoke.py``'s segment-max
  call; in-degrees up to 6,447);
* ``uniform``: as many ids drawn uniformly over the n segments, with the
  same padding and out-of-range shares;
* ``single``: every edge in segment 0;
* ``sorted``: the path's ids in ascending order and x ascending within
  each segment, which defeats a skip of atomics that do not raise the
  stored key.

For each input and build: the result held bitwise against
``ref.segment_max_ref``; the call's device time by CUDA-graph replay
over four rotating input copies (``ms``); and each kernel's (and
memset's) device time from ``torch.profiler`` (``by_kernel``). The
builds run in the order given, then again in reverse (parent, change,
change, parent), so a drift of the card shows. Prints the card's name
and power limit and one JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "segment_max_tool"
CHANGE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "segment_max.cu"


def compile_all(libs: dict) -> dict:
    """nvcc for every build at once; returns ``{label: ctypes entry}`` of
    the builds that compiled (a failed one is reported and left out)."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in libs.items():
        out = OUT / f"{label}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{src.parent}", "-o", str(out), str(src)]
        procs[label] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    entries = {}
    for label, (out, proc) in procs.items():
        log, _ = proc.communicate()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {label}: exit {proc.returncode}; " + " | ".join(regs), flush=True)
        if proc.returncode != 0:
            print(f"nvcc failed for {label}; it is left out:\n{log}", flush=True)
            continue
        fn = ctypes.CDLL(str(out)).segment_max
        p, c = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, c, c, c, p, p, p]
        fn.restype = c
        entries[label] = fn
    return entries


def inputs(n: int) -> dict:
    """The named inputs, on the card: ``{name: (x, seg)}``."""
    from chip_smoke import max_inputs
    from repro_torch.graph import named_dataset

    g = named_dataset("ogbn-paper", feat_dim=128, num_classes=16, seed=0, scale=1.0)
    assert g.num_vertices == n, g.num_vertices
    e = int(g.num_edges)
    x, seg = max_inputs(g.dst, n, 1, torch.float32)
    out = {"path": (x, seg), "path_bf16": max_inputs(g.dst, n, 1, torch.bfloat16)}
    rng = np.random.default_rng(3)
    out["uniform"] = max_inputs(rng.integers(0, n, e), n, 4, torch.float32)
    out["single"] = max_inputs(np.zeros(e, np.int64), n, 5, torch.float32, pad=0.0, over=0.0)
    ids = np.sort(np.asarray(g.dst)).astype(np.int32)
    xs = np.random.default_rng(6).standard_normal(e).astype(np.float32)
    order = np.lexsort((xs, ids))  # by segment, x ascending within it
    out["sorted"] = (torch.as_tensor(xs[order], device="cuda"),
                     torch.as_tensor(ids[order], device="cuda"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", action="append", default=[], metavar="LABEL=SOURCE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_segment_max: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bits, device_line, graph_ms, kernel_ms_by_name, rotating
    from repro_torch.kernels.ref import segment_max_ref

    specs = args.lib or [f"change={CHANGE}"]
    libs = {}
    for spec in specs:
        label, _, src = spec.partition("=")
        libs[label] = Path(src).resolve()
    entries = compile_all(libs)
    if len(entries) < len(libs):
        print("time_segment_max: some builds failed; timing the others", file=sys.stderr)
    n = 150_000
    data = inputs(n)
    code = {torch.float32: 0, torch.bfloat16: 1}
    keys = torch.empty(-(-n // 32) * 32, dtype=torch.int32, device="cuda")
    results: dict = {label: {} for label in entries}

    def call(fn, x, seg, out):
        err = fn(x.data_ptr(), seg.data_ptr(), seg.shape[0], n, code[x.dtype],
                 keys.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"segment_max launch failed with cudaError_t {err}")

    order = list(entries) + list(reversed(entries))
    for name, (x, seg) in data.items():
        want = segment_max_ref(x, seg, n)
        for turn, label in enumerate(order):
            fn = entries[label]
            out = torch.empty(n, dtype=x.dtype, device="cuda")
            call(fn, x, seg, out)
            torch.cuda.synchronize()
            if not torch.equal(bits(out), bits(want)):
                raise RuntimeError(f"{label} on {name}: not bitwise equal to segment_max_ref")
            ms = graph_ms(rotating(lambda a, b, o, f=fn: call(f, a, b, o), x, seg, out))
            row = results[label].setdefault(name, {"ms": []})
            row["ms"].append(ms)
            if turn < len(entries):
                row["by_kernel"] = kernel_ms_by_name(
                    rotating(lambda a, b, o, f=fn: call(f, a, b, o), x, seg, out))
            print(f"  {name} {label}: ms {ms:.5f}", flush=True)
    card = device_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "n": n,
                      "edges": {k: int(v[1].shape[0]) for k, v in data.items()},
                      "failed_builds": sorted(set(libs) - set(entries)),
                      "results": results}), flush=True)
    return 0 if len(entries) == len(libs) else 1


if __name__ == "__main__":
    sys.exit(main())
