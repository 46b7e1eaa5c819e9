"""Look for races in the dense call forms' radix sort.

    python3 tools/sanitize_sort.py [--out build/sanitize_sort.log]
    python3 tools/sanitize_sort.py --jitter 25
    python3 tools/sanitize_sort.py --jitter 5 --drop 2

The first form runs this file's workload (``--inner``) once under each of
NVIDIA's compute-sanitizer tools memcheck, racecheck (shared-memory
hazards) and synccheck, and prints each tool's exit code and error
summary, with the full output in ``--out``. memcheck runs with PyTorch's
caching allocator off, so that a read past a tensor leaves its
allocation. It exits non-zero if a tool reports an error, the workload
fails, or the sanitizer reports "Device not supported" (the tool then
checks nothing, and the workload's first CUDA call fails under it).

The second form needs no sanitizer: it runs the workload 25 times with
the sort built with ``-DREPRO_SORT_JITTER``, where every thread sleeps a
random 0-1023 ns wherever data passes between lanes, warps or blocks
(``csrc/segment_sort.cu``), so that a missing barrier gives a wrong
permutation instead of hiding behind a lucky schedule. With ``--drop K``
as well, the jittered sort is built without the scatter's barrier K
(``-DREPRO_SORT_DROP=K``, ``csrc/segment_sort.cu::scatter_barrier``): a
mutant the workload must catch. It then exits 0 when the mutant gave a
wrong permutation or a device error, and 1 when every round passed.

The workload: the stable radix sort of ``csrc/segment_sort.cu`` on the
card tests' hard cases (uniform ids with padding and ids >= n, all
padding, one hot key, power-law ids; E around the 4096-key tile, 50,000
and the stand-in graph's 1.05 M; n from 255 to 150,000, one to three
passes), each sorted twice and held bitwise against
``torch.sort(stable=True)``; then ``segment_spmm`` and ``gather_spmm`` on
shuffled ids, held bitwise against the sorted-input kernels. Needs a CUDA
card and the CUDA toolkit (``$CUDA_HOME/bin``).
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("memcheck", "racecheck", "synccheck")
SORT_CASES = [(4095, "uniform"), (4097, "uniform"), (50000, "all padding"),
              (50000, "one hot key"), (50000, "power law"), (1050000, "power law")]
SEGMENTS = (255, 256, 65535, 150000)


def workload() -> int:
    """The sorts and the dense forms, each checked; returns the sorts run
    (the dense forms sort twice more)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import fused_gnn

    def ids(e, n, kind, seed):
        rng = np.random.default_rng(seed)
        if kind == "uniform":
            a = rng.integers(-1, n + 2, e)
        elif kind == "all padding":
            a = np.full(e, -1)
        elif kind == "one hot key":
            a = np.where(rng.random(e) < 0.9, n // 2, rng.integers(-1, n + 2, e))
        else:
            a = np.minimum(rng.zipf(1.3, e) - 1, n + 1)
        return torch.as_tensor(a.astype(np.int32), device="cuda")

    sorts = 0
    for n in SEGMENTS:
        for e, kind in SORT_CASES:
            seg = ids(e, n, kind, n + e)
            key = seg.long().masked_fill((seg < 0) | (seg >= n), n)
            want = torch.sort(key, stable=True).indices.to(torch.int32)
            for _ in range(2):
                if not torch.equal(fused_gnn.segment_sort(seg, n), want):
                    raise SystemExit(f"segment_sort n={n} E={e} {kind}: not torch.sort's order")
                sorts += 1
    rng = np.random.default_rng(0)
    e, f, n, d = 20000, 5000, 70000, 128
    seg = torch.as_tensor(np.where(rng.random(e) < 0.1, -1, rng.integers(0, n + 3, e))
                          .astype(np.int32), device="cuda")
    idx = torch.as_tensor(np.where(rng.random(e) < 0.05, -1, rng.integers(0, f, e))
                          .astype(np.int32), device="cuda")
    feats = torch.as_tensor(rng.standard_normal((f, d), dtype=np.float32), device="cuda")
    msg = torch.as_tensor(rng.standard_normal((e, d), dtype=np.float32), device="cuda")
    order = torch.sort(seg.long().masked_fill((seg < 0) | (seg >= n), n), stable=True).indices
    s_seg = seg[order].contiguous()
    with torch.no_grad():
        checks = {
            "segment_spmm": (fused_gnn.segment_spmm(msg, seg, n),
                             fused_gnn.segment_spmm_ragged(msg[order].contiguous(), s_seg, n)),
            "gather_spmm": (fused_gnn.gather_spmm(feats, idx, seg, n),
                            fused_gnn.gather_spmm_ragged(feats, idx[order].contiguous(),
                                                         s_seg, n)),
        }
    for name, (got, want) in checks.items():
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: not the sorted-input kernel's bits")
    torch.cuda.synchronize()
    return sorts + 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inner", action="store_true", help="run the workload only")
    ap.add_argument("--out", default=str(ROOT / "build" / "sanitize_sort.log"))
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds per tool")
    ap.add_argument("--jitter", type=int, default=0, metavar="ROUNDS",
                    help="run the workload ROUNDS times on the jittered sort instead")
    ap.add_argument("--drop", type=int, default=0, metavar="K",
                    help="with --jitter: leave the scatter's barrier K out (a mutant)")
    args = ap.parse_args()
    if args.inner:
        workload()
        print("workload ok", flush=True)
        return 0
    if args.jitter:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build

        flags = ["-DREPRO_SORT_JITTER"] + ([f"-DREPRO_SORT_DROP={args.drop}"] if args.drop else [])
        build.load_variant("segment_sort", *flags)
        if args.drop:
            for r in range(args.jitter):
                try:
                    workload()
                except (SystemExit, RuntimeError) as exc:
                    print(f"mutant without barrier {args.drop}: caught in round {r + 1}: {exc}",
                          flush=True)
                    return 0
            print(f"mutant without barrier {args.drop}: not caught in {args.jitter} rounds",
                  flush=True)
            return 1
        sorts = sum(workload() for _ in range(args.jitter))
        print(f"jitter: {args.jitter} rounds, {sorts} sorts, every permutation and "
              "dense-form sum bitwise as expected", flush=True)
        return 0
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    san = shutil.which("compute-sanitizer") or os.path.join(cuda_home, "bin", "compute-sanitizer")
    # build the kernels first, outside the sanitizer
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
                    "from repro_torch.kernels import build; build.build_all()"],
                   cwd=ROOT, check=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    bad = 0
    with out.open("w") as log:
        for tool in TOOLS:
            env = dict(os.environ)
            if tool == "memcheck":
                env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
            cmd = [san, "--tool", tool, "--error-exitcode", "99",
                   sys.executable, str(Path(__file__).resolve()), "--inner"]
            try:
                # a session of its own, so that a timeout kills the sanitizer's child too
                proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True,
                                        start_new_session=True)
            except OSError as exc:
                code, text = "not run", str(exc)
            else:
                try:
                    text, _ = proc.communicate(timeout=args.timeout)
                    code = proc.returncode
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    text, _ = proc.communicate()
                    code = "timeout"
            log.write(f"===== {tool}: exit {code}\n{text}\n")
            if "Device not supported" in text:
                # the tool attaches to nothing, and the workload's first CUDA call fails
                print(f"{tool}: not run: compute-sanitizer does not support this device",
                      flush=True)
                bad += 1
                continue
            summary = re.findall(r"ERROR SUMMARY: .*|RACECHECK SUMMARY: .*|workload ok", text)
            tail = " | ".join(summary) or (text.strip().splitlines() or ["(no output)"])[-1]
            print(f"{tool}: exit {code}: {tail}", flush=True)
            bad += code != 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
