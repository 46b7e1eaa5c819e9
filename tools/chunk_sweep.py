"""Choose the CSR sum kernel's chunk length L and its build cut on the card.

    python3 tools/chunk_sweep.py [--lengths 16 32 64 128 256]

Times the CSR kernel alone (CUDA-graph replay, inputs rotated over four
copies, as ``chip_smoke.py`` times it) on both of its builds (the lean one,
one edge at a time, and the batched one, ``csrc/segment_sum.cu``), the
build forced through the library's entry, and prints the wrapper's pick
(``fused_gnn._lean``) beside each pair. Every result is first held bitwise
against ``ref.chunked_segment_sum_ref``.

* The cut between the builds, on this checkout's L: 150,000 rows of
  Poisson(k) edges for k = 1, 2, 3, 4, 5, 6, 8, sorted, with uniform
  source rows, float32 and bf16, D 128 and 256, the gather form
  (``gather_segment_sum``) and the plain one (``segment_sum``).
* L: ``csrc/segment_sum.cu`` built once per chunk length
  (``-DREPRO_SUM_CHUNK=L``) and timed at the calls whose cost L moves:
  ``segment_spmm`` and ``gather_spmm`` (rows 6 and 4) on the
  ``ogbn-paper`` stand-in's 1.05 M edges shuffled and stable-sorted (seg =
  dst, idx = src, D 128; in-degrees up to 6,447), float32 and bf16: the
  kernel over the sorted keys with the permutation, or ``idx[perm]``; and
  two sampled layers, whose rows are all shorter than any L: 4,096 rows
  of 1-15 edges, D 256, and 38,144 rows of 1.4 edges on average
  (Poisson), D 128, the shapes of the training path's largest sum and
  gather, float32.

Also times the sort of the stand-in's ids against ``torch.sort(stable=True)``
of their keys. Prints the card's name and power limit and one JSON line.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CUT_EDGES = (1, 2, 3, 4, 5, 6, 8)  # mean edges a row of the cut's inputs
CUT_ROWS = 150000


def launch(src, ix, sg, index, out, lean: bool) -> None:
    """The wrappers' launch of the sum kernel with the build forced: the
    gather form over ``src[ix]``, or the plain form over ``src`` when ``ix``
    is None."""
    from repro_torch.kernels import build, fused_gnn

    n, d = out.shape
    e = sg.shape[0]
    vec, tpr = fused_gnn._vec_tpr(d, src, out)
    partial = fused_gnn._partials(e, d, out.device)
    lib = build.library("segment_sum")
    rest = (index.data_ptr(), index.shape[0], n, d, fused_gnn._DTYPE_CODE[src.dtype], vec, tpr,
            int(lean), partial.data_ptr(), partial.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if ix is None:
        code = lib.segment_sum(src.data_ptr(), sg.data_ptr(), e, *rest)
    else:
        code = lib.gather_segment_sum(src.data_ptr(), ix.data_ptr(), sg.data_ptr(), e, *rest)
    build.check(code, "segment_sum")


def time_builds(src, ix, sg, rows: int, chunk: int) -> dict:
    """Both builds' kernel time on one call, after holding each to the
    order model's bits; with the wrapper's pick."""
    from chip_smoke import graph_ms, rotating
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import chunked_segment_sum_ref

    index = fused_gnn.segment_index(sg, rows)
    out = torch.empty((rows, src.shape[1]), dtype=src.dtype, device="cuda")
    if ix is None:
        want = chunked_segment_sum_ref(src, sg, rows, chunk=chunk)
    else:
        want = chunked_segment_sum_ref(src[ix.clamp_min(0).long()], sg, rows, ix >= 0,
                                       chunk=chunk)
    want = want.to(src.dtype)
    bits = torch.int16 if src.element_size() == 2 else torch.int32
    row = {"picked": "lean" if fused_gnn._lean(sg.shape[0], rows, src.dtype) else "batched"}
    for label, lean in (("lean", True), ("batched", False)):
        launch(src, ix, sg, index, out, lean)
        if not torch.equal(out.view(bits), want.view(bits)):
            raise SystemExit(f"L={chunk} {label}: not the order model's bits")
        row[label] = graph_ms(rotating(launch, src, ix, sg, index, out, lean))
    return row


def cut_sweep(rng) -> dict:
    """Both builds at CUT_ROWS rows of Poisson(k) edges, k in CUT_EDGES."""
    from repro_torch.kernels.ref import SUM_CHUNK

    times: dict = {}
    for k in CUT_EDGES:
        lens = rng.poisson(k, CUT_ROWS)
        seg = torch.as_tensor(np.repeat(np.arange(CUT_ROWS), lens).astype(np.int32),
                              device="cuda")
        e = int(seg.shape[0])
        idx = torch.as_tensor(rng.integers(0, CUT_ROWS, e).astype(np.int32), device="cuda")
        for d in (128, 256):
            feats = torch.as_tensor(rng.standard_normal((CUT_ROWS, d)).astype(np.float32),
                                    device="cuda")
            msg = feats[idx.long()].contiguous()
            for dtype in (torch.float32, torch.bfloat16):
                name = f"k={k} D={d} {str(dtype)[6:]}"
                times[name] = {
                    "edges_per_row": e / CUT_ROWS,
                    "gather": time_builds(feats.to(dtype), idx, seg, CUT_ROWS, SUM_CHUNK),
                    "plain": time_builds(msg.to(dtype), None, seg, CUT_ROWS, SUM_CHUNK),
                }
                print(f"{name}: " + json.dumps(times[name]), flush=True)
            del feats, msg
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", type=int, nargs="*", default=[16, 32, 64, 128, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chunk_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import DENSE_WIDTH, dense_edges, graph_ms, rotating, time_ms
    from repro_torch.graph import named_dataset
    from repro_torch.kernels import build, fused_gnn

    rng = np.random.default_rng(3)
    with torch.no_grad():
        cut = cut_sweep(rng)
    g = named_dataset("ogbn-paper", feat_dim=128, num_classes=16, seed=0, scale=1.0)
    n = g.num_vertices
    idx, seg = dense_edges(g, 4)
    feats = torch.as_tensor(rng.standard_normal((n, DENSE_WIDTH)).astype(np.float32),
                            device="cuda")
    msg = feats[idx.long()].contiguous()
    keys, perm, gidx = fused_gnn._sort_on_card(seg, n, idx)
    hot = int(torch.bincount(keys.long(), minlength=n + 1)[:n].max())
    # a sampled layer: 4,096 destination rows of 1-15 edges, sorted
    lens = rng.integers(1, 16, 4096)
    s_seg = torch.as_tensor(np.repeat(np.arange(4096), lens).astype(np.int32), device="cuda")
    s_feats = torch.as_tensor(rng.standard_normal((40000, 256)).astype(np.float32),
                              device="cuda")
    s_idx = torch.as_tensor(rng.integers(0, 40000, s_seg.shape[0]).astype(np.int32),
                            device="cuda")
    # a training gather: 38,144 rows of 1.4 edges on average
    t_lens = np.minimum(rng.poisson(1.37, 38144), 15)
    t_seg = torch.as_tensor(np.repeat(np.arange(38144), t_lens).astype(np.int32), device="cuda")
    t_feats = s_feats[:38144, :128].contiguous()
    t_idx = torch.as_tensor(rng.integers(0, 38144, t_seg.shape[0]).astype(np.int32),
                            device="cuda")
    calls = {
        "segment_spmm f32": (msg, perm, keys, n),
        "gather_spmm f32": (feats, gidx, keys, n),
        "segment_spmm bf16": (msg.bfloat16(), perm, keys, n),
        "gather_spmm bf16": (feats.bfloat16(), gidx, keys, n),
        "sampled gather f32": (s_feats, s_idx, s_seg, 4096),
        "training gather f32": (t_feats, t_idx, t_seg, 38144),
    }
    times: dict = {}
    with torch.no_grad():
        for length in args.lengths:
            build.load_variant("segment_sum", f"-DREPRO_SUM_CHUNK={length}")
            regs = [line.split(":", 1)[1].strip() for line in
                    build.ptxas_log()["segment_sum"].splitlines() if "registers" in line]
            row = {"registers": regs}
            for name, (src, ix, sg, rows) in calls.items():
                row[name] = time_builds(src, ix, sg, rows, length)
            times[length] = row
            print(f"L={length}: " + json.dumps(row), flush=True)
    key = seg.masked_fill((seg < 0) | (seg >= n), n)
    sort_ms = {"segment_sort graph": graph_ms(rotating(fused_gnn.segment_sort, seg, n)),
               "segment_sort eager": time_ms(rotating(fused_gnn.segment_sort, seg, n)),
               "torch.sort stable eager": time_ms(rotating(lambda k: torch.sort(k, stable=True),
                                                           key))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"cut_kernel_ms": cut, "chunk_sweep_kernel_ms": times, "sort_ms": sort_ms,
                      "edges": int(seg.shape[0]), "segments": n, "hottest_row": hot}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
