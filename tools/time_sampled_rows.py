"""Time the sampled paths' kernel calls on one tree's kernels.

    python3 chip_smoke.py --save-calls build/sampled_calls.pt
    python3 tools/time_sampled_rows.py --calls build/sampled_calls.pt \
        [--src build/parent/src] [--label parent]

Loads the arguments of the largest call that each sampled path made in a
``chip_smoke.py`` run (rows 1, 2, 3 and 3b of ``PERF.md``'s kernel table:
``segment_spmm_ragged``, ``gat_softmax_aggregate``, ``gather_spmm_ragged``
and its backward), imports ``repro_torch`` from ``--src`` (default: this
checkout's ``src/``), builds that tree's kernels, and prints one JSON line:
per row the wrapper's device time by CUDA-graph replay (``ms``), the
kernel alone (``kernel_ms``), both with the inputs rotated over four
copies as ``chip_smoke.py`` times them, and a SHA-256 of the output's
bits. So two trees compare in one call on one card: run it for the
parent, the change, the change and the parent, and compare times and
bits. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of a float tensor's bits."""
    ints = t.detach().contiguous().cpu().view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return hashlib.sha256(ints.numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", required=True, help="file written by chip_smoke.py --save-calls")
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sampled_rows: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_ms, rotating
    from repro_torch.kernels import build, fused_gnn

    build.build_all()
    calls = {k: tuple(a.cuda() if torch.is_tensor(a) else a for a in v)
             for k, v in torch.load(args.calls).items()}
    out = {}
    with torch.no_grad():
        msg, seg, n = calls["segment_spmm_ragged"]
        index = fused_gnn.segment_index(seg, n)
        got = fused_gnn.segment_spmm_ragged(msg, seg, n)
        out["segment_spmm_ragged"] = {
            "ms": graph_ms(rotating(fused_gnn.segment_spmm_ragged, msg, seg, n)),
            "kernel_ms": graph_ms(rotating(fused_gnn.launch_segment_sum, msg, seg, index,
                                           torch.empty_like(got))),
            "bits": digest(got)}

        logits, msg, seg, n = calls["gat_softmax_aggregate"]
        index = fused_gnn.segment_index(seg, n)
        got = fused_gnn.gat_softmax_aggregate(logits, msg, seg, n)
        lf = logits.float().contiguous()
        out["gat_softmax_aggregate"] = {
            "ms": graph_ms(rotating(fused_gnn.gat_softmax_aggregate, logits, msg, seg, n)),
            "kernel_ms": graph_ms(rotating(fused_gnn.launch_gat_softmax_aggregate, lf, msg, seg,
                                           index, torch.empty_like(got))),
            "bits": digest(got)}

        feats, idx, seg, n, order = calls["gather_spmm_ragged"]
        index = fused_gnn.segment_index(seg, n)
        got = fused_gnn.gather_spmm_ragged(feats, idx, seg, n, order)
        out["gather_spmm_ragged"] = {
            "ms": graph_ms(rotating(fused_gnn.gather_spmm_ragged, feats, idx, seg, n, order)),
            "kernel_ms": graph_ms(rotating(fused_gnn.launch_gather_sum, feats, idx, seg, index,
                                           torch.empty_like(got))),
            "bits": digest(got)}

        grad, idx, seg, f, order = calls["gather_spmm_ragged_backward"]
        g_idx, g_seg = fused_gnn._swapped(idx, seg, order, grad.shape[0])
        index = fused_gnn.segment_index(g_seg, f)
        got = fused_gnn.gather_spmm_ragged_backward(grad, idx, seg, f, order)
        out["gather_spmm_ragged_backward"] = {
            "ms": graph_ms(rotating(fused_gnn.gather_spmm_ragged_backward, grad, idx, seg, f,
                                    order)),
            "kernel_ms": graph_ms(rotating(fused_gnn.launch_gather_sum, grad, g_idx, g_seg,
                                           index, torch.empty_like(got))),
            "bits": digest(got)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "src": args.src, "card": card,
                      "kernels_from": fused_gnn.__file__, "rows": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
