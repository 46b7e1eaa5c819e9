"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py [--save-calls PATH] [--tuned-turns ROUNDS]

Builds the Hopper kernels from ``src/repro_torch/kernels/csrc/`` (one nvcc
per source, in parallel), holds each kernel and each backward kernel
against its plain PyTorch version on the card, then runs the port's paths
at the paper's model width on the ``ogbn-paper`` stand-in graph (150,000
vertices, 1.05 M edges, 4 parts, fanouts 15/10/5), for SAGE (3 layers,
128 -> 256 -> 256 -> 256, head 256 -> 16) and GAT (4 heads, same widths),
runs the segment max on its ids, serves four language models and trains
three at full width:

* inference and serving: ``GLISPSystem.build -> infer_layerwise ->
  server().submit/step/response``; 32 Zipf requests served batched and
  solo must agree bit for bit;
* the autotuner (``repro_torch.kernels.autotune``): every valid launch
  shape of every tuned op at an engine bucket, rows of over ``SUM_CHUNK``
  slots and D = 1, float32 and bf16, bitwise the heuristic's launch (the
  sums also bitwise ``ref.chunked_segment_sum_ref``); then
  ``infer_layerwise(kernel_autotune=True, kernel_cache_dir=...)`` for SAGE
  and GAT, whose layer stores must equal the untuned passes' bit for bit,
  with every launch reading a winner, each (op, bucket, dtype)'s heuristic
  and winner printed with their times; the SAGE pass runs inside
  ``repro_torch.analysis.recompile_guard`` (one tuner sweep per new (op,
  bucket, dtype) key), then again through the same engine inside a second
  guard (0 sweeps, 0 new keys), both printed on lines of their own; a
  fresh process must read every winner from the artifact (``measured ==
  0``); a CPU device must raise;
* training: ``system.trainer(model, train_ids).train(max_steps=...)``,
  20 SAGE steps and 10 GAT steps (batch 256, prefetch 2, AdamW lr 1e-3,
  weight decay 1e-4), then the first batch's loss and every gradient
  with kernels vs plain versions, and determinism: two 6-step runs, and a
  run checkpointed at step 3 and resumed to 6, must end with the same bits;
* sample-wise inference: ``repro_torch.core.inference.samplewise_inference``
  (the paper's baseline: each target's 3-hop subgraph through the whole
  model) for SAGE and GAT over 2,048 seeded targets, batch 256, with the
  layerwise pass's layer callables: one sum-and-count (SAGE) or softmax
  aggregate (GAT) launch per layer and batch; bitwise equal run to run and
  within the layer slices' tolerance of the plain versions, each on a
  fresh, identically seeded client; the paper's two ratios against the
  layerwise pass (vertex-layer computations per target over K, wall per
  target x N over the layerwise wall);
* the training launcher: ``repro_torch.launch.train`` ``gnn --config
  gcn-products`` (GCN-3x256) and ``--config hgt-relnet`` (HGT-2x128, 4
  heads), one epoch each at scale 0.5, in process and on the card by
  default: the launches each step and evaluation batch imply, finite
  losses, steady step wall, test accuracy;
* segment max: ``repro_torch.kernels.gnn_segment_max`` on the stand-in
  graph's destination ids shuffled (10% padding, 1% ids >= n), float32 and
  bf16, one launch each; bitwise equal to its plain version there and on
  mostly empty segments, NaN/+-inf/signed zeros, all padding and no edges;
* the dense call forms: ``ops.gnn_aggregate`` and
  ``ops.gnn_gather_aggregate`` with ``ragged=False`` on the stand-in
  graph's 1.05 M edges shuffled (seg = dst, idx = src, D 128), float32,
  bf16, and float32 with 10% padding and 1% ids >= n: each call one
  ``segment_spmm`` or ``gather_spmm`` launch and the sort's three passes
  (nine kernels); held against the plain versions, bitwise against the sorted-input kernel
  over the same edges in ``torch.sort(stable=True)`` order and against
  ``ref.chunked_segment_sum_ref``, the plain model of the CSR kernel's
  order (rows of more than ``SUM_CHUNK`` edges summed in chunks, then the
  chunk sums in chunk order), the sort's permutation bitwise against that
  order, two runs bitwise equal; at two small shapes also bitwise against
  the old route, the O(n E) scan;
* the distributed tier: the system rebuilt with ``dist_transport="mp"``
  and ``"socket"`` (one forked sampling worker per part, forked from this
  process with its CUDA context live), 64 requests of 256 seeds, keys
  ``(0xD15B, i)``, each answer bitwise the in-process system's
  (throughput, client dispatch p50 / p95, ``server_workloads()``); a
  worker killed with SIGKILL, respawned, the next 8 answers bitwise; then
  ``system.dp_trainer(model, train_ids, num_shards=S, reference=True)``
  over the ``mp`` workers for SAGE and GAT at S = 1, 2 and 4 (256 seeds a
  shard, prefetch 0, 8 steps): the merged step's losses within rtol 1e-5
  / atol 1e-6 of the per-shard twin's, its launches a step those of one
  training step whatever S (the twin's S times that), the first step's
  merged aggregates, layer by layer, bitwise each shard's own launches on
  the same layer inputs and the per-shard loop's own forward; ``close()``
  twice, and no worker left;
* the production-mesh dry run (``repro_torch.launch.dryrun``, on this
  machine's host, no kernel): ``run_one`` for mixtral-8x7b x ``train_4k``
  and x ``decode_32k`` and deepseek-v2-lite-16b x ``decode_32k`` on the
  (16, 16) mesh of a fake 256-rank group, each
  device's peak and argument bytes printed against the card's memory
  (``total_memory``), with the roofline's dominant term and the collective
  bytes; then the accounting held on the card at world 1, in a fresh
  process: gemma-2b's bf16 parameters and a decode cache (batch 4, length
  2048) built on the card must grow ``memory_allocated()`` by the dry
  run's ``argument_bytes`` on a (1, 1) mesh, within the allocator's
  512-byte rounding per tensor;
* transformer serving: ``repro_torch.launch.serve.serve`` for gemma-2b
  (18 layers, d_model 2048, 8 query heads over 1 KV head of 256, GeGLU
  16384, vocab 256,000) and mamba2-130m (24 layers, d_model 768, 24 SSD
  heads of 64, state 128), both at their full configs in bf16: batch 4,
  prompt 2048, 32 greedy tokens; and deepseek-v2-lite-16b (27 layers,
  d_model 2048, MLA with 16 heads of 128 + a 64-wide RoPE tail and a
  512-wide latent, 64 routed experts top-6 + 2 shared of width 1408,
  vocab 102,400; 16.0 B parameters, 32 GB in bf16) the same way. Every
  prefill layer must launch the flash-attention or the SSD-scan kernel
  once (18, 24 and 27 per prefill; decode is plain tensor code); a second
  run must give the same bits, and the prefill's logits must agree with
  runs through the plain versions, in float32 and in bf16
  (``LM_F32_TOL``, ``LM_BF16_RATIO``), at full depth for the first two and
  at 4 layers for deepseek (its float32 upcast would not fit), counting
  the MoE routing flips between the two float32 runs; each prefill's
  device profile must charge time to its kernel (``device_ms_by_kind``
  classifies the SSD's three kernels by ``ssd_scan_kernel``); and
  recurrentgemma-2b (26 layers, d_model 2560, RG-LRU blocks and a local
  attention of 10 query heads over one KV head of 256, window 2048, every
  third layer: 8 flash launches per prefill) the same way. Before it,
  both kernels are held against their plain versions at the paths' shapes
  (flash at D 256 and at MLA's 192 over 128) and at ragged ones, float32
  and bf16, and so are both backward kernels against autograd of the
  plain versions (every head width, gemma-2b's and recurrentgemma-2b's
  training attention, MLA's, a window, a ``kv_offset``; the SSD at
  mamba2-130m's training shape, a ragged S and an initial state), each
  twice bitwise;
* LM training: ``repro_torch.train.LMTrainer`` on the synthetic token
  stream, bf16 on float32 master weights, remat per layer, the reference
  trainer's AdamW (lr 3e-4 after 100 warmup steps): gemma-2b
  at batch 2 x 2048 tokens (5 steps), mamba2-130m at 4 x 2048 (6) and
  recurrentgemma-2b at 1 x 4096 (4), where the window of 2048 bites. Each
  model's first step in float32, kernels vs plain versions on the card
  (loss and every gradient leaf; gemma-2b at 4 layers, recurrentgemma-2b
  at 3), a bf16 forward and backward twice (bitwise, or the leaves that
  differ named), the launches of every step (per attention or SSD layer
  two forward launches, one of them remat's recompute, and one backward
  launch), losses finite and falling, and one step profiled.

Weights are random, drawn with numpy from seed 0 (the LM weights on the
card from a ``torch.Generator`` seeded with 0; the LM training batches
from ``SyntheticTokenStream`` seeded with 0). Launch counters are
zeroed just before each path and read just after; each path must launch
exactly the kernels it implies (per training step: SAGE 3 gathers + 2
gather backwards; GAT 3 softmax aggregates + 3 backwards + 6 row-gather
backwards).

Prints the ``-Xptxas -v`` build report, every comparison with its maximum
error, wall times, the dense forms at the small shapes beside the old scan
route, a ``{"kernels": [...]}`` line with each kernel's time, bound, plain-version
and library times, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero before that line. Exits non-zero without CUDA, and where the
repository's ``src/`` is missing.

Kernel times, at the largest call each kernel saw on the path, with the
inputs rotated over four copies so that every call reads device memory:
``ms`` is the wrapper's device time (index work, offsets kernel, kernel)
from CUDA-graph replay, ``kernel_ms`` the kernel alone, ``eager_ms`` the
wrapper called back to back from Python (bound by host issue time);
``plain_ms`` and ``library_ms`` are eager calls timed with CUDA events; the
flash rows also time SDPA by CUDA-graph replay (``library_graph_ms``) and
print the kernel's ratio to it and its share of the bound; the dense
forms' rows add the sort alone (``sort_ms``, its share of ``ms``),
``ms`` in bf16, the library route from the unsorted ids
(``library_from_ids_ms``: for ``gather_spmm`` the COO tensor, its
coalesce, the CSR conversion and ``torch.sparse.mm``, against the row's
``ms``; ``library_ms`` there is ``torch.sparse.mm`` over a prebuilt CSR,
against ``kernel_ms``; for ``segment_spmm``, ``index_add_`` starts from
the ids, so the two are one time).
``--save-calls PATH`` also saves the sampled paths' largest calls for
``tools/time_sampled_rows.py``, which times them on another tree's kernels.
``--tuned-turns ROUNDS`` runs, after the build, only the SAGE and GAT
passes without and with the tuner's winners in turns (``tuned_turns``).
Bounds come from ``repro_torch.launch.roofline`` alone: each row's
``kernel_roofline(op, shape, ms, dtype, hw)`` (``roofline_op`` names the
op), with ``hw = hardware(torch.cuda.get_device_name(0))``, which fails
the run on a card the roofline does not know: bytes at the card's memory
rate against operations at its float32 peak (the GNN kernels) or its bf16
tensor-core peak (the LM kernels; causal attention counts the unmasked
pairs). Every LM serving and training phase prints its ``roofline(...)``
line: ``mfu`` and ``hbm_share`` of the prefill, of decode and of the
steady training step, with ``step_time_bound_s`` and ``dominant``. A
share of a peak or a bound over 1 fails the run. The flash kernel's
library yardstick is ``scaled_dot_product_attention``, the segment max's
``scatter_reduce(..., "amax")``, the dense sums' ``index_add_`` and
``torch.sparse.mm``, the sort's ``torch.sort(stable=True)``, all timed
here and never called by the port. The SSD row adds each of its three
kernels' device time from ``torch.profiler`` (``phase_kernel_ms``) and its
share of the bound.

Tolerances: kernel vs plain float32 rtol 1e-5 / atol 1e-5 (sums in
another order); the GAT backward's logit gradient rtol 1e-4 / atol 1e-5
(a difference of two dot products); bfloat16 rtol 1e-2 / atol 1e-2, about
one rounding of the output, against the plain version run on the inputs
upcast to float32 and rounded to bfloat16 (the kernels sum in float32 and
round once); on the stand-in graph's rows (up to 6,447 edges) the dense
forms in float32 against their sums in float64, within twice the rounding
bound of a float32 sum in the kernel's chunked order (``check_sum_f32``);
the CSR kernel bitwise against the plain model of that order; whole
layer slices, and the sample-wise pass through three of them, float32
rtol 1e-4 / atol 1e-5 (a matmul follows the aggregation); a training batch's loss and gradients rtol
1e-4 / atol 1e-6. Flash attention float32 rtol 1e-4 / atol 1e-5, the SSD
scan float32 rtol 1e-4 / atol 1e-4 (chunks of another length, sums in
another order; the final state at this tolerance in bf16 too), both bf16
rtol 1e-2 / atol 1e-2 against the plain
version on the bf16 inputs; a sort's permutation and sums over the same
edges in the same order bitwise; the LM prefill logits ``LM_F32_TOL`` in
float32 and ``LM_BF16_RATIO`` in bf16 (see there).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORKDIR = ROOT / "build" / "chip_smoke"

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.detach().float() - b.detach().float()).abs().max())


def tol_share(got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 where
    ``torch.allclose`` at ``tol`` = (rtol, atol) holds."""
    if got.numel() == 0:
        return 0.0
    rtol, atol = tol
    got, want = got.detach().float(), want.detach().float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def check_close(name, got, want, dtype=torch.float32, tol=None) -> float:
    rtol, atol = tol or TOL[dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = max_err(got, want)
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: max abs err {err} beyond rtol {rtol} atol {atol}")
    log(f"  ok {name}: max_abs_err {err:.3e}")
    return err


U32 = 2.0**-24  # unit roundoff of float32 (round to nearest)
U64 = 2.0**-53


def check_sum_f32(name, got, terms, rows, n, in_order=True) -> float:
    """A float32 sum of rows held against the same sum in float64:
    ``terms`` [k, D] float32 summed into the output rows ``rows`` [k]
    (non-decreasing; with ``in_order``, one term per edge slot of the
    kernel's CSR rows, in slot order, a dropped gather's slot as a zero
    term). The limit of an element is twice the first-order rounding bound
    of its float32 sum in the CSR kernel's chunked order (``SUM_CHUNK``
    slots a chunk, counted from the row's first slot, each chunk summed
    in order, then the chunk sums in chunk order): u * (sum |s_i| over the
    running sums within each chunk + sum |S_j| over the running sums of the
    chunk combine after its first chunk), u = 2^-24; or, where the order is
    not known (a library's atomics), u * (k - 1) * sum |x| for a row of k
    terms; plus k * 2^-53 * sum |x| for the float64 sum's own rounding. The
    in-order limit of a row of at most ``SUM_CHUNK`` terms grows as k^1.5
    for k independent N(0, 1) terms and as k^2 where terms repeat; chunks
    cap the first part at ``SUM_CHUNK`` terms: on the stand-in's rows it
    stays far below the |x| ~ 1 by which a dropped or doubled edge moves
    some of the 128 columns, where a per-edge atol does not. Logs the
    error, its largest share of the limit, and the largest limit."""
    from repro_torch.kernels.ref import SUM_CHUNK

    t = terms.double()
    rows = rows.long()
    zeros = torch.zeros((n, t.shape[1]), dtype=torch.float64, device=t.device)
    want = zeros.clone().index_add_(0, rows, t)
    mag = zeros.clone().index_add_(0, rows, t.abs())
    k = torch.bincount(rows, minlength=n).double()[:, None]
    if in_order:
        c = t.cumsum(0)

        def before(at):  # the running sum of all terms before slot ``at``
            return torch.where((at > 0)[:, None], c[(at - 1).clamp_min(0)], 0.0)

        first = torch.searchsorted(rows, rows)  # each term's row starts here
        pos = torch.arange(rows.shape[0], device=rows.device) - first
        spread = zeros.index_add_(0, rows, (c - before(first + pos - pos % SUM_CHUNK)).abs())
        # a chunk's last slot, from the second chunk on: the combine's running sum
        ends = torch.ones_like(rows, dtype=torch.bool)
        ends[:-1] = rows[1:] != rows[:-1]
        ends = (ends | (pos % SUM_CHUNK == SUM_CHUNK - 1)) & (pos >= SUM_CHUNK)
        spread.index_add_(0, rows[ends], (c[ends] - before(first[ends])).abs())
        del c
    else:
        spread = (k - 1).clamp_min(0) * mag
    limit = 2 * U32 * spread + k * U64 * mag
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got.double() - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    share = float(torch.where(diff > 0, diff / limit, 0.0).max()) if diff.numel() else 0.0
    if not bool((diff <= limit).all()):
        fail(f"{name}: max abs err {err} beyond the float32 rounding bound "
             f"(largest share of the limit {share})")
    log(f"  ok {name}: max_abs_err {err:.3e} vs the float64 sum, at most "
        f"{share:.3f} of the limit ({'in order' if in_order else 'any order'}; "
        f"largest limit {float(limit.max()):.3e})")
    return err


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Mean device time of one call: ``iters`` calls captured in a CUDA
    graph and replayed, so host issue time drops out (the wrappers never
    wait for the card, so they can be captured)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * iters)


def check_shares(what: str, shares: dict) -> None:
    """Fails on a share of a peak or a bound outside (0, 1]: no card beats
    its peak, so a share over 1 means a count is wrong."""
    for name, share in shares.items():
        if not 0.0 < share <= 1.0:
            fail(f"{what}: {name} {share} is outside (0, 1]; a count is wrong")


def bound_fields(hw: dict, op: str, shape: dict, ms: float, dtype: str = "f32") -> dict:
    """A kernel row's bound, from ``repro_torch.launch.roofline``'s
    ``kernel_roofline(op, shape)`` on the card ``hw`` at the row's ``ms``:
    ``bound_ms``, ``bound_by`` (bytes or operations) and ``bound_share``
    (bound / ms, at most 1). ``dtype`` names the type of the operations:
    float32 for the GNN kernels (they add in float32 whatever they read),
    bf16 for the LM kernels on the tensor cores."""
    from repro_torch.launch.roofline import kernel_roofline

    r = kernel_roofline(op, shape, ms / 1e3, dtype, hw)
    check_shares(f"kernel {op} at {shape}", {"bound_share": r["frac_of_bound"]})
    return {"roofline_op": op, "bound_ms": r["bound_s"] * 1e3,
            "bound_by": "operations" if r["bound"] == "compute" else "bytes",
            "bound_share": r["frac_of_bound"], "bound_flops": r["flops"],
            "bound_bytes": r["hbm_bytes"]}


def step_roofline(what: str, cfg, shape: dict, wall_ms: float, hw: dict,
                  weight_bytes: int) -> dict:
    """An LM step's ``mfu``, ``hbm_share``, ``step_time_bound_s`` and
    ``dominant`` from ``repro_torch.launch.roofline.roofline`` at its
    measured wall, printed on the phase's line; a share over 1 fails."""
    from repro_torch.launch.roofline import roofline

    r = roofline(cfg, shape, hw=hw, wall_s=wall_ms / 1e3, weight_bytes=weight_bytes)
    out = {k: r[k] for k in ("mfu", "hbm_share", "step_time_bound_s", "dominant")}
    log(f"  {what} roofline ({shape}, {weight_bytes}-byte weights, wall {wall_ms:.2f} ms): "
        + json.dumps(out))
    check_shares(what, {"mfu": out["mfu"], "hbm_share": out["hbm_share"]})
    return out


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    for stem in paths:
        build.library(stem)
    log(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.2f} s")
    for stem, text in build.ptxas_log().items():
        log(f"--- nvcc -Xptxas -v: {stem}.cu")
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance Loss")):
                log("  " + line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at the path's shapes
# ---------------------------------------------------------------------------


def edges(m, n, valid, seed, lead, row, dtype, *, shuffle=False, dev="cuda"):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, m)).astype(np.int32)
    seg[valid:] = -1
    if shuffle:
        seg = rng.permutation(seg)
    msg = rng.standard_normal((m,) + lead + (row,)).astype(np.float32)
    logits = rng.standard_normal((m,) + lead).astype(np.float32)
    return (
        torch.as_tensor(seg, device=dev),
        torch.as_tensor(msg, device=dev).to(dtype),
        torch.as_tensor(logits, device=dev),
    )


def plain_up(fn, *args):
    """``fn`` on the float tensors upcast to float32, rounded back to the
    messages' dtype (the last float argument): what a kernel that sums in
    float32 and rounds once must give."""
    dtype = [a for a in args if torch.is_tensor(a) and a.is_floating_point()][-1].dtype
    up = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    return fn(*up).to(dtype)


def plain_sum_and_count(msg, seg, n):
    from repro_torch.kernels.ref import segment_spmm_ref

    ones = (seg >= 0).to(torch.float32)[:, None]
    return segment_spmm_ref(msg, seg, n), segment_spmm_ref(ones, seg, n)


def plain_gat(logits, msg, seg, n):
    from repro_torch.kernels.ref import gat_softmax_aggregate_ref

    if logits.dim() == 1:
        return gat_softmax_aggregate_ref(logits, msg, seg, n)
    return torch.stack(
        [gat_softmax_aggregate_ref(logits[:, h], msg[:, h], seg, n) for h in range(msg.shape[1])],
        dim=1,
    )


def compare_kernels() -> None:
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import segment_spmm_ref

    log("phase: kernels vs plain versions on the card")
    cases = []
    for m in (16384, 65536):
        for d in (1, 128, 256):
            cases.append((m, 4096, d, int(0.8 * m), False, f"E={m} n=4096 D={d}"))
    cases += [
        (65536, 4096, 256, 40000, True, "unsorted seg E=65536 D=256"),
        (16384, 4096, 128, 0, False, "all padding"),
        (0, 4096, 128, 0, False, "zero edges"),
        (512, 4096, 64, 512, False, "mostly empty segments"),
        (3000, 700, 128, 2100, True, "unsorted with padding inside"),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, d, valid, shuffle, label in cases:
            seg, msg, _ = edges(m, n, valid, m + d, (), d, dtype, shuffle=shuffle)
            got = fused_gnn.segment_spmm_ragged(msg, seg, n)
            check_close(f"segment_spmm_ragged {label} {dtype}", got,
                        plain_up(segment_spmm_ref, msg, seg, n), dtype)
        for m, n, valid, shuffle, label in (
            (65536, 4096, 50000, False, "E=65536 n=4096 H=4 dh=64"),
            (65536, 4096, 50000, True, "unsorted E=65536 H=4 dh=64"),
            (0, 4096, 0, False, "zero edges H=4"),
            (8192, 4096, 0, False, "all padding H=4"),
        ):
            seg, msg, logits = edges(m, n, valid, m + 1, (4,), 64, dtype, shuffle=shuffle)
            got = fused_gnn.gat_softmax_aggregate(logits, msg, seg, n)
            check_close(f"gat_softmax_aggregate {label} {dtype}", got,
                        plain_up(plain_gat, logits, msg, seg, n), dtype)
        seg, msg, logits = edges(16384, 4096, 15000, 3, (), 64, dtype)
        check_close(f"gat_softmax_aggregate one head E=16384 dh=64 {dtype}",
                    fused_gnn.gat_softmax_aggregate(logits, msg, seg, 4096),
                    plain_up(plain_gat, logits, msg, seg, 4096), dtype)
    for shuffle in (False, True):
        seg, msg, _ = edges(65536, 4096, 40000, 11, (), 256, torch.float32, shuffle=shuffle)
        agg, cnt = fused_gnn.segment_sum_and_count(msg, seg, 4096)
        want_agg, want_cnt = plain_sum_and_count(msg, seg, 4096)
        check_close(f"segment_sum_and_count sum E=65536 D=256 shuffle={shuffle}", agg, want_agg)
        check_close(f"segment_sum_and_count count E=65536 shuffle={shuffle}", cnt, want_cnt,
                    tol=(0.0, 0.0))


def gather_inputs(e, f, n, d, valid, seed, *, shuffle=False, pad=True, dev="cuda"):
    """Gather-sum inputs: feats [f, d], idx and seg [e] int32 (seg sorted
    with a padding tail after ``valid`` edges, or shuffled), an upstream
    gradient [n, d]."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    idx = rng.integers(0, f, e).astype(np.int32)
    if pad:
        seg[valid:] = -1
        idx[valid:] = -1
    if shuffle:
        perm = rng.permutation(e)
        seg, idx = seg[perm], idx[perm]
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (t(rng.standard_normal((f, d)).astype(np.float32)), t(idx), t(seg),
            t(rng.standard_normal((n, d)).astype(np.float32)))


def compare_training_kernels() -> None:
    """The gather kernel (forward and backward) and the GAT backward kernel
    against their plain versions, float32, at the training path's widths
    and at random shapes with padding."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import (
        gat_softmax_aggregate_backward_ref,
        gather_spmm_ragged_backward_ref,
        gather_spmm_ref,
    )

    log("phase: training kernels (forward and backward) vs plain versions on the card")
    for e, f, n, d, valid, shuffle in (
        (240000, 100000, 100000, 128, 235000, False),  # SAGE layer 0 at full width
        (60000, 100000, 100000, 256, 45000, False),
        (16384, 5000, 4096, 128, 15000, True),
        (3000, 700, 900, 16, 2100, True),
        (0, 50, 40, 8, 0, False),
        (4096, 300, 256, 64, 0, False),
    ):
        feats, idx, seg, grad = gather_inputs(e, f, n, d, valid, e + d, shuffle=shuffle)
        x = feats.clone().requires_grad_(True)
        out = fused_gnn.gather_spmm_ragged(x, idx, seg, n)
        label = f"E={e} F={f} n={n} D={d} valid={valid} shuffle={shuffle}"
        check_close(f"gather_spmm_ragged {label}", out, gather_spmm_ref(feats, idx, seg, n))
        out.backward(grad)
        check_close(f"gather_spmm_ragged backward {label}", x.grad,
                    gather_spmm_ragged_backward_ref(grad, idx, seg, f))
        rows = feats.clone().requires_grad_(True)
        g_rows = torch.randn(e, d, device="cuda", generator=torch.Generator("cuda").manual_seed(e))
        fused_gnn.gather_rows(rows, idx).backward(g_rows)
        each = torch.arange(e, dtype=torch.int32, device="cuda")  # edge e gathers grad row e
        check_close(f"gather_rows backward {label}", rows.grad,
                    gather_spmm_ragged_backward_ref(g_rows, idx, each, f))
    for e, n, h, dh, valid, shuffle in (
        (240000, 100000, 4, 64, 235000, False),  # GAT layer 0 at full width
        (65536, 4096, 4, 64, 50000, True),
        (300, 50, 4, 6, 150, True),
        (0, 7, 2, 8, 0, False),
        (8192, 4096, 4, 64, 0, False),
    ):
        seg, msg, logits = edges(e, n, valid, e + 5, (h,), dh, torch.float32, shuffle=shuffle)
        lg = logits.clone().requires_grad_(True)
        mg = msg.clone().requires_grad_(True)
        grad = torch.randn(n, h, dh, device="cuda", generator=torch.Generator("cuda").manual_seed(e))
        fused_gnn.gat_softmax_aggregate(lg, mg, seg, n).backward(grad)
        want = [gat_softmax_aggregate_backward_ref(grad[:, j], logits[:, j], msg[:, j], seg, n)
                for j in range(h)]
        label = f"E={e} n={n} H={h} dh={dh} valid={valid} shuffle={shuffle}"
        check_close(f"gat_softmax_aggregate backward dmsg {label}", mg.grad,
                    torch.stack([w[1] for w in want], 1))
        check_close(f"gat_softmax_aggregate backward dlogit {label}", lg.grad,
                    torch.stack([w[0] for w in want], 1), tol=(1e-4, 1e-5))


def dense_small() -> list:
    """The dense call forms (``segment_spmm``, ``gather_spmm``: unpadded ids
    in no order) at the two small shapes earlier runs timed them at, before
    the sort existed, through the sorted-input kernels' O(n E) scan: held
    against the plain versions and bitwise against that scan route
    (``ragged=True`` on the unsorted ids), and timed beside it (CUDA-graph
    replay), so that before and after stay comparable."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import gather_spmm_ref, segment_spmm_ref

    log("phase: dense call forms at small shapes, against the old scan route")
    rows = []
    for e, f, n, d in ((2048, 1024, 256, 128), (8192, 4096, 1024, 128)):
        feats, idx, seg, _ = gather_inputs(e, f, n, d, e, 7, shuffle=True, pad=False)
        msg = feats[idx.long()].contiguous()
        label = f"E={e} F={f} n={n} D={d}"
        if not int(fused_gnn.segment_index(seg, n)[n + 1]):
            fail("the shuffled ids did not raise the unsorted flag: no scan route to compare")
        gathered = fused_gnn.gather_spmm(feats, idx, seg, n)
        dense = fused_gnn.segment_spmm(msg, seg, n)
        err4 = check_close(f"gather_spmm {label}", gathered, gather_spmm_ref(feats, idx, seg, n))
        err6 = check_close(f"segment_spmm {label}", dense, segment_spmm_ref(msg, seg, n))
        with torch.no_grad():
            check_bitwise(f"gather_spmm {label} vs the scan route",
                          gathered, fused_gnn.gather_spmm_ragged(feats, idx, seg, n))
        check_bitwise(f"segment_spmm {label} vs the scan route",
                      dense, fused_gnn.segment_spmm_ragged(msg, seg, n))
        with torch.no_grad():
            rows.append({
                "shape": {"E": e, "F": f, "n": n, "D": d},
                "gather_spmm": {
                    "max_abs_err": err4,
                    "ms": graph_ms(rotating(fused_gnn.gather_spmm, feats, idx, seg, n)),
                    "scan_route_ms": graph_ms(
                        rotating(fused_gnn.gather_spmm_ragged, feats, idx, seg, n)),
                },
                "segment_spmm": {
                    "max_abs_err": err6,
                    "ms": graph_ms(rotating(fused_gnn.segment_spmm, msg, seg, n)),
                    "scan_route_ms": graph_ms(
                        rotating(fused_gnn.segment_spmm_ragged, msg, seg, n)),
                },
            })
    log("dense_small: " + json.dumps(rows))
    return rows


DENSE_WIDTH = 128  # the stand-in graph's feature width


def dense_edges(g, seed, *, pad=0.0, over=0.0):
    """The stand-in graph's edges in a random order, on the card: idx = src,
    seg = dst; a ``pad`` share of seg set to -1 and an ``over`` share to ids
    >= n (as ``max_inputs`` draws them), and half as many idx set to -1."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.num_edges)
    idx = g.src[perm].astype(np.int32)
    seg = g.dst[perm].astype(np.int32)
    if pad or over:
        pick = rng.random(seg.shape[0])
        seg[pick < pad] = -1
        high = (pick >= pad) & (pick < pad + over)
        seg[high] = g.num_vertices + rng.integers(0, 1000, int(high.sum()))
        idx[rng.random(idx.shape[0]) < pad / 2] = -1
    return torch.as_tensor(idx, device="cuda"), torch.as_tensor(seg, device="cuda")


def dense_form_path(g) -> tuple[dict, dict]:
    """``ops.gnn_aggregate`` and ``ops.gnn_gather_aggregate`` with
    ``ragged=False``, the entry points of the dense TPU kernels, on the
    stand-in graph's 1.05 M edges shuffled (seg = dst, idx = src; n = F =
    150,000, D 128): float32, bf16, and float32 with 10% padding and 1% ids
    >= n. Counts zeroed just before each pair of calls and read just
    after: one ``segment_spmm``, one ``gather_spmm`` and the sort's three
    kernels a pass, twice. Each result is held against its plain version
    (float32: the sum in float64, within the rounding bound of
    ``check_sum_f32``; bf16: the plain version on the inputs upcast,
    rounded, flat rtol and atol 1e-2), bitwise against
    the sorted-input kernel over the same edges in ``torch.sort(stable=True)``
    order (an oracle only), and bitwise against a second run; the sort's
    permutation bitwise against that order. Returns the path's numbers,
    its launches and the clean float32 call's arguments."""
    from repro_torch.kernels import fused_gnn, ops
    from repro_torch.kernels.ref import chunked_segment_sum_ref, gather_spmm_ref, segment_spmm_ref

    log("phase: dense call forms through gnn_aggregate / gnn_gather_aggregate(ragged=False) "
        "on the stand-in graph's shuffled edges")
    n = g.num_vertices
    rng = np.random.default_rng(3)
    feats32 = torch.as_tensor(rng.standard_normal((n, DENSE_WIDTH)).astype(np.float32),
                              device="cuda")
    clean, padded = dense_edges(g, 4), dense_edges(g, 5, pad=0.1, over=0.01)
    passes = fused_gnn.sort_passes(n)
    launches = dict.fromkeys(("segment_spmm", "gather_spmm", "segment_sort"), 0)
    info, calls = {"edges": int(g.num_edges), "segments": n, "sort_passes": passes}, {}
    for label, dtype, (idx, seg) in (("float32", torch.float32, clean),
                                     ("bf16", torch.bfloat16, clean),
                                     ("float32 padded", torch.float32, padded)):
        feats = feats32.to(dtype)
        msg = feats[idx.clamp_min(0).long()].contiguous()
        fused_gnn.reset_launches()
        t0 = time.perf_counter()
        dense = ops.gnn_aggregate(msg, seg, n, ragged=False)
        gathered = ops.gnn_gather_aggregate(feats, idx, seg, n, ragged=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in fused_gnn.LAUNCHES.items() if v}
        want = {"segment_spmm": 1, "gather_spmm": 1, "segment_sort": 2 * 3 * passes}
        if got != want:
            fail(f"the dense forms ({label}) launched {got}, they imply {want}")
        for k, v in got.items():
            launches[k] += v
        tag = f"E={idx.shape[0]} n={n} D={DENSE_WIDTH} {label}"
        key = seg.long().masked_fill((seg < 0) | (seg >= n), n)
        order = torch.sort(key, stable=True).indices
        rows, s_idx = key[order], idx[order]
        # the rows the CSR kernel reads at each sorted slot (a dropped gather: zeros)
        g_terms = torch.where((s_idx >= 0)[:, None], feats[s_idx.clamp_min(0).long()], 0.0)
        if dtype == torch.float32:
            ok = rows < n
            err6 = check_sum_f32(f"gnn_aggregate(ragged=False) {tag}", dense,
                                 msg[order[ok]], rows[ok], n)
            err4 = check_sum_f32(f"gnn_gather_aggregate(ragged=False) {tag}", gathered,
                                 g_terms[ok], rows[ok], n)
        else:
            err6 = check_close(f"gnn_aggregate(ragged=False) {tag}", dense,
                               plain_up(segment_spmm_ref, msg, seg, n), dtype)
            err4 = check_close(f"gnn_gather_aggregate(ragged=False) {tag}", gathered,
                               plain_up(gather_spmm_ref, feats, idx, seg, n), dtype)
        check_bitwise(f"gnn_aggregate(ragged=False) {tag} vs the CSR kernel's order model",
                      dense, chunked_segment_sum_ref(msg[order], rows, n).to(dtype))
        check_bitwise(f"gnn_gather_aggregate(ragged=False) {tag} vs the CSR kernel's order model",
                      gathered, chunked_segment_sum_ref(g_terms, rows, n).to(dtype))
        del g_terms
        check_bitwise(f"segment_sort permutation {tag} vs torch.sort(stable=True)",
                      fused_gnn.segment_sort(seg, n), order.to(torch.int32))
        s_seg = seg[order].contiguous()
        if int(fused_gnn.segment_index(s_seg, n)[n + 1]):
            fail("the stable-sorted ids raised the unsorted flag")
        check_bitwise(f"gnn_aggregate(ragged=False) {tag} vs the sorted-input kernel",
                      dense, fused_gnn.segment_spmm_ragged(msg[order].contiguous(), s_seg, n))
        with torch.no_grad():
            check_bitwise(f"gnn_gather_aggregate(ragged=False) {tag} vs the sorted-input kernel",
                          gathered,
                          fused_gnn.gather_spmm_ragged(feats, idx[order].contiguous(), s_seg, n))
        check_bitwise(f"gnn_aggregate(ragged=False) {tag}, two runs", dense,
                      ops.gnn_aggregate(msg, seg, n, ragged=False))
        check_bitwise(f"gnn_gather_aggregate(ragged=False) {tag}, two runs", gathered,
                      ops.gnn_gather_aggregate(feats, idx, seg, n, ragged=False))
        if not (torch.isfinite(dense).all() and torch.isfinite(gathered).all()):
            fail(f"the dense forms ({label}) gave a non-finite value")
        info[label] = {"valid_edges": int(((seg >= 0) & (seg < n)).sum()), "launches": got,
                       "wall_ms_two_calls": wall_ms, "segment_spmm_max_abs_err": err6,
                       "gather_spmm_max_abs_err": err4}
        calls[label] = (feats, msg, idx, seg, n)
    info["launches"] = launches
    log("  dense-form path: " + json.dumps(info))
    return info, calls


# ---------------------------------------------------------------------------
# the segment-max path: its entry point at the stand-in graph's edge count
# ---------------------------------------------------------------------------


def bits(t: torch.Tensor) -> torch.Tensor:
    """The float's bits as integers (the sign of a zero and NaN payloads
    included); an integer tensor as it is."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return t if view is None else t.view(view)


def check_bitwise(name, got, want) -> float:
    """``got`` must have ``want``'s bits (the sign of a zero included): a
    max has no rounding, and a sum over the same edges in the same order
    has one result. Returns the max abs error, 0.0."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(bits(got),
                                                                              bits(want)):
        differ = int((bits(got) != bits(want)).sum()) if got.shape == want.shape else -1
        fail(f"{name}: not bitwise equal ({differ} elements differ, "
             f"max abs err {max_err(got, want)})")
    log(f"  ok {name}: bitwise equal")
    return max_err(got, want)


def max_inputs(ids, n, seed, dtype, *, pad=0.1, over=0.01, special=False):
    """x [E] and the ids shuffled, on the card: a ``pad`` share of -1, an
    ``over`` share of ids >= n; ``special`` salts x with NaN, +-inf, -0.0
    and +0.0 and gives every 7th segment only zeros of either sign."""
    rng = np.random.default_rng(seed)
    seg = rng.permutation(np.asarray(ids)).astype(np.int32)
    e = seg.shape[0]
    pick = rng.random(e)
    seg[pick < pad] = -1
    high = (pick >= pad) & (pick < pad + over)
    seg[high] = n + rng.integers(0, 1000, int(high.sum()))
    x = rng.standard_normal(e).astype(np.float32)
    if special and e:
        vals = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
        salt = rng.random(e) < 0.01
        x[salt] = rng.choice(vals, int(salt.sum()))
        zeros = (seg >= 0) & (seg % 7 == 0)
        x[zeros] = np.where(rng.random(int(zeros.sum())) < 0.7, -0.0, 0.0)
    return torch.as_tensor(x, device="cuda").to(dtype), torch.as_tensor(seg, device="cuda")


def segment_max_path(g) -> tuple[dict, tuple]:
    """``repro_torch.kernels.gnn_segment_max``, the op's entry point, on the
    stand-in graph's destination ids (1.05 M edges over 150,000 vertices,
    power-law in-degrees) shuffled, with 10% padding and 1% ids >= n, in
    float32 and bf16: counts zeroed just before, read just after (one
    launch each). Each result must be its plain version's bits; so must
    the cases around it (mostly empty segments; NaN, +-inf and signed
    zeros; all padding; no edges). Returns the path's numbers and the
    float32 call's arguments."""
    from repro_torch.kernels import fused_gnn, ops
    from repro_torch.kernels.ref import segment_max_ref

    log("phase: segment max through gnn_segment_max on the stand-in graph's ids")
    n = g.num_vertices
    calls = {dtype: max_inputs(g.dst, n, 1, dtype) for dtype in (torch.float32, torch.bfloat16)}
    fused_gnn.reset_launches()
    t0 = time.perf_counter()
    outs = {dtype: ops.gnn_segment_max(x, seg, n) for dtype, (x, seg) in calls.items()}
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in fused_gnn.LAUNCHES.items() if v}
    if got != {"segment_max": 2}:
        fail(f"the segment-max path launched {got}, it implies 2 segment_max launches")
    for dtype, (x, seg) in calls.items():
        out = outs[dtype]
        check_bitwise(f"gnn_segment_max E={x.shape[0]} n={n} shuffled graph ids {dtype}", out,
                      segment_max_ref(x, seg, n))
        if not torch.isfinite(out).all():
            fail("gnn_segment_max gave a non-finite value")
    rng = np.random.default_rng(2)
    e = int(g.num_edges)
    for label, m, n2, pad, over, special in (
        ("mostly empty segments", 50000, 1_000_000, 0.1, 0.0, False),
        ("NaN, +-inf, -0.0 and +0.0", e, n, 0.1, 0.01, True),
        ("all padding", 65536, 4096, 1.0, 0.0, False),
        ("zero edges", 0, 4096, 0.0, 0.0, False),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            x, seg = max_inputs(rng.integers(0, n2, m), n2, m + n2, dtype, pad=pad, over=over,
                                special=special)
            check_bitwise(f"segment_max {label} E={m} n={n2} {dtype}",
                          fused_gnn.segment_max(x, seg, n2), segment_max_ref(x, seg, n2))
    x, seg = calls[torch.float32]
    info = {
        "edges": e,
        "segments": n,
        "valid_edges": int(((seg >= 0) & (seg < n)).sum()),
        "empty_segments": int(torch.bincount(seg[(seg >= 0) & (seg < n)].long(),
                                             minlength=n).eq(0).sum()),
        "launches": got["segment_max"],
        "wall_ms_two_calls": wall_ms,
    }
    log("  segment max path: " + json.dumps(info))
    return info, (x, seg, n)


def time_segment_max(args, launches: int, hw: dict) -> dict:
    """Kernel 5 at the path's float32 call. Bound (``segment_max``): x and
    the ids read once, the output written once.
    Library yardstick: ``scatter_reduce(..., "amax")`` of the valid edges
    into a -inf row (which gives +-inf and NaN where the op gives 0.0;
    this data has neither)."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import segment_max_ref

    x, seg, n = args
    e = x.shape[0]
    got = fused_gnn.segment_max(x, seg, n)
    err = check_bitwise(f"segment_max on the path's call E={e} n={n}", got,
                        segment_max_ref(x, seg, n))
    ok = (seg >= 0) & (seg < n)
    xs, sl = x[ok].contiguous(), seg[ok].long()
    base = torch.full((n,), float("-inf"), dtype=x.dtype, device=x.device)
    lib = base.scatter_reduce(0, sl, xs, "amax")
    check_bitwise("scatter_reduce amax on the same call (empty rows to 0.0)",
                  torch.where(torch.isfinite(lib), lib, 0.0), got)
    keys = fused_gnn.segment_max_keys(n, x.device)
    ms = graph_ms(rotating(fused_gnn.segment_max, x, seg, n))
    return {
        "name": "segment_max",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_max.cu",
        "replaces": "src/repro/kernels/fused_gnn.py:348",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "kernel_ms": graph_ms(rotating(fused_gnn.launch_segment_max, x, seg, keys,
                                       torch.empty_like(got))),
        "eager_ms": time_ms(rotating(fused_gnn.segment_max, x, seg, n)),
        "plain_ms": time_ms(rotating(segment_max_ref, x, seg, n)),
        **bound_fields(hw, "segment_max",
                       {"edges": e, "segments": n, "dtype_bytes": x.element_size()}, ms),
        "library_ms": time_ms(rotating(lambda v, i: base.scatter_reduce(0, i, v, "amax"),
                                       xs, sl)),
        "shape": {"E": e, "valid_edges": int(ok.sum()), "n": n, "dtype": str(x.dtype)},
    }


# ---------------------------------------------------------------------------
# phases 4-5: the serving path at full width
# ---------------------------------------------------------------------------


class SliceRecorder:
    """Wraps a layer's tensor slice (or another call): keeps its first
    call's arguments and brackets every call with CUDA events (no host
    sync)."""

    def __init__(self, fn):
        self.fn = fn
        self.first = None
        self.events = []

    def __call__(self, *args):
        if self.first is None:
            self.first = args
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        stop.record()
        self.events.append((start, stop))
        return out

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class LargestCall:
    """Wraps a kernel entry point and keeps the arguments of its largest
    call by ``size(args)`` (default: elements of the messages, the third
    argument from the end): the path's biggest kernel shape."""

    def __init__(self, fn, size=lambda args: args[-3].numel()):
        self.fn = fn
        self.size = size
        self.args = None

    def __call__(self, *args):
        if self.args is None or self.size(args) > self.size(self.args):
            self.args = args
        return self.fn(*args)


@contextmanager
def host_timers(totals: dict):
    """Host seconds spent in the engine's stages, by stage, into
    ``totals``: sampling waits, cache fills and reads, store writes, and
    the padded device slice (copies in and out included)."""
    from repro_torch.core.inference.engine import LayerwiseInferenceEngine
    from repro_torch.core.sampling.service import SampleTicket
    from repro_torch.core.storage import DFSTier, HybridCache

    targets = [
        (SampleTicket, "result", "sampling_wait"),
        (HybridCache, "fill", "cache_fill"),
        (HybridCache, "read_rows", "cache_read"),
        (DFSTier, "write_rows", "store_write"),
        (LayerwiseInferenceEngine, "_run_slice", "device_slice"),
    ]
    patches = []
    for owner, attr, label in targets:
        def timed(*args, _orig=getattr(owner, attr), _label=label, **kw):
            t0 = time.perf_counter()
            try:
                return _orig(*args, **kw)
            finally:
                totals[_label] = totals.get(_label, 0.0) + time.perf_counter() - t0
        patches.append(mock.patch.object(owner, attr, timed))
    for pt in patches:
        pt.start()
    try:
        yield totals
    finally:
        for pt in patches:
            pt.stop()


@contextmanager
def plain_aggregation():
    """The model's aggregation through the plain versions, on the card."""
    from repro_torch.models.gnn import models

    with mock.patch.object(models, "gnn_aggregate_and_count", plain_sum_and_count), \
            mock.patch.object(models, "gnn_gat_aggregate", plain_gat):
        yield


def zipf_requests(g, count: int, seed: int) -> list:
    """``count`` requests of 1-16 vertices drawn Zipf(1.1) over vertices
    ranked by degree: the power-law popularity GLISP's serving assumes."""
    deg = g.out_degrees() + g.in_degrees()
    by_pop = np.argsort(-deg, kind="stable")
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(count):
        ranks = np.minimum(rng.zipf(1.1, int(rng.integers(1, 17))) - 1, g.num_vertices - 1)
        reqs.append(by_pop[ranks])
    return reqs


def serve(system, reqs, kernel: str, launches: dict) -> dict:
    """Serve ``reqs`` batched (all admitted, then drained), then each solo;
    every response must have the same bits both ways (every batch runs at
    the engine's one serving shape). Returns serving numbers."""
    from repro_torch.kernels import fused_gnn

    fused_gnn.reset_launches()
    batched = system.server(max_batch_delay_ms=1e6, deadline_ms=None)
    t0 = time.perf_counter()
    rids = [batched.submit(v) for v in reqs]
    batched.drain()
    batched_s = time.perf_counter() - t0
    solo = system.server(max_batch_delay_ms=0.0, deadline_ms=None)
    t0 = time.perf_counter()
    solo_out = [solo.call(v) for v in reqs]
    solo_s = time.perf_counter() - t0
    launches[kernel] += fused_gnn.LAUNCHES[kernel]
    per_batch = 2 if kernel == "segment_spmm_ragged" else 1
    batches = batched.stats.batches + solo.stats.batches
    if fused_gnn.LAUNCHES[kernel] != per_batch * batches:
        fail(f"serving launched {kernel} {fused_gnn.LAUNCHES[kernel]} times "
             f"for {batches} batches")
    bitwise, diff = 0, 0.0
    for rid, s in zip(rids, solo_out):
        b = batched.response(rid)
        if b.status != "ok" or s.status != "ok":
            fail(f"request {rid}: status {b.status}/{s.status}")
        if b.embeddings.shape != (len(reqs[rid]), s.embeddings.shape[1]):
            fail(f"request {rid}: shape {b.embeddings.shape}")
        if not np.all(np.isfinite(b.embeddings)):
            fail(f"request {rid}: non-finite embeddings")
        bitwise += int(np.array_equal(b.embeddings, s.embeddings))
        diff = max(diff, float(np.abs(b.embeddings - s.embeddings).max()))
    lat = solo.stats.latency
    out = {
        "requests": len(reqs),
        "batched_batches": batched.stats.batches,
        "batched_s": batched_s,
        "solo_s": solo_s,
        "solo_p50_ms": lat.p50,
        "solo_p99_ms": lat.p99,
        "batched_p50_ms": batched.stats.latency.p50,
        "batched_p99_ms": batched.stats.latency.p99,
        "bitwise_equal": f"{bitwise}/{len(reqs)}",
        "max_batched_vs_solo_diff": diff,
        "serving_shape": list(system.infer_engine.serving_shape(
            len(system.infer_engine.layer_fns) - 1, 1, 1)),
        "launches": fused_gnn.LAUNCHES[kernel],
    }
    log(f"  serve {kernel}: " + json.dumps(out))
    if bitwise != len(reqs):
        fail(f"serving {kernel}: only {bitwise}/{len(reqs)} responses bitwise equal batched "
             f"vs solo (max difference {diff})")
    return out


def run_model(system, kind: str, kernel: str, launches: dict, captured: dict,
              passes: dict) -> dict:
    from repro_torch.kernels import fused_gnn
    from repro_torch.models.gnn import GNNModel, load_jax_params, models

    g = system.graph
    model = GNNModel(kind, 128, hidden=256, num_layers=3, num_heads=4, device="cuda")
    load_jax_params(model, model.init_numpy(0))
    fns = [model.embed_layer_fn(k) for k in range(3)]
    recorders = [SliceRecorder(fn.torch) for fn in fns]
    for fn, rec in zip(fns, recorders):
        fn.torch = rec
    entry = "gnn_aggregate_and_count" if kernel == "segment_spmm_ragged" else "gnn_gat_aggregate"
    largest = LargestCall(getattr(models, entry))
    workdir = WORKDIR / kind
    stages: dict = {}
    fused_gnn.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(models, entry, largest), host_timers(stages):
        res = system.infer_layerwise(fns, str(workdir), out_dims=[256, 256, 256], device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = dict(fused_gnn.LAUNCHES)
    batches = res.device_batches()
    per_batch = 2 if kernel == "segment_spmm_ragged" else 1
    if got[kernel] != per_batch * batches or batches == 0:
        fail(f"{kind}: {got[kernel]} launches of {kernel} for {batches} engine batches")
    other = [k for k in got if k != kernel and got[k]]
    if other:
        fail(f"{kind}: unexpected launches {got}")
    launches[kernel] += got[kernel]
    captured[kernel] = largest.args
    final = res.final_store.read_rows(np.arange(g.num_vertices))
    if final.shape != (g.num_vertices, 256) or not np.all(np.isfinite(final)):
        fail(f"{kind}: final store {final.shape}, finite={np.all(np.isfinite(final))}")
    # what the autotune phase's tuned pass must repeat bit for bit
    passes[kind] = {"fns": fns, "kernel": kernel, "launches": got[kernel], "wall_s": wall_s,
                    "stores": [s.read_rows(np.arange(g.num_vertices))
                               for s in system.infer_engine.layer_stores[1:]]}
    slice_ms = sum(r.device_ms() for r in recorders)
    passes[kind]["slice_ms"] = slice_ms
    info = {
        "wall_s": wall_s,
        "engine_batches": batches,
        "launches": got[kernel],
        "slice_device_span_ms": slice_ms,
        "device_idle_share": 1.0 - slice_ms / 1e3 / wall_s,
        "host_stage_s": stages,
        "buckets": {str(k): v for k, v in res.layer_stats[-1].bucket_batches.items()},
    }
    log(f"  infer_layerwise {kind}: " + json.dumps(info))
    # layer 0's first batch again, through the plain aggregation, on the card
    first = recorders[0].first
    with torch.no_grad():
        kern = model.layer_slice(0, *first)
        with plain_aggregation():
            plain = model.layer_slice(0, *first)
    check_close(f"{kind} layer-0 first batch kernel vs plain", kern, plain,
                tol=(1e-4, 1e-5))
    info["serve"] = serve(system, zipf_requests(g, 32, 1), kernel, launches)
    info["samplewise"] = samplewise(system, kind, kernel, fns, wall_s, launches)
    return info


# ---------------------------------------------------------------------------
# the autotune phase: every launch shape bitwise, and a tuned pass per model
# ---------------------------------------------------------------------------

# (label, E, n, D): the passes' largest engine bucket (D 64 for the GAT
# aggregate: 256 over 4 heads), rows of about 3 x SUM_CHUNK slots (the
# long-row chunks), and the count's D = 1
TUNE_CHECK_SHAPES = (("bucket", 65536, 4096, 256), ("long rows", 16384, 64, 128),
                     ("count", 65536, 4096, 1))


def autotune_candidates() -> dict:
    """Every valid launch shape of every tuned op (``autotune.valid_candidates``)
    at ``TUNE_CHECK_SHAPES``, float32 and bf16, on the tuner's own inputs:
    bitwise the heuristic's output, which for the sums must have the bits
    of ``ref.chunked_segment_sum_ref`` and for the segment max those of
    ``ref.segment_max_ref``. Returns the launch shapes checked by op."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.ref import chunked_segment_sum_ref, segment_max_ref

    checked: dict = {}
    batched_f32 = 0
    for op in at.TUNED_OPS:
        for label, e, n, d in TUNE_CHECK_SHAPES:
            if op == "gat_softmax_aggregate" and label == "bucket":
                d = 64
            for dtype in (torch.float32, torch.bfloat16):
                inp = at._inputs(op, (e, n, d), dtype)
                launch = at._kernel(op, inp)
                cands = at.valid_candidates(op, (e, n, d), dtype)
                want = launch(cands[0]).clone()
                seg, idx = inp["seg"], inp["idx"]
                if op == "segment_max":
                    model = segment_max_ref(inp["logits"], seg, n)
                elif op.startswith("segment"):
                    model = chunked_segment_sum_ref(inp["msg"], seg, n).to(dtype)
                elif op.startswith("gather"):
                    model = chunked_segment_sum_ref(inp["feats"][idx.clamp_min(0).long()], seg,
                                                    n, idx >= 0).to(dtype)
                else:
                    model = None
                if model is not None and not torch.equal(bits(want), bits(model)):
                    fail(f"autotune {op} {label} {dtype}: the heuristic's launch is not "
                         "bitwise the plain model")
                for cfg in cands[1:]:
                    got = launch(cfg)
                    if not torch.equal(bits(got), bits(want)):
                        differ = int((bits(got) != bits(want)).sum())
                        fail(f"autotune {op} {label} {dtype}: {cfg} differs from the "
                             f"heuristic's {cands[0]} in {differ} elements")
                lean0 = sum(c.lean == 0 for c in cands) if op != "gat_softmax_aggregate" else 0
                if dtype == torch.float32:
                    batched_f32 += lean0
                checked[op] = checked.get(op, 0) + len(cands)
                log(f"  ok autotune {op} {label} (E={e} n={n} D={d}) {str(dtype)[6:]}: "
                    f"{len(cands)} launch shapes bitwise the heuristic's {cands[0]}"
                    + ("" if model is None else " and the plain model")
                    + (f" ({lean0} of the batched build)" if lean0 else ""))
    if batched_f32 == 0:
        fail("autotune: the float32 batched build of the sum kernel never ran")
    checked["float32_batched_build"] = batched_f32
    return checked


def _shape_of(key: str) -> tuple:
    """(op, shape, dtype name) of an ``autotune.tuned_key`` string."""
    op, dims, dtype = key.split("/")
    return op, tuple(int(x) for x in dims.split("x")), dtype


def autotune_fresh_process(cache: str, keys: list) -> dict:
    """A new process tunes the recorded keys against ``cache``: each must
    be read from the artifact (``measured == 0``), with the same winner."""
    code = (
        "import dataclasses, json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "from repro_torch.kernels import autotune as at\n"
        "keys = json.loads(sys.argv[1])\n"
        "win = {}\n"
        "for key in keys:\n"
        "    op, dims, dt = key.split('/')\n"
        "    shape = tuple(int(x) for x in dims.split('x'))\n"
        "    at.autotune_for_slice([(op, shape)], dt, cache_dir=sys.argv[2])\n"
        "    win[key] = dataclasses.asdict(at.get_tuned(op, shape, dt))\n"
        "print(json.dumps({'stats': at.stats(), 'winners': win}))\n"
    )
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, json.dumps(keys), cache],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"autotune fresh process exited {out.returncode}: {out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["wall_s"] = time.perf_counter() - t0
    return got


def guard_repeat(system, run, cache: str, first, swept: int) -> dict:
    """``recompile_guard`` over the tuned SAGE pass (``first``: one sweep
    for each of its new (op, bucket, dtype) keys, ``swept`` of them in the
    tuner's record), then the same pass again through the same engine
    inside a second guard: no sweep and no new key. Prints both guards."""
    from repro_torch.analysis import recompile_guard

    if not first.compiles == first.new_shapes == swept > 0:
        fail(f"guard sage first pass: {first.compiles} sweeps for {first.new_shapes} new keys "
             f"({swept} swept)")
    log(f"  guard sage first tuned pass: {first.compiles} sweeps for {first.new_shapes} new "
        f"(op, bucket, dtype) keys, bound {first.bound}")
    engine = system.infer_engine
    t0 = time.perf_counter()
    with recompile_guard(system) as again:
        system.infer_layerwise(run["fns"], str(WORKDIR / "sage_tuned"), out_dims=[256, 256, 256],
                               device="cuda", kernel_autotune=True, kernel_cache_dir=cache)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if system.infer_engine is not engine or (again.compiles, again.new_shapes) != (0, 0):
        fail(f"guard sage repeat pass: {again.compiles} sweeps, {again.new_shapes} new keys "
             f"(same engine: {system.infer_engine is engine})")
    log(f"  guard sage repeat tuned pass: {again.compiles} sweeps, {again.new_shapes} new keys, "
        f"bound {again.bound}; wall {wall_s:.2f} s")
    return {"first": dataclasses.asdict(first), "repeat": dataclasses.asdict(again),
            "repeat_wall_s": wall_s}


def autotune_phase(system, passes: dict) -> dict:
    """``infer_layerwise(kernel_autotune=True, kernel_cache_dir=...)`` for
    each model of ``passes`` (run_model's untuned passes): its layer stores
    bitwise the untuned pass's, its launches the same, every launch reading
    a winner; each (op, bucket, dtype)'s heuristic and winner with their
    times; then the artifact from a fresh process, the refusal on a CPU
    device, and the table dropped so later phases launch as before."""
    from repro_torch.analysis import recompile_guard
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_gnn

    t_phase = time.perf_counter()
    checked = autotune_candidates()
    check_s = time.perf_counter() - t_phase
    cache = str(WORKDIR / "kernel_tune")
    at.reset()
    ids = np.arange(system.graph.num_vertices)
    info: dict = {"launch_shapes_checked": checked, "check_s": check_s, "passes": {}}
    for kind, run in passes.items():
        reads = {"launches": 0, "tuned": 0}

        def counted(op, shape, dtype, _orig=fused_gnn.get_tuned):
            cfg = _orig(op, shape, dtype)
            reads["launches"] += 1
            reads["tuned"] += cfg is not None
            return cfg

        recorders = [fn.torch for fn in run["fns"]]  # run_model's SliceRecorders
        seen = [len(r.events) for r in recorders]
        before = set(at.sweeps())
        fused_gnn.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(fused_gnn, "get_tuned", counted), \
                recompile_guard(system) as guard:
            system.infer_layerwise(run["fns"], str(WORKDIR / f"{kind}_tuned"),
                                   out_dims=[256, 256, 256], device="cuda",
                                   kernel_autotune=True, kernel_cache_dir=cache)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        slice_ms = sum(a.elapsed_time(b) for r, k in zip(recorders, seen) for a, b in r.events[k:])
        kernel = run["kernel"]
        if fused_gnn.LAUNCHES[kernel] != run["launches"]:
            fail(f"autotune {kind}: {fused_gnn.LAUNCHES[kernel]} launches of {kernel} tuned, "
                 f"{run['launches']} untuned")
        if reads["tuned"] != reads["launches"] or reads["launches"] != run["launches"]:
            fail(f"autotune {kind}: {reads['tuned']} of {reads['launches']} launches read a "
                 f"winner ({run['launches']} launches)")
        stores = system.infer_engine.layer_stores[1:]
        for k, (store, want) in enumerate(zip(stores, run["stores"])):
            got = store.read_rows(ids)
            if got.shape != want.shape or not np.array_equal(got.view(np.uint32),
                                                             want.view(np.uint32)):
                fail(f"autotune {kind}: layer {k + 1}'s tuned embeddings are not bitwise "
                     "the untuned pass's")
        log(f"  ok autotune {kind}: the tuned pass's {len(stores)} layer stores bitwise the "
            f"untuned pass's; {reads['tuned']} of {reads['launches']} launches read a winner")
        new = {k: v for k, v in at.sweeps().items() if k not in before}
        for key, v in new.items():
            h, w = v["heuristic"], v["winner"]
            log(f"  tuned {key}: heuristic vec {h['vec']} tpr {h['tpr']} lean {h['lean']} "
                f"{v['heuristic_ms']:.4f} ms -> winner vec {w['vec']} tpr {w['tpr']} "
                f"lean {w['lean']} {v['winner_ms']:.4f} ms ({v['candidates']} candidates, "
                f"sweep {v['sweep_s']:.3f} s)")
        sweep_s = sum(v["sweep_s"] for v in new.values())
        if kind == "sage":
            info["guard"] = guard_repeat(system, run, cache, guard, len(new))
        info["passes"][kind] = {
            "untuned_wall_s": run["wall_s"], "tuned_wall_s": wall_s,
            "untuned_slice_device_span_ms": run["slice_ms"],
            "tuned_slice_device_span_ms": slice_ms,
            "tuned_wall_less_sweeps_s": wall_s - sweep_s, "sweep_s": sweep_s,
            "keys": len(new), "winners_not_the_heuristic": sum(
                v["winner"] != v["heuristic"] for v in new.values()),
            "launches": run["launches"],
        }
    info["sweeps"] = at.sweeps()
    keys = sorted(info["sweeps"])
    fresh = autotune_fresh_process(cache, keys)
    want = {k: v["winner"] for k, v in info["sweeps"].items()}
    if fresh["stats"] != {"memory_hits": 0, "artifact_hits": len(keys), "measured": 0} or \
            fresh["winners"] != want:
        fail(f"autotune fresh process: {fresh['stats']} for {len(keys)} keys; winners equal "
             f"{fresh['winners'] == want}")
    log(f"  ok autotune fresh process: {len(keys)} keys from the artifact "
        f"({fresh['stats']}), the same winners, {fresh['wall_s']:.2f} s")
    info["fresh_process"] = {"stats": fresh["stats"], "wall_s": fresh["wall_s"]}
    try:
        at.autotune("segment_spmm_ragged", (256, 64, 16), torch.float32, device="cpu")
    except ValueError as err:
        log(f"  ok autotune on a CPU device raises: {err}")
    else:
        fail("autotune on a CPU device did not raise")
    at.reset()  # later phases launch with the heuristic, as before
    info["phase_s"] = time.perf_counter() - t_phase
    log("  autotune: " + json.dumps({k: v for k, v in info.items() if k != "sweeps"}))
    return info


def tuned_turns(rounds: int) -> int:
    """``--tuned-turns``: the SAGE and GAT layerwise passes without and with
    the tuner's winners, in turns. Per model one tuning pass
    (``kernel_autotune=True``, labelled ``tune``), then ``rounds`` times
    untuned, tuned, tuned, untuned; an untuned pass reads no winner
    (``fused_gnn.get_tuned`` patched to None), a tuned one the table the
    first pass filled. Per pass: wall s, the slices' device span ms and
    the aggregation's (CUDA events around each slice and each aggregate
    call), and its final store bitwise the first untuned pass's (it must
    be). Prints one line a pass, the card's name and power limit, and a
    JSON line with the medians by label."""
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph import named_dataset
    from repro_torch.kernels import fused_gnn
    from repro_torch.models.gnn import GNNModel, load_jax_params, models

    g = named_dataset("ogbn-paper", feat_dim=128, num_classes=16, seed=0, scale=1.0)
    system = GLISPSystem.build(g, GLISPConfig(num_parts=4, fanouts=(15, 10, 5), seed=0))
    ids = np.arange(g.num_vertices)
    order = ["tune"] + ["untuned", "tuned", "tuned", "untuned"] * rounds
    runs, medians = [], {}
    for kind, entry in (("sage", "gnn_aggregate_and_count"), ("gat", "gnn_gat_aggregate")):
        model = GNNModel(kind, 128, hidden=256, num_layers=3, num_heads=4, device="cuda")
        load_jax_params(model, model.init_numpy(0))
        fns = [model.embed_layer_fn(k) for k in range(3)]
        slices = [SliceRecorder(fn.torch) for fn in fns]
        for fn, rec in zip(fns, slices):
            fn.torch = rec
        agg = SliceRecorder(getattr(models, entry))
        want = None
        for i, label in enumerate(order):
            for rec in slices + [agg]:
                rec.events.clear()
            workdir = WORKDIR / f"{kind}_turn{i}"
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(models, entry, agg))
                if label == "untuned":
                    stack.enter_context(mock.patch.object(fused_gnn, "get_tuned",
                                                          lambda *a: None))
                t0 = time.perf_counter()
                res = system.infer_layerwise(fns, str(workdir), out_dims=[256, 256, 256],
                                             device="cuda", kernel_autotune=label != "untuned",
                                             kernel_cache_dir=str(WORKDIR / "kernel_tune"))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            final = res.final_store.read_rows(ids)
            want = final if want is None and label == "untuned" else want
            same = None if want is None else bool(np.array_equal(final.view(np.uint32),
                                                                 want.view(np.uint32)))
            run = {"model": kind, "pass": i, "label": label, "wall_s": wall_s,
                   "slice_device_span_ms": sum(r.device_ms() for r in slices),
                   "aggregate_device_span_ms": agg.device_ms(), "bitwise_first_untuned": same}
            log("  turn " + json.dumps(run))
            runs.append(run)
            shutil.rmtree(workdir, ignore_errors=True)
            if same is False:
                fail(f"{kind} pass {i} ({label}) changed the stores")
        for label in ("untuned", "tuned"):
            rows = [r for r in runs if r["model"] == kind and r["label"] == label]
            medians[f"{kind} {label}"] = {k: float(np.median([r[k] for r in rows])) for k in (
                "wall_s", "slice_device_span_ms", "aggregate_device_span_ms")}
    shutil.rmtree(WORKDIR, ignore_errors=True)
    log(device_line())
    log(json.dumps({"tuned_turns": rounds, "medians": medians}))
    return 0


SAMPLEWISE_TARGETS = 2048
SAMPLEWISE_BATCH = 256


def fresh_client(system):
    """A blocking gather-apply client over the system's partitions with
    fresh servers: two of them draw the same samples."""
    from repro_torch.core.sampling import GatherApplyClient, SamplingServer, VertexRouter

    cfg = system.config
    return GatherApplyClient(
        [SamplingServer(p, seed=cfg.seed) for p in system.partitions],
        VertexRouter(system.graph, system.plan.edge_parts, cfg.num_parts), seed=cfg.seed)


def samplewise(system, kind: str, kernel: str, fns, layerwise_wall_s: float,
               launches: dict) -> dict:
    """``samplewise_inference`` (the paper's baseline) over 2,048 seeded
    targets with the layerwise pass's layer callables: per batch of 256
    each target's 3-hop subgraph (fanouts 15/10/5) through the whole model.
    Counts zeroed just before, read just after; held against the same pass
    through the plain versions and against itself, each on a fresh,
    identically seeded client. Returns its numbers and the paper's two
    ratios against the layerwise pass: vertex-layer computations per
    target over K, and wall per target x N over the layerwise wall."""
    from repro_torch.core.inference import samplewise_inference
    from repro_torch.kernels import fused_gnn

    g = system.graph
    k = len(fns)
    targets = np.random.default_rng(7).choice(g.num_vertices, SAMPLEWISE_TARGETS, replace=False)
    fanouts = list(system.config.fanouts[:k])

    def run():
        return samplewise_inference(g, fresh_client(system), fns, g.vertex_feats, targets,
                                    fanouts=fanouts, batch_size=SAMPLEWISE_BATCH)

    fused_gnn.reset_launches()
    t0 = time.perf_counter()
    emb, stats = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = {name: v for name, v in fused_gnn.LAUNCHES.items() if v}
    batches = -(-SAMPLEWISE_TARGETS // SAMPLEWISE_BATCH)
    want = {kernel: (2 if kernel == "segment_spmm_ragged" else 1) * k * batches}
    if got != want:
        fail(f"{kind} sample-wise pass launched {got}, the path implies {want}")
    launches[kernel] += got.get(kernel, 0)
    if emb.shape != (SAMPLEWISE_TARGETS, 256) or not np.all(np.isfinite(emb)):
        fail(f"{kind} sample-wise embeddings {emb.shape}, finite={np.all(np.isfinite(emb))}")
    again, stats2 = run()
    if stats2 != stats or not np.array_equal(again, emb):
        fail(f"{kind} sample-wise pass is not bitwise equal run to run")
    with plain_aggregation():
        plain, stats_p = run()
    if stats_p != stats:
        fail(f"{kind} sample-wise counts differ through the plain versions")
    err = check_close(f"{kind} sample-wise pass, kernels vs plain versions",
                      torch.as_tensor(emb), torch.as_tensor(plain), tol=(1e-4, 1e-5))
    info = {
        "targets": SAMPLEWISE_TARGETS,
        "batch": SAMPLEWISE_BATCH,
        "fanouts": fanouts,
        "wall_s": wall_s,
        **stats,
        "launches": got,
        "runs_bitwise_equal": True,
        "max_abs_err_vs_plain": err,
        "computations_ratio": stats["vertices_computed"] / (k * SAMPLEWISE_TARGETS),
        "wall_ratio": wall_s / SAMPLEWISE_TARGETS * g.num_vertices / layerwise_wall_s,
    }
    log(f"  samplewise {kind}: " + json.dumps(info))
    return info


# ---------------------------------------------------------------------------
# phases 6-8: training at full width
# ---------------------------------------------------------------------------


TRAIN_STEPS = {"sage": 20, "gat": 10}
# kernel launches per training step that the 3-layer path implies: SAGE
# gathers once per layer and runs the gather backward for layers 1-2 (layer
# 0's input needs no gradient); GAT runs one softmax aggregate and its
# backward per layer, and two row gathers (z[src], z[dst]) per layer whose
# backwards are the gather kernel. Degrees come from the host: no segment
# sum.
PER_STEP = {
    "sage": {"gather_spmm_ragged": 3, "gather_spmm_ragged_backward": 2},
    "gat": {
        "gat_softmax_aggregate": 3,
        "gat_softmax_aggregate_backward": 3,
        "gather_spmm_ragged_backward": 6,
    },
}


def fresh_model(kind: str):
    from repro_torch.models.gnn import GNNModel, load_jax_params

    model = GNNModel(kind, 128, hidden=256, num_layers=3, num_classes=16, num_heads=4,
                     device="cuda")
    return load_jax_params(model, model.init_numpy(0))


class StepRecorder:
    """Wraps a trainer class's ``train_step`` (``GNNTrainer``'s by default):
    keeps the first call's first argument (the batch), the host clock at
    each step's start, and CUDA events around each step (forward,
    backward, update; no host sync)."""

    def __init__(self, trainer_cls=None):
        from repro_torch.train.loop import GNNTrainer

        self.cls = trainer_cls or GNNTrainer
        self.first = None
        self.starts = []
        self.events = []

    def patched(self):
        orig = self.cls.train_step

        def train_step(trainer, batch, *rest):
            self.starts.append(time.perf_counter())
            if self.first is None:
                self.first = batch
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(trainer, batch, *rest)
            stop.record()
            self.events.append((start, stop))
            return out

        return mock.patch.object(self.cls, "train_step", train_step)

    def device_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def gather_sum_in_row_order(feats, idx, seg, n):
    """``gather_spmm_ref``'s function summed as the kernel sums: each row
    from 0, adding its edges one at a time in index order, as plain tensor
    ops (autograd works). Step j adds each row's j-th edge with one
    ``index_add`` whose rows are distinct, so every addition is rounded
    once, in the kernel's order, and the result has the kernel's bits."""
    ok = (idx >= 0) & (seg >= 0) & (seg < n)
    edges = torch.nonzero(ok).squeeze(1)
    rows = seg[edges].long()
    by_row = torch.sort(rows, stable=True).indices
    edges, rows = edges[by_row], rows[by_row]
    counts = torch.bincount(rows, minlength=n)
    rank = torch.arange(rows.shape[0], device=rows.device) - (torch.cumsum(counts, 0) - counts)[rows]
    out = feats.new_zeros((n, feats.shape[1]))
    for j in range(int(counts.max()) if rows.numel() else 0):
        take = rank == j
        out = out.index_add(0, rows[take], feats.index_select(0, idx[edges[take]].long()))
    return out


@contextmanager
def plain_training():
    """The training layers' aggregations and gathers through the plain
    versions (autograd through them), on the card. The gcn/sage gather sums
    in the kernel's order: ReLU follows it, and a pre-activation within
    float noise of 0 would otherwise take the other side of the kink and
    move a gradient element by its whole upstream value (one run in three
    at full width), which says nothing about the kernels."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.models.gnn import models

    def gather(feats, idx, seg, n, idx_order=None):
        return gather_sum_in_row_order(feats, idx, seg, n)

    def rows(x, idx, idx_order=None):
        return fused_gnn._rows(x, idx)

    with mock.patch.object(models, "gnn_gather_aggregate", gather), \
            mock.patch.object(models, "gather_rows", rows), \
            mock.patch.object(models, "gnn_gat_aggregate", plain_gat):
        yield


def compare_first_batch(kind: str, batch) -> float:
    """The loss and every parameter gradient of one batch from the same
    start, kernels vs plain versions; returns the largest gradient error."""
    def loss_and_grads():
        model = fresh_model(kind)
        loss = model.loss(batch)
        loss.backward()
        return loss.detach(), [(name, p.grad) for name, p in model.named_parameters()]

    loss_k, grads_k = loss_and_grads()
    with plain_training():
        loss_p, grads_p = loss_and_grads()
    tol = (1e-4, 1e-6)
    check_close(f"{kind} first training batch: loss, kernels vs plain", loss_k[None],
                loss_p[None], tol=tol)
    return max(
        check_close(f"{kind} first training batch: d {name}", a, b, tol=tol)
        for (name, a), (_, b) in zip(grads_k, grads_p)
    )


def keep_largest(captured: dict, name: str, call: LargestCall) -> None:
    if call.args is not None and (
        name not in captured or call.size(call.args) > call.size(captured[name])
    ):
        captured[name] = call.args


def train_model(system, kind: str, train_ids, launches: dict, captured: dict) -> dict:
    """``system.trainer(model, train_ids).train(max_steps=...)`` with the
    config's prefetch; checks the launches and the losses, then holds the
    first batch against the plain versions."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.models.gnn import models

    steps = TRAIN_STEPS[kind]
    trainer = system.trainer(fresh_model(kind), train_ids)
    rec = StepRecorder()
    edge_width = lambda a: a[1].shape[0] * a[0].shape[1]  # noqa: E731  edges x D
    calls = {
        "gather_spmm_ragged": LargestCall(models.gnn_gather_aggregate, edge_width),
        "gather_spmm_ragged_backward": LargestCall(fused_gnn.gather_spmm_ragged_backward,
                                                   edge_width),
        "gat_softmax_aggregate_backward": LargestCall(fused_gnn.gat_softmax_aggregate_backward,
                                                      lambda a: a[2].numel()),
    }
    fused_gnn.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with rec.patched(), \
                mock.patch.object(models, "gnn_gather_aggregate", calls["gather_spmm_ragged"]), \
                mock.patch.object(fused_gnn, "gather_spmm_ragged_backward",
                                  calls["gather_spmm_ragged_backward"]), \
                mock.patch.object(fused_gnn, "gat_softmax_aggregate_backward",
                                  calls["gat_softmax_aggregate_backward"]):
            tlog = trainer.train(max_steps=steps, log_every=1)
        torch.cuda.synchronize()
    finally:
        trainer.pipeline.close()
    wall_s = time.perf_counter() - t0
    got = {k: v for k, v in fused_gnn.LAUNCHES.items() if v}
    want = {k: v * steps for k, v in PER_STEP[kind].items()}
    if got != want:
        fail(f"{kind} training launched {got}, the path implies {want}")
    for name, n in got.items():
        launches[name] += n
    for name, call in calls.items():
        keep_largest(captured, name, call)
    losses = tlog.losses
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"{kind} training losses {losses}")
    step_ms = rec.device_ms()
    span_s = sum(step_ms) / 1e3
    gaps = np.diff(rec.starts) * 1e3
    b = rec.first
    info = {
        "steps": steps,
        "wall_s": wall_s,
        "step_wall_ms_mean": wall_s / steps * 1e3,
        "step_wall_ms_steady_median": float(np.median(gaps)) if gaps.size else None,
        "step_host_ms_mean": tlog.compute_time / steps * 1e3,
        "sample_time_s": tlog.sample_time,
        "step_device_span_ms": step_ms,
        "device_span_s": span_s,
        "device_idle_share": 1.0 - span_s / wall_s,
        "losses": losses,
        "layer0_batch": {
            "vertices": int(b.valid.sum()),
            "padded_vertices": int(b.feats.shape[0]),
            "edges": int((b.layer_dst[0] >= 0).sum()),
            "padded_edges": int(b.layer_dst[0].shape[0]),
        },
        "launches": got,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"  train {kind}: " + json.dumps(info))
    info["first_batch_max_grad_err"] = compare_first_batch(kind, b)
    return info


# 20,000 / 200,000 vertices: the largest scale tried that keeps the phase
# under about 60 s (tools/time_launcher.py: about 47 s at 0.5, 98 s at the
# stand-ins' full 40,000 / 400,000, where sampling grows each gcn step)
LAUNCH_SCALE = 0.5
# kernel launches per training step and per evaluation batch that the
# launcher's configs imply: gcn (3 layers) gathers once per layer with the
# host's degrees, and runs the gather backward for layers 1-2; hgt (2
# layers) runs one softmax aggregate and its backward per layer, and row
# gathers q[dst] (both layers) and h[src] (layer 1: layer 0's input needs
# no gradient) whose backwards are the gather kernel
LAUNCH_PER_STEP = {
    "gcn-products": {"gather_spmm_ragged": 3, "gather_spmm_ragged_backward": 2},
    "hgt-relnet": {"gat_softmax_aggregate": 2, "gat_softmax_aggregate_backward": 2,
                   "gather_spmm_ragged_backward": 3},
}
LAUNCH_PER_EVAL = {"gcn-products": {"gather_spmm_ragged": 3},
                   "hgt-relnet": {"gat_softmax_aggregate": 2}}


def launcher_train(config: str, launches: dict) -> dict:
    """``python -m repro_torch.launch.train gnn --config <config>`` in
    process (one epoch at ``LAUNCH_SCALE``, on the card by default):
    counts zeroed just before, read just after, against the steps and
    evaluation batches the run took."""
    from repro_torch.configs.gnn import get_gnn_config
    from repro_torch.graph.generate import DATASETS
    from repro_torch.kernels import fused_gnn
    from repro_torch.launch import train as launcher

    cfg = get_gnn_config(config)
    rec = StepRecorder()
    fused_gnn.reset_launches()
    t0 = time.perf_counter()
    with rec.patched():
        out = launcher.main(["gnn", "--config", config, "--scale", str(LAUNCH_SCALE),
                             "--log-every", "1"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = {k: v for k, v in fused_gnn.LAUNCHES.items() if v}
    steps = len(rec.starts)
    vertices = max(64, int(DATASETS[cfg.dataset]["num_vertices"] * LAUNCH_SCALE))
    evals = min(8, (vertices - int(0.8 * vertices)) // cfg.batch_size)
    want = dict.fromkeys(LAUNCH_PER_STEP[config], 0)
    for name, n in LAUNCH_PER_STEP[config].items():
        want[name] += n * steps
    for name, n in LAUNCH_PER_EVAL[config].items():
        want[name] += n * evals
    if got != want or steps == 0:
        fail(f"{config}: launched {got} in {steps} steps and {evals} evaluation batches, "
             f"the path implies {want}")
    for name, n in got.items():
        launches[name] += n
    losses = out["losses"]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"{config}: losses {losses[:4]}... for {steps} steps")
    gaps = np.diff(rec.starts) * 1e3
    step_ms = rec.device_ms()
    info = {
        "config": config,
        "model": f"{cfg.model}-{cfg.num_layers}x{cfg.hidden}"
                 + (f", {cfg.num_heads} heads" if cfg.model in ("gat", "hgt") else ""),
        "scale": LAUNCH_SCALE,
        "vertices": vertices,
        "steps": steps,
        "eval_batches": evals,
        "wall_s": wall_s,
        "step_wall_ms_steady_median": float(np.median(gaps)) if gaps.size else None,
        "step_device_ms_median": float(np.median(step_ms)),
        "device_idle_share_steady": 1.0 - float(np.median(step_ms) / np.median(gaps))
        if gaps.size else None,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "test_acc": out["test_acc"],
        "sample_time_s": out["sample_time_s"],
        "launches": got,
    }
    log(f"  launch.train {config}: " + json.dumps(info))
    return info


def determinism(system, kind: str, train_ids, steps: int = 6, cut: int = 3) -> dict:
    """Two runs from the same start, and a run checkpointed at ``cut`` and
    resumed in a new trainer, must end with bit-identical parameters and
    optimizer state."""
    from repro_torch.train.optim import tree_leaves

    def run(stop, resume=None):
        tr = system.trainer(fresh_model(kind), train_ids)
        try:
            if resume is not None:
                tr.resume(resume)
            tr.train(max_steps=stop)
        finally:
            tr.pipeline.close()
        return tr

    def state(tr):
        return tree_leaves({"params": tr.params, "opt": tr.opt_state})

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(state(a), state(b)))

    first, second = run(steps), run(steps)
    path = run(cut).save(str(WORKDIR / f"{kind}_step{cut}.npz"), step=cut)
    resumed = run(steps, resume=path)
    out = {"steps": steps, "checkpoint_step": cut,
           "two_runs_bitwise_equal": equal(first, second),
           "resumed_bitwise_equal": equal(first, resumed)}
    log(f"  determinism {kind}: " + json.dumps(out))
    if not (out["two_runs_bitwise_equal"] and out["resumed_bitwise_equal"]):
        fail(f"{kind} training is not bit-reproducible: {out}")
    return out


# ---------------------------------------------------------------------------
# the distributed tier: forked sampling workers and data-parallel training
# ---------------------------------------------------------------------------

DIST_REQUESTS = 64
DIST_SEEDS = 256
DIST_KEY = 0xD15B
DIST_AFTER_KILL = 8
DP_SHARDS = (1, 2, 4)
DP_STEPS = 8
DP_SEEDS_PER_SHARD = 256
DP_TOL = (1e-5, 1e-6)  # merged step vs the per-shard twin: the reference's own bound


def dist_requests(g, count: int, first: int = 0) -> list:
    """``count`` requests of ``DIST_SEEDS`` distinct seeds, keys
    ``(DIST_KEY, i)``, request i's seeds drawn with seed i."""
    return [((DIST_KEY, i), np.sort(np.random.default_rng(i).choice(
        g.num_vertices, DIST_SEEDS, replace=False))) for i in range(first, first + count)]


def same_sample(a, b) -> bool:
    return len(a.hops) == len(b.hops) and all(
        np.array_equal(x.src, y.src) and np.array_equal(x.dst, y.dst)
        and np.array_equal(x.eid, y.eid) for x, y in zip(a.hops, b.hops))


def answer(system, reqs) -> tuple[list, float]:
    """Every request through ``system.sample``, one after another; the
    answers and the wall seconds."""
    t0 = time.perf_counter()
    subs = [system.sample(seeds, key=key) for key, seeds in reqs]
    return subs, time.perf_counter() - t0


def remote_sampling(remote, transport: str, reqs, want: list, local_s: float) -> dict:
    """The requests through a system whose servers are forked workers:
    every answer bitwise the in-process system's."""
    pool = remote.backend.service.dispatcher
    pool.drain_latencies()
    got, wall = answer(remote, reqs)
    lat = np.asarray(pool.drain_latencies())
    same = sum(same_sample(a, b) for a, b in zip(got, want))
    out = {
        "requests": len(reqs), "bitwise_equal_to_inproc": same,
        "requests_per_s": len(reqs) / wall, "inproc_requests_per_s": len(reqs) / local_s,
        "dispatches": int(lat.size),
        "dispatch_ms_p50": float(np.percentile(lat, 50)),
        "dispatch_ms_p95": float(np.percentile(lat, 95)),
        "server_workloads": [float(w) for w in remote.server_workloads()],
    }
    log(f"  sampling over {transport} workers: " + json.dumps(out))
    if same != len(reqs):
        fail(f"{transport}: {len(reqs) - same} of {len(reqs)} answers differ from in process")
    return out


class AggregateRecorder:
    """Keeps every call of the model's two aggregation entry points (the
    gather aggregate of gcn/sage, the softmax aggregate of gat/hgt)."""

    def __init__(self):
        self.calls = []

    @contextmanager
    def patched(self):
        from repro_torch.models.gnn import models

        def wrap(kind, fn):
            def call(*args):
                out = fn(*args)
                self.calls.append((kind, args, out))
                return out
            return call

        with mock.patch.object(models, "gnn_gather_aggregate",
                               wrap("gather", models.gnn_gather_aggregate)), \
                mock.patch.object(models, "gnn_gat_aggregate",
                                  wrap("gat", models.gnn_gat_aggregate)):
            yield self


@torch.no_grad()
def shard_mismatches(calls, num_shards: int, rows: int) -> list:
    """For each recorded merged call, per shard, the count of output
    elements whose bits differ from the shard's own launch over its rows
    and edges of the same inputs (the merged edges are dst-sorted, so
    shard s's edges are one run)."""
    from repro_torch.kernels import ops

    out = []
    for kind, args, merged in calls:
        seg = args[2]
        real = seg[seg >= 0]
        starts = torch.arange(num_shards + 1, device=seg.device, dtype=seg.dtype) * rows
        cuts = torch.searchsorted(real, starts).tolist()
        bad = []
        for s in range(num_shards):
            a, b, lo = cuts[s], cuts[s + 1], s * rows
            if kind == "gather":
                got = ops.gnn_gather_aggregate(args[0][lo:lo + rows].detach(),
                                               args[1][a:b] - lo, seg[a:b] - lo, rows)
            else:
                got = ops.gnn_gat_aggregate(args[0][a:b].detach(), args[1][a:b].detach(),
                                            seg[a:b] - lo, rows)
            bad.append(int((bits(got) != bits(merged[lo:lo + rows].detach())).sum()))
        out.append(bad)
    return out


def dp_train(remote, kind: str, num_shards: int, train_ids, launches: dict) -> dict:
    """``remote.dp_trainer(model, train_ids, num_shards=S, reference=True)
    .train(...)``: the merged step's losses within ``DP_TOL`` of the
    per-shard twin's, its launches one per layer whatever S (the twin's S),
    and the first step's merged aggregates bitwise each shard's own."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.train.data_parallel import shard

    tr = remote.dp_trainer(fresh_model(kind), train_ids, num_shards=num_shards,
                           batch_size=DP_SEEDS_PER_SHARD * num_shards, prefetch=0,
                           reference=True)
    seen = {"merged": [], "twin": []}
    events, first = [], {}

    def counted(name, fn):
        def step(batch):
            before = dict(fused_gnn.LAUNCHES)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(batch)
            stop.record()
            first.setdefault(name, batch)
            seen[name].append({k: v - before[k] for k, v in fused_gnn.LAUNCHES.items()
                               if v != before[k]})
            events.append((name, start, stop))
            return out
        return step

    fused_gnn.reset_launches()
    with mock.patch.object(tr, "merged_step", counted("merged", tr.merged_step)), \
            mock.patch.object(tr, "reference_step", counted("twin", tr.reference_step)):
        dlog = tr.train(log_every=1, max_steps=DP_STEPS)
    torch.cuda.synchronize()
    for name, n in fused_gnn.LAUNCHES.items():
        if n:
            launches[name] += n
    per_step = PER_STEP[kind]
    want = {"merged": per_step, "twin": {k: v * num_shards for k, v in per_step.items()}}
    for name in ("merged", "twin"):
        if len(seen[name]) != DP_STEPS or any(s != want[name] for s in seen[name]):
            fail(f"DP {kind} S={num_shards}: the {name} steps launched {seen[name]}, "
                 f"the path implies {want[name]} a step")
    losses, ref = np.asarray(dlog.losses), np.asarray(dlog.ref_losses)
    if len(losses) != DP_STEPS or not np.all(np.isfinite(losses)):
        fail(f"DP {kind} S={num_shards}: losses {dlog.losses}")
    if not np.allclose(losses, ref, rtol=DP_TOL[0], atol=DP_TOL[1]):
        fail(f"DP {kind} S={num_shards}: merged losses {dlog.losses} vs the per-shard "
             f"twin's {dlog.ref_losses}")
    device_ms = {n: [a.elapsed_time(b) for m, a, b in events if m == n]
                 for n in ("merged", "twin")}

    # the first step's merged forward, layer by layer, against each shard's
    # own launches on the same layer inputs (the kernels' row independence),
    # and against the per-shard loop's own forward, whose layer inputs come
    # from its matmuls over V rows, not S x V (cuBLAS gave them the same
    # bits here; a change of that shows as a failure of the second check
    # only)
    merged_batch = first["merged"]
    rows = merged_batch.feats.shape[0] // num_shards
    rec = AggregateRecorder()
    with torch.no_grad(), rec.patched():
        fresh_model(kind).apply(merged_batch)
    fused_gnn.reset_launches()  # the comparisons' launches count for nothing
    bad = shard_mismatches(rec.calls, num_shards, rows)
    if len(bad) != 3 or any(any(b) for b in bad):
        fail(f"DP {kind} S={num_shards}: merged aggregates differ from the shards' own "
             f"launches in {bad} elements (layer x shard)")
    twin = AggregateRecorder()
    stacked_first = first["twin"]
    with torch.no_grad(), twin.patched():
        model = fresh_model(kind)
        for s in range(num_shards):
            model.apply(shard(stacked_first, s).to(merged_batch.feats.device))
    twin_bad = []
    for k in range(3):
        merged_out = rec.calls[k][2]
        differ = 0
        for s in range(num_shards):
            mine = merged_out[s * rows:(s + 1) * rows]
            theirs = twin.calls[s * 3 + k][2]
            differ += int((bits(mine[: theirs.shape[0]]) != bits(theirs)).sum())
        twin_bad.append(differ)
    fused_gnn.reset_launches()
    if any(twin_bad):
        fail(f"DP {kind} S={num_shards}: merged aggregates differ from the per-shard loop's "
             f"forward in {twin_bad} elements (by layer)")

    wall_ms = np.asarray(dlog.wall) * 1e3
    span_ms = float(np.sum(device_ms["merged"]))
    info = {
        "kind": kind, "shards": num_shards, "global_batch": DP_SEEDS_PER_SHARD * num_shards,
        "steps": DP_STEPS, "losses": dlog.losses, "ref_losses": dlog.ref_losses,
        "max_rel_loss_diff": float(np.max(np.abs(losses - ref) / np.abs(ref))),
        "step_wall_ms_steady_median": float(np.median(wall_ms[1:])),
        "step_wall_ms": wall_ms.tolist(),
        "sample_s": dlog.sample_time, "compute_s": dlog.compute_time,
        "merged_step_device_ms_median": float(np.median(device_ms["merged"])),
        "twin_step_device_ms_median": float(np.median(device_ms["twin"])),
        "device_idle_share": 1.0 - span_ms / float(np.sum(wall_ms)),
        "merged_launches_per_step": seen["merged"][0],
        "twin_launches_per_step": seen["twin"][0],
        "merged_rows": int(merged_batch.feats.shape[0]),
        "merged_layer0_edges": int(merged_batch.layer_dst[0].shape[0]),
        "aggregates_bitwise_per_shard": True,
        "aggregates_bitwise_to_the_per_shard_loop": True,
    }
    log(f"  dp {kind} S={num_shards}: " + json.dumps(info))
    return info


def dist_phase(g, system, train_ids, launches: dict) -> dict:
    """Forked sampling workers (``dist_transport="mp"`` and ``"socket"``)
    against the in-process system, a worker killed and respawned, then
    data-parallel SAGE and GAT training over the ``mp`` workers at S = 1,
    2 and 4, then ``close()`` twice. The pools fork from this process, whose
    CUDA context has been live since the first phase."""
    import multiprocessing as mp
    import os
    import signal

    from repro_torch.api import GLISPSystem

    t0 = time.perf_counter()
    reqs = dist_requests(g, DIST_REQUESTS)
    want, local_s = answer(system, reqs)
    cache = str(WORKDIR / "partitions")
    out = {"inproc_requests_per_s": len(reqs) / local_s}
    remotes = {}
    try:
        for transport in ("mp", "socket"):
            tb = time.perf_counter()
            remotes[transport] = GLISPSystem.build(
                g, system.config.replace(dist_transport=transport), cache_dir=cache)
            out[f"{transport}_build_s"] = time.perf_counter() - tb
            out[transport] = remote_sampling(remotes[transport], transport, reqs, want, local_s)

        sock = remotes.pop("socket")
        sock_procs = [w.proc for w in sock.backend.service.dispatcher._workers]
        sock.close()
        sock.close()
        remote = remotes["mp"]
        pool = remote.backend.service.dispatcher
        victim = pool._workers[1].proc
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=10.0)
        after = dist_requests(g, DIST_AFTER_KILL, first=DIST_REQUESTS)
        got, _ = answer(remote, after)
        ref, _ = answer(system, after)
        same = sum(same_sample(a, b) for a, b in zip(got, ref))
        out["respawn"] = {"killed_pid": victim.pid, "respawns": pool.respawn_count,
                          "bitwise_equal_after": same, "requests_after": len(after)}
        log("  a worker killed: " + json.dumps(out["respawn"]))
        if pool.respawn_count != 1 or same != len(after):
            fail(f"respawn: {out['respawn']}")

        out["dp"] = {f"{kind}_s{s}": dp_train(remote, kind, s, train_ids, launches)
                     for kind in ("sage", "gat") for s in DP_SHARDS}
        procs = sock_procs + [w.proc for w in pool._workers]
        remotes.pop("mp")
        remote.close()
        tc = time.perf_counter()
        remote.close()
        out["second_close_s"] = time.perf_counter() - tc
    finally:
        for r in remotes.values():
            r.close()
    alive = [p.pid for p in procs if p.is_alive()]
    left = [p.pid for p in mp.active_children() if p.pid in {q.pid for q in procs}]
    out["workers_alive_after_close"] = alive + left
    out["active_children_after_close"] = len(mp.active_children())
    if alive or left:
        fail(f"close() left sampling workers running: {alive + left}")
    out["phase_s"] = time.perf_counter() - t0
    log("  dist: " + json.dumps({k: v for k, v in out.items() if k not in ("dp", "mp", "socket")}))
    return out


# ---------------------------------------------------------------------------
# phase 9: kernel times at the path's largest shape
# ---------------------------------------------------------------------------


COPIES = 4  # rotating input copies, so each timed call finds the 50 MB L2 cold


def rotating(fn, *args):
    """``fn`` over ``COPIES`` copies of ``args`` in turn: every call reads
    its inputs from device memory, as the path's fresh batches do."""
    sets = [args] + [
        tuple(a.clone() if torch.is_tensor(a) else a for a in args) for _ in range(COPIES - 1)
    ]
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_segment_sum(args, launches: int, hw: dict) -> dict:
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import segment_spmm_ref

    msg, seg, n = args
    e, d = msg.shape
    index = fused_gnn.segment_index(seg, n)
    if int(index[n + 1]):
        fail("the path's seg was not sorted")
    valid = int(index[n])
    got = fused_gnn.segment_spmm_ragged(msg, seg, n)
    err = check_close(f"segment_spmm_ragged on the path's largest batch E={e} D={d}",
                      got, segment_spmm_ref(msg, seg, n))
    offsets = index[: n + 1].long()
    data = msg[:valid]
    lib = torch.segment_reduce(data, "sum", offsets=offsets, axis=0)
    check_close("torch.segment_reduce on the same batch", lib, got)
    out = torch.empty_like(got)
    ms = graph_ms(rotating(fused_gnn.segment_spmm_ragged, msg, seg, n))
    return {
        "name": "segment_spmm_ragged",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/fused_gnn.py:220",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "kernel_ms": graph_ms(rotating(fused_gnn.launch_segment_sum, msg, seg, index, out)),
        "eager_ms": time_ms(rotating(fused_gnn.segment_spmm_ragged, msg, seg, n)),
        "plain_ms": time_ms(rotating(segment_spmm_ref, msg, seg, n)),
        **bound_fields(hw, "segment_spmm_ragged",
                       {"edges": e, "segments": n, "dim": d, "valid_edges": valid,
                        "dtype_bytes": msg.element_size()}, ms),
        "library_ms": time_ms(rotating(
            lambda x, o: torch.segment_reduce(x, "sum", offsets=o, axis=0), data, offsets
        )),
        "shape": {"E": e, "valid_edges": valid, "n": n, "D": d, "dtype": str(msg.dtype)},
    }


def time_gat(args, launches: int, hw: dict) -> dict:
    from repro_torch.kernels import fused_gnn

    logits, msg, seg, n = args
    e, h, dh = msg.shape
    index = fused_gnn.segment_index(seg, n)
    if int(index[n + 1]):
        fail("the path's seg was not sorted")
    valid = int(index[n])
    lf = logits.float().contiguous()
    got = fused_gnn.gat_softmax_aggregate(logits, msg, seg, n)
    err = check_close(f"gat_softmax_aggregate on the path's largest batch E={e} H={h} dh={dh}",
                      got, plain_gat(logits, msg, seg, n))
    out = torch.empty_like(got)
    ms = graph_ms(rotating(fused_gnn.gat_softmax_aggregate, logits, msg, seg, n))
    return {
        "name": "gat_softmax_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gat_softmax_aggregate.cu",
        "replaces": "src/repro/kernels/fused_gnn.py:285",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "kernel_ms": graph_ms(
            rotating(fused_gnn.launch_gat_softmax_aggregate, lf, msg, seg, index, out)
        ),
        "eager_ms": time_ms(rotating(fused_gnn.gat_softmax_aggregate, logits, msg, seg, n)),
        "plain_ms": time_ms(rotating(plain_gat, logits, msg, seg, n)),
        **bound_fields(hw, "gat_softmax_aggregate",
                       {"edges": e, "segments": n, "dim": dh, "heads": h, "valid_edges": valid,
                        "dtype_bytes": msg.element_size()}, ms),
        "library_ms": None,
        "shape": {"E": e, "valid_edges": valid, "n": n, "H": h, "dh": dh,
                  "dtype": str(msg.dtype)},
    }


def adjacency(rows, cols, shape):
    """The CSR matrix with ``A[r, c]`` = the number of edges (r, c): the
    sparse operand of the gather sums' library yardstick."""
    ones = torch.ones(rows.shape[0], device=rows.device)
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]), ones, shape)
    return coo.coalesce().to_sparse_csr()


def sparse_mm_from_ids(seg, idx, x, n):
    """``torch.sparse.mm`` of x by the adjacency built from the unsorted
    ids themselves (the edges kept, COO, coalesced, CSR): the library
    route from the dense gather's own inputs, every step of it timed."""
    ok = (seg >= 0) & (seg < n) & (idx >= 0)
    return torch.sparse.mm(adjacency(seg[ok], idx[ok], (n, x.shape[0])), x)


def gather_row_dict(name, replaces, launches, err, fn, args, kernel_args, plain, lib, hw,
                    kshape, shape) -> dict:
    """A gather row: ``name`` is also its roofline op, ``kshape`` its shape."""
    from repro_torch.kernels import fused_gnn

    with torch.no_grad():
        ms = graph_ms(rotating(fn, *args))
        return {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "kernel_ms": graph_ms(rotating(fused_gnn.launch_gather_sum, *kernel_args)),
            "eager_ms": time_ms(rotating(fn, *args)),
            "plain_ms": time_ms(rotating(plain, *args[:4])),
            **bound_fields(hw, name, kshape, ms),
            "library_ms": time_ms(rotating(lib, args[0])),
            "shape": shape,
        }


def time_gather(args, launches: int, hw: dict) -> dict:
    """Kernel 3 at the training path's largest gather. Bound
    (``gather_spmm_ragged``): the distinct gathered rows read once, idx and
    seg, the output written once."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import gather_spmm_ref

    feats, idx, seg, n, order = args
    feats = feats.detach()
    f, d = feats.shape
    index = fused_gnn.segment_index(seg, n)
    if int(index[n + 1]):
        fail("the path's seg was not sorted")
    ok = (idx >= 0) & (seg >= 0)
    valid = int(ok.sum())
    rows = int(torch.unique(idx[ok]).numel())
    with torch.no_grad():
        got = fused_gnn.gather_spmm_ragged(feats, idx, seg, n, order)
    err = check_close(f"gather_spmm_ragged on the path's largest call E={idx.shape[0]} D={d}",
                      got, gather_spmm_ref(feats, idx, seg, n))
    a = adjacency(seg[ok], idx[ok], (n, f))
    check_close("torch.sparse.mm of the CSR adjacency on the same call",
                torch.sparse.mm(a, feats), got)
    return gather_row_dict(
        "gather_spmm_ragged", "src/repro/kernels/fused_gnn.py:159", launches, err,
        fused_gnn.gather_spmm_ragged, (feats, idx, seg, n, order),
        (feats, idx, seg, index, torch.empty_like(got)), gather_spmm_ref,
        lambda x: torch.sparse.mm(a, x), hw,
        {"edges": idx.shape[0], "segments": n, "dim": d, "valid_edges": valid,
         "rows_read": rows, "dtype_bytes": feats.element_size()},
        {"E": idx.shape[0], "valid_edges": valid, "distinct_rows_read": rows, "F": f, "n": n,
         "D": d, "dtype": str(feats.dtype)},
    )


def time_gather_backward(args, launches: int, hw: dict) -> dict:
    """Kernel 3 as the backward of the gathers, at the largest call on the
    training path: dfeats[f] = sum_{idx[e]==f} grad[seg[e]] over the
    idx-sorted edges. Bound (``gather_spmm_ragged_backward``): the distinct
    gradient rows read once, idx, seg and the order, the output written
    once."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import gather_spmm_ragged_backward_ref

    grad, idx, seg, f, order = args
    grad = grad.detach().contiguous()
    n, d = grad.shape
    got = fused_gnn.gather_spmm_ragged_backward(grad, idx, seg, f, order)
    err = check_close(
        f"gather_spmm_ragged_backward on the path's largest call E={idx.shape[0]} D={d}",
        got, gather_spmm_ragged_backward_ref(grad, idx, seg, f))
    g_idx, g_seg = fused_gnn._swapped(idx, seg, order, n)
    index = fused_gnn.segment_index(g_seg, f)
    if int(index[f + 1]):
        fail("the path's order does not sort idx")
    ok = (g_idx >= 0) & (g_seg >= 0)
    valid = int(ok.sum())
    rows = int(torch.unique(g_idx[ok]).numel())
    a = adjacency(g_seg[ok], g_idx[ok], (f, n))
    check_close("torch.sparse.mm of the transposed adjacency on the same call",
                torch.sparse.mm(a, grad), got)
    row = gather_row_dict(
        "gather_spmm_ragged_backward", "src/repro/kernels/fused_gnn.py:159", launches, err,
        fused_gnn.gather_spmm_ragged_backward, (grad, idx, seg, f, order),
        (grad, g_idx, g_seg, index, torch.empty_like(got)),
        gather_spmm_ragged_backward_ref, lambda x: torch.sparse.mm(a, x), hw,
        {"edges": idx.shape[0], "segments": f, "dim": d, "valid_edges": valid,
         "rows_read": rows, "dtype_bytes": grad.element_size()},
        {"E": idx.shape[0], "valid_edges": valid, "distinct_rows_read": rows, "rows_out": f,
         "grad_rows": n, "D": d, "dtype": str(grad.dtype)},
    )
    # the path's batches carry the order; without it the backward sorts idx
    # on the card first (``sort_order``)
    check_bitwise("gather_spmm_ragged_backward with the order sorted on the card",
                  fused_gnn.gather_spmm_ragged_backward(grad, idx, seg, f), got)
    row["ms_idx_order_none"] = graph_ms(
        rotating(fused_gnn.gather_spmm_ragged_backward, grad, idx, seg, f))
    return row


def kernel_ms_by_name(fn, *args, calls: int = 5) -> dict | str:
    """Device ms per kernel name (memsets included) of one call of
    ``fn(*args)``: a ``torch.profiler`` trace of ``calls`` calls, read by
    ``device_ms_by_kind``."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    found = device_ms_by_kind(prof)
    if found is None:
        return "not measured (the trace held no device events)"
    return {name: ms / calls for name, ms in found[1]}


def time_dense_forms(args, launches: dict, hw: dict) -> list:
    """Rows 6 and 4 (``segment_spmm``, ``gather_spmm``) and the sort, at the
    dense-form path's clean float32 call, and ``ms`` in bf16. ``kernel_ms``
    is the CSR kernel alone over the sorted edges, ``sort_ms`` the sort
    alone. Bounds (the roofline's ops of the same names) as for kernels 1
    and 3: the messages (or the distinct rows gathered) and the ids read
    once, the output written once; the sort (``segment_sort``): the ids read
    once and the permutation written once. Library
    yardsticks: ``index_add_`` into zeros, ``torch.sparse.mm`` of the
    adjacency, ``torch.sort(stable=True)`` of the key."""
    from repro_torch.kernels import fused_gnn
    from repro_torch.kernels.ref import gather_spmm_ref, segment_sort_ref, segment_spmm_ref

    feats, msg, idx, seg, n = args["float32"]
    feats16, msg16 = args["bf16"][:2]
    e, d = msg.shape
    i32 = dict(dtype=torch.int32, device="cuda")
    keys, perm, gidx = (torch.empty(e, **i32) for _ in range(3))
    fused_gnn.launch_segment_sort(seg, n, keys, perm, idx, gidx)
    index = fused_gnn.segment_index(keys, n)
    out = torch.empty((n, d), device="cuda")
    key = seg.masked_fill((seg < 0) | (seg >= n), n)
    rows_read = int(torch.unique(idx[idx >= 0]).numel())
    adj = adjacency(seg, idx, (n, feats.shape[0]))
    # each form's terms and rows in the kernel's order (torch.sort as an oracle)
    order = torch.sort(key, stable=True).indices
    s_key, s_idx = key[order], idx[order]
    ok = s_key < n
    g_terms = torch.where((s_idx >= 0)[:, None], feats[s_idx.clamp_min(0).long()], 0.0)
    sums = {"segment_spmm": (msg[order[ok]], s_key[ok]),
            "gather_spmm": (g_terms[ok], s_key[ok])}
    del g_terms
    check_sum_f32("torch.sparse.mm of the adjacency on the dense gather's call",
                  torch.sparse.mm(adj, feats), *sums["gather_spmm"], n, in_order=False)
    check_sum_f32("index_add_ into zeros on the dense sum's call",
                  msg.new_zeros((n, d)).index_add_(0, seg, msg), *sums["segment_spmm"], n,
                  in_order=False)
    check_sum_f32("torch.sparse.mm of the adjacency built from the unsorted ids",
                  sparse_mm_from_ids(seg, idx, feats, n), *sums["gather_spmm"], n,
                  in_order=False)
    rows = []
    index_add = (lambda m, s_: m.new_zeros((n, d)).index_add_(0, s_, m), msg, seg)
    for name, replaces, fn, a, a16, kernel_args, sort_args, plain, lib, from_ids, kshape in (
        ("segment_spmm", "src/repro/kernels/segment_spmm.py:57", fused_gnn.segment_spmm,
         (msg, seg, n), (msg16, seg, n), (msg, perm, keys, index, out), (seg, n, keys, perm),
         segment_spmm_ref, index_add, None,
         {"edges": e, "segments": n, "dim": d}),
        ("gather_spmm", "src/repro/kernels/fused_gnn.py:122", fused_gnn.gather_spmm,
         (feats, idx, seg, n), (feats16, idx, seg, n), (feats, gidx, keys, index, out),
         (seg, n, keys, perm, idx, gidx), gather_spmm_ref,
         (lambda x: torch.sparse.mm(adj, x), feats),
         (lambda s_, i_, x: sparse_mm_from_ids(s_, i_, x, n), seg, idx, feats),
         {"edges": e, "segments": n, "dim": d, "rows_read": rows_read}),
    ):
        got = fn(*a)
        err = check_sum_f32(f"{name} on the path's call E={e} n={n} D={d}", got, *sums[name], n)
        ms = graph_ms(rotating(fn, *a))
        sort_ms = graph_ms(rotating(fused_gnn.launch_segment_sort, *sort_args))
        bound = bound_fields(hw, name, {**kshape, "dtype_bytes": 4}, ms)
        ms16 = graph_ms(rotating(fn, *a16))
        kernel_ms = graph_ms(rotating(fused_gnn.launch_gather_sum, *kernel_args))
        library_ms = time_ms(rotating(*lib))
        # index_add_ starts from the ids; torch.sparse.mm from a prebuilt CSR
        # matrix, so the whole library route from the ids is timed beside it
        from_ids_ms = library_ms if from_ids is None else time_ms(rotating(*from_ids))
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sort.cu + segment_sum.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "kernel_ms": kernel_ms,
            "sort_ms": sort_ms,
            "sort_share": sort_ms / ms,
            "eager_ms": time_ms(rotating(fn, *a)),
            "plain_ms": time_ms(rotating(plain, *a)),
            **bound,
            "library_ms": library_ms,
            "library_from_ids_ms": from_ids_ms,
            "ms_over_library_from_ids": ms / from_ids_ms,
            "kernel_ms_over_library": kernel_ms / library_ms,
            "kernel_ms_over_bound": kernel_ms / bound["bound_ms"],
            "bf16": {"ms": ms16,
                     **bound_fields(hw, name, {**kshape, "dtype_bytes": 2}, ms16)},
            "device_ms_by_kernel": kernel_ms_by_name(fn, *a),
            "shape": {"E": e, "n": n, "F": feats.shape[0], "D": d, "dtype": str(msg.dtype),
                      "sort_passes": fused_gnn.sort_passes(n)},
        })
    check_bitwise("segment_sort on the path's call vs its plain version",
                  fused_gnn.segment_sort(seg, n), segment_sort_ref(seg, n))
    ms = graph_ms(rotating(fused_gnn.segment_sort, seg, n))
    rows.append({
        "name": "segment_sort",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sort.cu",
        "replaces": "src/repro/kernels/segment_spmm.py:57",
        "part_of": ["segment_spmm", "gather_spmm"],
        "launches": launches["segment_sort"],
        "max_abs_err": 0.0,
        "ms": ms,
        "kernel_ms": graph_ms(rotating(fused_gnn.launch_segment_sort, seg, n, keys, perm)),
        "eager_ms": time_ms(rotating(fused_gnn.segment_sort, seg, n)),
        "plain_ms": time_ms(rotating(segment_sort_ref, seg, n)),
        **bound_fields(hw, "segment_sort", {"edges": e}, ms),
        "library_ms": time_ms(rotating(lambda k: torch.sort(k, stable=True), key)),
        "shape": {"E": e, "n": n, "passes": fused_gnn.sort_passes(n), "kernels_a_pass": 3},
    })
    return rows


def plain_gat_backward(grad, logits, msg, seg, index, out, stats):
    from repro_torch.kernels.ref import gat_softmax_aggregate_backward_ref

    n = grad.shape[0]
    parts = [gat_softmax_aggregate_backward_ref(grad[:, j], logits[:, j], msg[:, j], seg, n)
             for j in range(msg.shape[1])]
    return torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1)


def time_gat_backward(args, launches: int, hw: dict) -> dict:
    """The GAT backward kernel at the largest call on the training path.
    Bound (``gat_softmax_aggregate_backward``): logits, msg, the upstream
    gradient, out, stats and seg read once; dmsg and dlogit written once."""
    from repro_torch.kernels import fused_gnn

    grad, logits, msg, seg, index, out, stats = (
        a.detach().contiguous() if torch.is_tensor(a) else a for a in args
    )
    e, h, dh = msg.shape
    n = out.shape[0]
    dlogit, dmsg = fused_gnn.gat_softmax_aggregate_backward(grad, logits, msg, seg, index, out,
                                                            stats)
    want_l, want_m = plain_gat_backward(grad, logits, msg, seg, index, out, stats)
    err = check_close(f"gat_softmax_aggregate_backward dmsg on the path's largest call E={e}",
                      dmsg, want_m)
    err = max(err, check_close("gat_softmax_aggregate_backward dlogit on the same call",
                               dlogit, want_l, tol=(1e-4, 1e-5)))
    valid = int(index[n])
    dm, dl = torch.empty_like(msg), torch.empty_like(logits)
    fn_args = (grad, logits, msg, seg, index, out, stats)
    ms = graph_ms(rotating(fused_gnn.gat_softmax_aggregate_backward, *fn_args))
    return {
        "name": "gat_softmax_aggregate_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gat_softmax_backward.cu",
        "replaces": "src/repro/kernels/fused_gnn.py:285",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "kernel_ms": graph_ms(rotating(
            fused_gnn.launch_gat_softmax_aggregate_backward,
            logits, msg, out, grad, stats, seg, index, dm, dl)),
        "eager_ms": time_ms(rotating(fused_gnn.gat_softmax_aggregate_backward, *fn_args)),
        "plain_ms": time_ms(rotating(plain_gat_backward, *fn_args)),
        **bound_fields(hw, "gat_softmax_aggregate_backward",
                       {"edges": e, "segments": n, "dim": dh, "heads": h, "valid_edges": valid,
                        "dtype_bytes": msg.element_size()}, ms),
        "library_ms": None,
        "shape": {"E": e, "valid_edges": valid, "n": n, "H": h, "dh": dh,
                  "dtype": str(msg.dtype)},
    }


# ---------------------------------------------------------------------------
# phases 10-11: LM kernels and transformer serving at full width
# ---------------------------------------------------------------------------

# arch -> (the kernel its prefill launches, layers held in float32: None =
# all; deepseek-v2-lite upcast whole would need 64 GB beside its 32 GB)
LM_ARCHS = {
    "gemma-2b": ("flash_attention", None),
    "mamba2-130m": ("ssd_scan", None),
    "deepseek-v2-lite-16b": ("flash_attention", 4),
    "recurrentgemma-2b": ("flash_attention", None),
}
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# The prefill's last logits, kernels vs plain versions. In float32 the two
# differ by sums in another order through every layer (18 or 24): rtol
# 1e-3 / atol 1e-3 on logits of scale 1-10. In bf16 the residual stream is
# rounded after every layer and the plain attention also rounds its scores
# and P, so one changed rounding grows through the stack (max abs 0.1-0.2
# between the two bf16 runs); there the kernels' logits must be no further
# from the float32 plain run than LM_BF16_RATIO times the plain versions'.
LM_F32_TOL = (1e-3, 1e-3)
LM_BF16_RATIO = 2.0
ATTN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


# the layer kinds whose full-sequence forward launches each LM kernel
KERNEL_KINDS = {"flash_attention": ("attn", "local_attn"), "ssd_scan": ("ssm",)}


def kernel_layers(cfg, kernel: str, depth: int | None = None) -> int:
    """Layers among the first ``depth`` (None: all) that launch ``kernel``
    once a forward."""
    kinds = cfg.layer_kinds()[:depth]
    return sum(k in KERNEL_KINDS[kernel] for k in kinds)


def lm_launches() -> dict:
    from repro_torch.kernels import flash_attention, ssd_scan

    return {**flash_attention.LAUNCHES, **ssd_scan.LAUNCHES}


def reset_lm_launches() -> None:
    from repro_torch.kernels import flash_attention, ssd_scan

    flash_attention.reset_launches()
    ssd_scan.reset_launches()


def attn_inputs(b, sq, skv, h, hkv, d, dtype, seed, dv=None):
    g = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, dv or d)))


def ssd_inputs(b, s, h, p, g, n, dtype, seed, init):
    gen = torch.Generator("cuda").manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x, B, C = r(b, s, h, p).to(dtype), r(b, s, g, n).to(dtype), r(b, s, g, n).to(dtype)
    dt = torch.rand(b, s, h, generator=gen, device="cuda") * 0.5 + 0.01
    A = -torch.rand(h, generator=gen, device="cuda") - 0.1
    return x, dt, A, B, C, (r(b, h, p, n) if init else None)


def compare_lm_kernels() -> None:
    """Flash attention and the SSD scan against their plain versions, at
    the serving path's shapes and at ragged ones, float32 and bf16."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref, ssd_chunked_ref

    log("phase: LM kernels vs plain versions on the card")
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, h, hkv, d, dv, causal, window, off in (
            (4, 2048, 2048, 8, 1, 256, 256, True, 0, 0),  # the gemma-2b prefill
            (4, 2048, 2048, 16, 16, 192, 128, True, 0, 0),  # the deepseek-v2-lite prefill
            (2, 1000, 1000, 16, 8, 128, 128, True, 512, 0),
            (2, 333, 1357, 16, 8, 128, 128, True, 0, 1024),
            (1, 300, 500, 16, 16, 192, 128, True, 100, 200),
            (1, 77, 77, 4, 2, 64, 64, False, 0, 0),
        ):
            q, k, v = attn_inputs(b, sq, skv, h, hkv, d, dtype, sq + d, dv)
            kw = dict(causal=causal, window=window, kv_offset=off)
            check_close(f"flash_attention B={b} Sq={sq} Skv={skv} H={h}/{hkv} D={d} Dv={dv} "
                        f"causal={causal} window={window} kv_offset={off} {dtype}",
                        ops.mha_attention(q, k, v, **kw), attention_ref(q, k, v, **kw),
                        tol=ATTN_TOL[dtype])
        for b, s, h, p, g, n, init in (
            (4, 2048, 24, 64, 1, 128, False),  # the mamba2-130m prefill
            (4, 2000, 24, 64, 1, 128, True),
            (2, 333, 8, 32, 2, 64, True),
        ):
            x, dt, A, B, C, st = ssd_inputs(b, s, h, p, g, n, dtype, s + p, init)
            y, state = ops.ssd_scan(x, dt, A, B, C, chunk=128, init_state=st)
            want_y, want_st = ssd_chunked_ref(x, dt * A, dt, B, C, chunk=128, init_state=st)
            label = f"B={b} S={s} H={h} P={p} G={g} N={n} init={init} {dtype}"
            check_close(f"ssd_scan y {label}", y, want_y, tol=SSD_TOL[dtype])
            check_close(f"ssd_scan final state {label}", state, want_st,
                        tol=SSD_TOL[torch.float32])


# The backward kernels against autograd of the plain versions, on the card.
# float32: ATTN_TOL / SSD_TOL. bf16 attention: the kernel rounds P to bf16
# and splits dS into two bf16 parts for its tensor-core products, and forms
# D = rowsum(dO o) from the forward's float32 output (as training hands it
# over); both are held against autograd of the plain version on the inputs
# upcast to float32, the kernel's largest error at most
# ATTN_BF16_GRAD_RATIO times the plain version's own. bf16 SSD: dx, dB and dC (rounded once from
# float32) against the upcast run at rtol 1e-2, atol 1e-3 of the tensor's
# largest element. The SSD's float32 gradients (and bf16's float32 da and
# ddt) at SSD_GRAD_TOL: da is a difference of sums of up to S P N terms.
ATTN_BF16_GRAD_RATIO = 2.0
SSD_GRAD_TOL = (1e-3, 1e-3)
# (B, Sq, Skv, H, Hkv, D, Dv, causal, window, kv_offset)
ATTN_BWD_CASES = (
    (2, 2048, 2048, 8, 1, 256, 256, True, 0, 0),  # gemma-2b training: MQA 8:1
    (1, 4096, 4096, 10, 1, 256, 256, True, 2048, 0),  # recurrentgemma-2b: window, 10:1
    (4, 2048, 2048, 16, 16, 192, 128, True, 0, 0),  # deepseek-v2-lite's MLA, no GQA
    (2, 1000, 1000, 16, 8, 128, 128, True, 512, 0),
    (2, 333, 1357, 16, 8, 64, 64, True, 0, 1024),  # kv_offset
    (1, 300, 500, 8, 2, 96, 64, True, 100, 200),
    (1, 77, 77, 4, 4, 32, 32, False, 0, 0),
)
# (B, S, H, P, G, N, init)
SSD_BWD_CASES = (
    (4, 2048, 24, 64, 1, 128, False),  # mamba2-130m training
    (4, 2000, 24, 64, 1, 128, True),  # ragged S, from an initial state
    (2, 333, 8, 32, 2, 64, True),
)


def compare_lm_backward_kernels() -> None:
    """The flash and SSD backward kernels against autograd of the plain
    versions, at every head width and the training paths' shapes, float32
    and bf16; each twice, bitwise."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import attention_backward_ref, ssd_backward_ref

    log("phase: LM backward kernels vs autograd of the plain versions on the card")
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, h, hkv, d, dv, causal, window, off in ATTN_BWD_CASES:
            kw = dict(causal=causal, window=window, kv_offset=off)
            q, k, v = attn_inputs(b, sq, skv, h, hkv, d, dtype, sq + d, dv)
            dout = attn_inputs(b, sq, 1, h, 1, dv, dtype, sq + dv + 1)[0]
            label = (f"B={b} Sq={sq} Skv={skv} H={h}/{hkv} D={d} Dv={dv} causal={causal} "
                     f"window={window} kv_offset={off} {dtype}")
            lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
            out = torch.empty((b, sq, h, dv), dtype=dtype, device="cuda")
            # as training calls it: bf16 hands the backward its float32 output
            o32 = torch.empty(out.shape, dtype=torch.float32, device="cuda")
            fa.launch_flash_attention(q, k, v, out, lse, o32, **kw)
            o = out if dtype == torch.float32 else o32
            got = fa.flash_attention_backward(q, k, v, o, dout, lse, **kw)
            again = fa.flash_attention_backward(q, k, v, o, dout, lse, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"flash_attention_backward {label}: two runs differ")
            want = attention_backward_ref(q, k, v, dout, **kw)
            if dtype == torch.float32:
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    check_close(f"flash_attention_backward {name} {label}", g, w,
                                tol=ATTN_TOL[dtype])
            else:
                up = attention_backward_ref(q.float(), k.float(), v.float(), dout.float(), **kw)
                for name, g, w, u in zip(("dq", "dk", "dv"), got, want, up):
                    ek, ep = max_err(g, u), max_err(w, u)
                    if ek > ATTN_BF16_GRAD_RATIO * ep:
                        fail(f"flash_attention_backward {name} {label}: {ek} from the float32 "
                             f"run, beyond {ATTN_BF16_GRAD_RATIO}x the plain version's {ep}")
                    log(f"  ok flash_attention_backward {name} {label}: max abs err from the "
                        f"float32 run: kernel {ek:.3e}, plain {ep:.3e}, ratio "
                        f"{ek / max(ep, 1e-30):.3f} "
                        f"(limit {ATTN_BF16_GRAD_RATIO}); share of ATTN_TOL: kernel "
                        f"{tol_share(g, u, ATTN_TOL[dtype]):.3f}, plain "
                        f"{tol_share(w, u, ATTN_TOL[dtype]):.3f}")
            del q, k, v, dout, out, o32, o, got, again, want
        for b, s, h, p, g, n, init in SSD_BWD_CASES:
            x, dt, A, B, C, st = ssd_inputs(b, s, h, p, g, n, dtype, s + p + 1, init)
            a = dt * A[None, None, :]
            gen = torch.Generator("cuda").manual_seed(s)
            dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
            dfinal = torch.randn((b, h, p, n), generator=gen, device="cuda")
            label = f"B={b} S={s} H={h} P={p} G={g} N={n} init={init} {dtype}"
            got = sk.ssd_scan_backward(x, a, dt, B, C, dy, dfinal, init_state=st)
            again = sk.ssd_scan_backward(x, a, dt, B, C, dy, dfinal, init_state=st)
            if not all((u is None and w is None) or torch.equal(u, w) for u, w in zip(got, again)):
                fail(f"ssd_scan_backward {label}: two runs differ")
            want = ssd_backward_ref(x.float(), a, dt, B.float(), C.float(), dy.float(), dfinal,
                                    init_state=st)
            for name, gg, w in zip(("dx", "da", "ddt", "dB", "dC", "dinit"), got, want):
                if w is None:
                    continue
                tol = SSD_GRAD_TOL
                if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
                    tol = (1e-2, 1e-3 * float(w.abs().max()))
                check_close(f"ssd_scan_backward {name} {label}", gg, w, tol=tol)


class FirstCall:
    """Wraps an entry point and keeps the arguments of its first call."""

    def __init__(self, fn):
        self.fn = fn
        self.args = None

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.fn(*args, **kwargs)


@contextmanager
def plain_lm():
    """The model's attention and SSD through their plain versions, on the
    card: the dense attention of the model's CPU path and the chunked SSD."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.models.transformer import layers, ssm

    def attn(q, k, v, *, causal, window, kv_offset):
        return layers._dense_attention(q, k, v, causal=causal, window=window, q_offset=kv_offset)

    def scan(x, dt, A, B, C, *, chunk, init_state):
        return ssd_chunked_ref(x, dt * A[None, None, :], dt, B, C, chunk=chunk,
                               init_state=init_state)

    with mock.patch.object(layers, "mha_attention", attn), mock.patch.object(ssm, "ssd_scan", scan):
        yield


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


PROFILE_DECODE_STEPS = 8


def device_ms_by_kind(prof) -> tuple[dict, list] | None:
    """Device time (ms) of a ``torch.profiler`` trace's kernels, by kind:
    the two LM kernels, matrix products (cuBLAS's ``nvjet``/``gemm`` and
    CUTLASS names), gathers and scatters (MoE dispatch and combine,
    embedding lookups), sorts and scans (MoE routing), PyTorch's
    elementwise and reduction kernels, and the rest; with every kernel's
    time by name, largest first. None when the trace holds no device
    events."""
    from torch.autograd import DeviceType

    kinds: dict = {}
    names: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name.lower()
        if "flash_bwd_kernel" in name:
            kind = "flash_attention_backward"
        elif "ssd_bwd_kernel" in name:
            kind = "ssd_scan_backward"
        elif "flash_attention_kernel" in name:
            kind = "flash_attention"
        elif "ssd_scan_kernel" in name:
            kind = "ssd_scan"
        elif any(t in name for t in ("nvjet", "gemm", "cutlass", "xmma", "matmul")):
            kind = "matmul"
        elif any(t in name for t in ("index", "scatter", "gather")):
            kind = "gather_scatter"  # MoE dispatch and combine, embedding lookups
        elif any(t in name for t in ("sort", "scan")):
            kind = "sort_scan"  # MoE routing: top-k by sort, slot positions by cumsum
        elif "elementwise" in name:
            kind = "elementwise"
        elif "reduce" in name:
            kind = "reduce"
        else:
            kind = "other"
        ms = evt.time_range.elapsed_us() / 1e3
        kinds[kind] = kinds.get(kind, 0.0) + ms
        names[evt.name[:80]] = names.get(evt.name[:80], 0.0) + ms
    if not kinds:
        return None
    return kinds, sorted(names.items(), key=lambda kv: -kv[1])


def profile_lm(cfg, params, prefill_wall_ms: float, decode_wall_ms: float) -> dict:
    """One prefill and ``PROFILE_DECODE_STEPS`` decode steps of the serving
    path under ``torch.profiler``: device time by kind, and the device's
    busy share against the unprofiled wall times of the same work (the
    profiler's own host cost would inflate a profiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.specs import make_decode_step, make_prefill_step
    from repro_torch.models.transformer.model import init_cache

    rng = np.random.default_rng(0)
    if cfg.input_mode == "embeddings":  # fed embeddings, as ``serve`` feeds them
        prompt = torch.as_tensor(rng.standard_normal((LM_BATCH, LM_PROMPT, cfg.d_model),
                                                     dtype=np.float32), device="cuda")
        step_in = prompt[:, :1]
    else:
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
                                 device="cuda")
    cache = init_cache(cfg, LM_BATCH, LM_PROMPT + PROFILE_DECODE_STEPS, "cuda")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        with profile(activities=acts) as pp:
            logits, cache = prefill(params, cache, {"inputs": prompt})
            torch.cuda.synchronize()
        tok = logits[:, : cfg.vocab_size].argmax(dim=-1)
        with profile(activities=acts) as pd:
            for i in range(PROFILE_DECODE_STEPS):
                inp = step_in if cfg.input_mode == "embeddings" else tok[:, None]
                logits, cache = decode(params, cache, {"inputs": inp}, LM_PROMPT + i)
                tok = logits[:, : cfg.vocab_size].argmax(dim=-1)
            torch.cuda.synchronize()
    out = {}
    for label, prof, wall in (("prefill", pp, prefill_wall_ms),
                              ("decode_step", pd, decode_wall_ms * PROFILE_DECODE_STEPS)):
        found = device_ms_by_kind(prof)
        if found is None:
            out[label] = "not measured (the trace held no device events)"
            continue
        kinds, top = found
        scale = PROFILE_DECODE_STEPS if label == "decode_step" else 1
        busy = sum(kinds.values())
        out[label] = {"device_ms_by_kind": {k: v / scale for k, v in kinds.items()},
                      "device_busy_ms": busy / scale,
                      "busy_share_of_unprofiled_wall": busy / wall,
                      "top_kernels_ms": [[n, ms / scale] for n, ms in top[:5]]}
    return out


class RoutingRecorder:
    """Wraps ``moe.route``: keeps each call's chosen experts and kept slots,
    in call order (one call per MoE layer of a forward)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kwargs):
        r = self.fn(*args, **kwargs)
        self.calls.append((r.gate_idx.clone(), r.keep.clone()))
        return r


def routing_flips(a: RoutingRecorder, b: RoutingRecorder, seq_len: int) -> tuple[list, list]:
    """Slots whose expert or whose keep/drop differs between two runs, per
    MoE layer, and the batch rows that hold any of them (tokens are
    row-major, ``seq_len`` to a row)."""
    per_layer, rows = [], set()
    for (ia, ka), (ib, kb) in zip(a.calls, b.calls):
        diff = (ia != ib).reshape(-1) | (ka != kb).reshape(-1)
        per_layer.append(int(diff.sum()))
        tokens = torch.nonzero(diff).flatten() // ia.shape[-1]
        rows.update((tokens // seq_len).tolist())
    return per_layer, sorted(rows)


def serve_lm(arch: str, kernel: str, f32_layers, captured: dict, hw: dict) -> dict:
    """``repro_torch.launch.serve.serve`` at the full config: batch 4,
    prompt 2048, 32 greedy tokens, weights drawn on the card from seed 0
    (as ``serve`` draws them itself). Counts are zeroed just before the run
    and read just after: one kernel launch per layer's prefill, none in
    decode. A second run must give the same bits; its warm prefill and
    decode walls give the roofline's shares (:func:`step_roofline`, bf16
    weights at 2 bytes; decode's context the prompt plus half the
    generated tokens, the mean over its steps), and one more prefill and
    decode are profiled (:func:`profile_lm`). The prefill's logits are
    then held against the plain versions at ``f32_layers`` layers (None:
    all; the first layers of the same model where an upcast of all would
    not fit the card): in float32 (the same weights upcast) within
    ``LM_F32_TOL``, and in bf16 against the float32 plain run, where the
    kernels' error may be at most ``LM_BF16_RATIO`` times the plain
    versions' own. With experts, the float32 runs record their routing: a
    slot whose expert or keep flips between kernels and plain versions
    (attention differing by 1e-6 can move a token across the top-k
    boundary) is counted per layer, and the logits are held on the batch
    rows that no flip touched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import layers, moe, ssm
    from repro_torch.models.transformer.model import init_params

    cfg = get_config(arch, reduced=False)
    owner, entry = (layers, "mha_attention") if kernel == "flash_attention" else (ssm, "ssd_scan")
    first = FirstCall(getattr(ops, entry))
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN, seed=0, device="cuda",
              params=params)

    def launched(what, depth=None):
        want = {kernel: kernel_layers(cfg, kernel, depth)}
        got = {k: v for k, v in lm_launches().items() if v}
        if got != want:
            fail(f"{arch} {what} launched {got}, the path implies {want}")
        return got

    torch.cuda.reset_peak_memory_stats()
    reset_lm_launches()
    t0 = time.perf_counter()
    with mock.patch.object(owner, entry, first):
        out = serve(cfg, **kw)
    wall_s = time.perf_counter() - t0
    got = launched("serving")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    captured[arch] = first.args
    toks, logits = out["tokens"], out["logits"]
    real = slice(0, cfg.vocab_size)
    if toks.shape != (LM_BATCH, LM_GEN + 1) or not torch.isfinite(logits[:, real]).all():
        fail(f"{arch}: tokens {toks.shape}, finite logits {bool(torch.isfinite(logits).all())}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{arch}: a greedy token outside the vocabulary")
    reset_lm_launches()
    again = serve(cfg, **kw)
    launched("second run")
    bitwise = bool(np.array_equal(again["tokens"], toks) and torch.equal(again["logits"], logits))
    roof = {
        "prefill": step_roofline(f"serve {arch} prefill", cfg,
                                 dict(seq=LM_PROMPT, batch=LM_BATCH, kind="prefill"),
                                 again["prefill_ms"], hw, 2),
        "decode": step_roofline(f"serve {arch} decode", cfg,
                                dict(seq=LM_PROMPT + LM_GEN // 2, batch=LM_BATCH, kind="decode"),
                                again["decode_ms_per_token"], hw, 2),
    }
    reset_lm_launches()
    with plain_lm():
        plain = serve(cfg, **kw)
    if any(lm_launches().values()):
        fail(f"{arch} plain run launched {lm_launches()}")
    profile = profile_lm(cfg, params, again["prefill_ms"], again["decode_ms_per_token"])

    depth = cfg.num_layers if f32_layers is None else f32_layers
    head = {**params, "layers": params["layers"][:depth]}
    cfg_d = dataclasses.replace(cfg, num_layers=depth)
    cfg32 = dataclasses.replace(cfg_d, dtype="float32")
    kw32 = {**kw, "params": tree_map(lambda t: t.float(), head), "gen": 0}
    rec_k, rec_p = RoutingRecorder(moe.route), RoutingRecorder(moe.route)
    reset_lm_launches()
    with mock.patch.object(moe, "route", rec_k):
        k32 = serve(cfg32, **kw32)
    launched("float32 run", depth)
    with plain_lm(), mock.patch.object(moe, "route", rec_p):
        p32 = serve(cfg32, **kw32)
    del kw32
    flips, flipped_rows = routing_flips(rec_k, rec_p, LM_PROMPT)
    held = [r for r in range(LM_BATCH) if r not in flipped_rows]
    log(f"  {arch} float32 at {depth} layers: routing flips per MoE layer {flips}, "
        f"batch rows touched {flipped_rows}, rows held {held}")
    if not held:
        fail(f"{arch}: routing flips touched every batch row; no float32 logits to hold")
    ref = p32["logits"][:, real]
    err32 = check_close(f"{arch} float32 prefill last logits at {depth} layers, kernels vs "
                        f"plain versions, rows {held}",
                        k32["logits"][held][:, real], ref[held], tol=LM_F32_TOL)
    if depth == cfg.num_layers:
        bf_k, bf_p = logits, plain["logits"]
    else:  # bf16 at the float32 run's depth
        kw_d = {**kw, "params": head, "gen": 0}
        reset_lm_launches()
        bf_k = serve(cfg_d, **kw_d)["logits"]
        launched("bf16 run at the float32 run's depth", depth)
        with plain_lm():
            bf_p = serve(cfg_d, **kw_d)["logits"]
    err_k = max_err(bf_k[:, real], ref)
    err_p = max_err(bf_p[:, real], ref)
    log(f"  {arch} bf16 prefill last logits at {depth} layers vs the float32 plain run: "
        f"kernels {err_k:.3e}, plain versions {err_p:.3e} (at most {LM_BF16_RATIO}x)")
    info = {
        "config": cfg.name,
        "batch": LM_BATCH,
        "prompt_len": LM_PROMPT,
        "gen": LM_GEN,
        "wall_s": wall_s,
        "prefill_ms": out["prefill_ms"],
        "decode_ms_per_token": out["decode_ms_per_token"],
        "again_prefill_ms": again["prefill_ms"],
        "again_decode_ms_per_token": again["decode_ms_per_token"],
        "roofline": roof,
        "plain_prefill_ms": plain["prefill_ms"],
        "plain_decode_ms_per_token": plain["decode_ms_per_token"],
        "f32_depth": depth,
        "f32_prefill_ms": k32["prefill_ms"],
        "f32_plain_prefill_ms": p32["prefill_ms"],
        "peak_memory_gb": peak_gb,
        "launches": got,
        "two_runs_bitwise_equal": bitwise,
        "bf16_logits_max_abs_err_vs_plain": max_err(logits[:, real], plain["logits"][:, real]),
        "bf16_kernels_err_vs_f32": err_k,
        "bf16_plain_err_vs_f32": err_p,
        "f32_logits_max_abs_err_vs_plain": err32,
        "f32_routing_flips_per_layer": flips,
        "f32_rows_held": held,
        "logit_scale": float(ref.abs().max()),
        "greedy_tokens_equal_to_plain": float(np.mean(plain["tokens"] == toks)),
        "first_tokens": toks[0, :8].tolist(),
        "profile": profile,
    }
    log(f"  serve {arch}: " + json.dumps(info))
    kinds = profile["prefill"]
    if isinstance(kinds, dict) and not kinds["device_ms_by_kind"].get(kernel, 0.0) > 0:
        fail(f"{arch}: the prefill's device profile shows no time in {kernel}: "
             f"{kinds['device_ms_by_kind']}")
    if not bitwise:
        fail(f"{arch}: two serving runs differ")
    if err_k > LM_BF16_RATIO * err_p:
        fail(f"{arch}: bf16 logits {err_k} from the float32 run, beyond {LM_BF16_RATIO}x the "
             f"plain versions' {err_p}")
    return info


# ---------------------------------------------------------------------------
# phase 12: LM training at full width
# ---------------------------------------------------------------------------

# arch -> (batch, sequence, steps, layers of the float32 check against the
# plain versions: None = all). gemma-2b's float32 copy of all 18 layers
# would fit, but its plain attention's float32 scores for each layer's
# backward make the check the phase's longest part: 4 layers hold the
# same kernels. recurrentgemma-2b at 3, one (RG-LRU, RG-LRU, local
# attention) period; at 4096 tokens its window of 2048 bites.
LM_TRAIN = {
    "gemma-2b": (2, 2048, 5, 4),
    "mamba2-130m": (4, 2048, 6, None),
    "recurrentgemma-2b": (1, 4096, 4, 3),
}
# the first step's float32 loss and gradients, kernels vs plain versions:
# loss rtol / atol 1e-4; each gradient leaf's largest error at most
# LM_GRAD_SHARE of its largest element (sums in another order through the
# layers and back; a leaf's own scale, since embedding and norm gradients
# are 1e-6-1e-2)
LM_GRAD_SHARE = 1e-3
# Steady step walls (ms) with the backward kernels on the CUDA cores
# (PERF.md §5; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
LM_TRAIN_SIMT_STEP_MS = {"gemma-2b": 490.0, "mamba2-130m": 280.1, "recurrentgemma-2b": 805.3}


def loss_and_grads(params, cfg, inp, tgt) -> tuple:
    """``lm_loss`` (remat on, as the trainer runs it) and its backward:
    (loss, the gradient of every leaf in ``tree_leaves`` order)."""
    from repro_torch.models.transformer.model import lm_loss
    from repro_torch.train.optim import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    loss, _ = lm_loss(params, cfg, inp, tgt, remat=True)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return loss.detach(), grads


def train_lm(arch: str, captured: dict, hw: dict) -> dict:
    """``repro_torch.train.LMTrainer`` at the full config, computing in its
    dtype (bf16) on float32 master weights, as the reference trainer's,
    drawn on the card from seed 0, with the reference's AdamW config (lr
    3e-4 after a linear warmup of 100 steps): first the first batch's
    float32 loss and gradients at ``LM_TRAIN``'s depth, kernels vs plain
    versions; then whether a bf16 forward and backward repeats bit for bit
    (the leaves that differ are named); then ``train(steps)`` with the
    counts zeroed just before and read just after (per step, each
    attention or SSD layer: two forward launches, one in the forward and
    one in remat's recompute, and one backward launch), the losses finite
    and falling, and the steady step's roofline shares (:func:`step_roofline`,
    float32 master weights at 4 bytes); then one step under
    ``torch.profiler``."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models.transformer.model import init_params
    from repro_torch.train import LMTrainer
    from repro_torch.train.optim import tree_leaves
    from torch.profiler import ProfilerActivity, profile

    batch, seq, steps, f32_layers = LM_TRAIN[arch]
    cfg = get_config(arch, reduced=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    # the trainer's own draw (its default), made here so that the checks
    # below run before its optimizer state takes 4 bytes x 2 a parameter
    params = init_params(dataclasses.replace(cfg, dtype="float32"),
                         torch.Generator("cuda").manual_seed(0), "cuda")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    inp, tgt = (torch.as_tensor(t, device="cuda").long()
                for t in SyntheticTokenStream(cfg.vocab_size, batch, seq, 0).next_batch())

    # float32 at the cut depth: the same first step through the kernels and
    # through the plain versions
    depth = cfg.num_layers if f32_layers is None else f32_layers
    head = {**params, "layers": params["layers"][:depth]}
    p32 = tree_map(lambda t: t.detach().float().requires_grad_(True), head)
    cfg32 = dataclasses.replace(cfg, num_layers=depth, dtype="float32")
    loss_k, grads_k = loss_and_grads(p32, cfg32, inp, tgt)
    with plain_lm():
        loss_p, grads_p = loss_and_grads(p32, cfg32, inp, tgt)
    check_close(f"{arch} float32 first-step loss at {depth} layers, kernels vs plain versions",
                loss_k, loss_p, tol=(1e-4, 1e-4))
    worst = 0.0
    for i, (gk, gp) in enumerate(zip(grads_k, grads_p)):
        if gk is None or gp is None or gk.shape != gp.shape:
            fail(f"{arch} float32 gradient leaf {i}: {gk is None} {gp is None}")
        share = max_err(gk, gp) / max(float(gp.abs().max()), 1e-30)
        worst = max(worst, share)
        if share > LM_GRAD_SHARE:
            fail(f"{arch} float32 gradient leaf {i} {tuple(gp.shape)}: max err {share:.3e} of "
                 f"its largest element, beyond {LM_GRAD_SHARE}")
    log(f"  ok {arch} float32 first-step gradients at {depth} of {cfg.num_layers} layers, "
        f"{len(grads_k)} leaves: largest error {worst:.3e} of a leaf's largest element")
    del p32, grads_k, grads_p, head
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: one forward and backward twice from the same weights
    loss_a, grads_a = loss_and_grads(params, cfg, inp, tgt)
    loss_b, grads_b = loss_and_grads(params, cfg, inp, tgt)
    names = [n for n, _ in named_leaves(params)]
    differ = [n for n, x, y in zip(names, grads_a, grads_b) if not torch.equal(x, y)]
    step_bitwise = bool(torch.equal(loss_a, loss_b)) and not differ
    log(f"  {arch} bf16 forward + backward twice: loss bitwise {torch.equal(loss_a, loss_b)}, "
        f"gradient leaves that differ: {differ or 'none'}")
    del grads_a, grads_b
    gc.collect()
    torch.cuda.empty_cache()
    trainer = LMTrainer(cfg, batch=batch, seq_len=seq, seed=0, device="cuda", params=params)
    del params

    # the trainer: counts zeroed just before, read just after
    rec = StepRecorder(LMTrainer)
    bwd_calls = {"flash_attention_backward": FirstCall(fa.flash_attention_backward),
                 "ssd_scan_backward": FirstCall(sk.ssd_scan_backward)}
    reset_lm_launches()
    t0 = time.perf_counter()
    with rec.patched(), \
            mock.patch.object(fa, "flash_attention_backward",
                              bwd_calls["flash_attention_backward"]), \
            mock.patch.object(sk, "ssd_scan_backward", bwd_calls["ssd_scan_backward"]):
        tlog = trainer.train(steps, log_every=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = {k: v for k, v in lm_launches().items() if v}
    want = {}
    for kernel in KERNEL_KINDS:
        n = kernel_layers(cfg, kernel)
        if n:
            want[kernel] = 2 * n * steps
            want[kernel + "_backward"] = n * steps
    if got != want:
        fail(f"{arch} training launched {got}, the path implies {want}")
    for name, call in bwd_calls.items():
        if call.args is not None:  # the first model's: gemma-2b's attention
            # detached: remat's recomputed tensors would keep the step's
            # graph, and through it every weight and gradient, alive
            args, kw = call.args
            captured.setdefault(name, (tuple(a.detach() if torch.is_tensor(a) else a
                                             for a in args), kw))
    losses = tlog.losses
    if len(losses) != steps or not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{arch} training losses {losses}: not finite or not falling")
    gaps = np.diff(rec.starts) * 1e3
    steady_ms = float(np.median(gaps[1:])) if gaps.size > 1 else float(gaps[0])
    roof = step_roofline(f"train {arch} steady step", cfg,
                         dict(seq=seq, batch=batch, kind="train"), steady_ms, hw, 4)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one more step under the profiler: device time by kind, busy share
    s_inp, s_tgt = (torch.as_tensor(t, device="cuda").long()
                    for t in trainer.stream.next_batch())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(s_inp, s_tgt)
        torch.cuda.synchronize()
    found = device_ms_by_kind(prof)
    if found is None:
        prof_info = "not measured (the trace held no device events)"
        busy = None
    else:
        kinds, top = found
        busy = sum(kinds.values())
        prof_info = {"device_ms_by_kind": kinds, "device_busy_ms": busy,
                     "idle_share_of_steady_wall": 1.0 - busy / steady_ms,
                     "top_kernels_ms": [[n, ms] for n, ms in top[:6]]}
    info = {
        "config": cfg.name,
        "dtype": cfg.dtype,
        "batch": batch,
        "seq": seq,
        "steps": steps,
        "params": sum(p.numel() for p in tree_leaves(trainer.params)),
        "wall_s": wall_s,
        "step_wall_ms": [float(g) for g in gaps],
        "step_wall_ms_steady_median": steady_ms,
        "step_wall_ms_simt_backward": LM_TRAIN_SIMT_STEP_MS.get(arch),
        "tokens_per_s": batch * seq / steady_ms * 1e3,
        "roofline": roof,
        "step_device_ms": rec.device_ms(),
        "losses": losses,
        "launches": got,
        "launches_per_step": {k: v // steps for k, v in got.items()},
        "f32_depth": depth,
        "f32_loss_kernels": float(loss_k),
        "f32_loss_plain": float(loss_p),
        "f32_worst_grad_share": worst,
        "bf16_step_bitwise_run_to_run": step_bitwise,
        "bf16_grad_leaves_not_bitwise": differ,
        "allocated_before_gb": allocated_gb,
        "peak_memory_gb": peak_gb,
        "profile": prof_info,
    }
    log(f"  train {arch}: " + json.dumps(info))
    if isinstance(prof_info, dict):
        for kernel in want:
            if not prof_info["device_ms_by_kind"].get(kernel, 0.0) > 0:
                fail(f"{arch}: the step's device profile shows no time in {kernel}: "
                     f"{prof_info['device_ms_by_kind']}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return info


def named_leaves(tree, prefix=""):
    """(name, leaf) in ``tree_leaves`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def time_flash(call, launches: int, hw: dict, name: str = "flash_attention") -> dict:
    """The flash kernel at a serving prefill's call (gemma-2b: D 256 over
    one KV head; deepseek-v2-lite: q and k 192 wide, v 128). Bound
    (``flash_attention``): q, k, v read once and the output written once,
    against the causal products (2 (D + Dv) flops per unmasked (query,
    key) pair) on the tensor cores. The yardstick, SDPA, is timed both ways: ``library_ms``
    eager (CUDA events around back-to-back calls) and ``library_graph_ms``
    by CUDA-graph replay, as ``ms`` is; ``ms_over_library_graph`` and
    ``bound_share`` (bound / ms) compare like with like."""
    import functools

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    (q, k, v), kw = call
    b, s, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    err = check_close(f"flash_attention on the path's call B={b} S={s} H={h}/{hkv} D={d} "
                      f"Dv={dv}", fa.flash_attention(q, k, v, **kw),
                      attention_ref(q, k, v, **kw), tol=ATTN_TOL[q.dtype])
    if kw["window"] or kw["kv_offset"] or not kw["causal"] or s != skv:
        fail(f"unexpected flash call on the path: {kw}")

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True, enable_gqa=True)

    check_close("scaled_dot_product_attention on the same call", sdpa(q, k, v).transpose(1, 2),
                fa.flash_attention(q, k, v, **kw), tol=ATTN_TOL[q.dtype])
    out = q.new_empty((b, s, h, dv))
    ms = graph_ms(rotating(functools.partial(fa.flash_attention, **kw), q, k, v), iters=5)
    try:
        library_graph = graph_ms(rotating(sdpa, q, k, v), iters=5)
        graph_note = None
    except RuntimeError as e:  # the yardstick only: the port never calls SDPA
        library_graph, graph_note = None, f"SDPA could not be captured: {e}"[:200]
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        # the training call: the same kernel writing each row's log-sum-exp
        "with_lse_kernel_ms": graph_ms(rotating(
            lambda q_, k_, v_: fa.launch_flash_attention(q_, k_, v_, out, lse, **kw), q, k, v),
            iters=5),
        "kernel_ms": graph_ms(rotating(
            functools.partial(fa.launch_flash_attention, **kw), q, k, v, out), iters=5),
        "eager_ms": time_ms(rotating(functools.partial(fa.flash_attention, **kw), q, k, v),
                            iters=20),
        "plain_ms": time_ms(rotating(functools.partial(attention_ref, **kw), q, k, v), iters=5,
                            warmup=2),
        **bound_fields(hw, "flash_attention",
                       {"batch": b, "seq_q": s, "seq_kv": skv, "heads": h, "kv_heads": hkv,
                        "dim": d, "dim_v": dv, "dtype_bytes": q.element_size()}, ms, "bf16"),
        "library_ms": time_ms(rotating(sdpa, q, k, v), iters=20),
        "library_graph_ms": library_graph,
        "library_graph_note": graph_note,
        "ms_over_library_graph": ms / library_graph if library_graph else None,
        "shape": {"B": b, "S": s, "H": h, "Hkv": hkv, "D": d, "Dv": dv, "dtype": str(q.dtype)},
    }


def time_flash_backward(call, launches: int, hw: dict) -> dict:
    """The flash backward kernels at the first training call (gemma-2b:
    B 2, S 2048, 8 query heads over one KV head of 256; o the forward's
    float32 output, as training hands it over). Bound
    (``flash_attention_backward``): operations, 2.5 times the forward's
    causal products (2 (D + Dv) flops per unmasked pair) on the tensor
    cores, against q, k, v, o, dO and the log-sum-exp read once and dq,
    dk, dv written once. The yardstick: the
    backward of ``scaled_dot_product_attention`` by autograd (its forward
    run once, the graph kept). ``phase_kernel_ms``: the call by kernel,
    from a fresh process (``fresh_phases``)."""
    import functools

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_backward_ref

    (q, k, v, o, dout, lse), kw = call
    b, s, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    got = fa.flash_attention_backward(q, k, v, o, dout, lse, **kw)
    want = attention_backward_ref(q, k, v, dout, **kw)
    up = attention_backward_ref(q.float(), k.float(), v.float(), dout.float(), **kw)
    ratios = {name: max_err(g, u) / max(max_err(w, u), 1e-30)
              for name, g, w, u in zip(("dq", "dk", "dv"), got, want, up)}
    err = max(max_err(g, u) for g, u in zip(got, up))
    plain_err = max(max_err(w, u) for w, u in zip(want, up))
    if err > ATTN_BF16_GRAD_RATIO * plain_err:
        fail(f"flash_attention_backward on the path's call: {err} from the float32 run, beyond "
             f"{ATTN_BF16_GRAD_RATIO}x the plain version's {plain_err}")
    log(f"  ok flash_attention_backward on the path's call B={b} S={s} H={h}/{hkv} D={d}: max "
        f"abs err from the float32 run: kernel {err:.3e}, plain {plain_err:.3e}, ratio "
        f"{err / max(plain_err, 1e-30):.3f} (limit {ATTN_BF16_GRAD_RATIO})")
    window = kw["window"]
    ms = graph_ms(rotating(functools.partial(fa.flash_attention_backward, **kw),
                           q, k, v, o, dout, lse), iters=3)
    try:
        leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=kw["causal"] and not window,
                                             enable_gqa=h != hkv)
        gout = dout.transpose(1, 2)
        library = time_ms(lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True),
                          iters=5, warmup=2)
        note = "autograd of SDPA's backward" + ("" if not window else "; SDPA has no window")
        del out
    except RuntimeError as e:  # the yardstick only: the port never calls SDPA
        library, note = None, f"SDPA's backward could not run: {e}"[:200]
    return {
        "name": "flash_attention_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_backward.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": launches,
        "max_abs_err": err,
        # each gradient's error from the float32 run over the plain version's
        # (D from the bf16 output had dq 1.44, dk 1.71; PERF.md §7)
        "err_ratio_to_plain": ratios,
        "ms": ms,
        "kernel_ms": ms,
        "eager_ms": time_ms(rotating(functools.partial(fa.flash_attention_backward, **kw),
                                     q, k, v, o, dout, lse), iters=5, warmup=2),
        "plain_ms": time_ms(rotating(functools.partial(attention_backward_ref, **kw),
                                     q, k, v, dout), iters=3, warmup=1),
        **bound_fields(hw, "flash_attention_backward",
                       {"batch": b, "seq_q": s, "seq_kv": skv, "heads": h, "kv_heads": hkv,
                        "dim": d, "dim_v": dv, "causal": kw["causal"], "window": window,
                        "kv_offset": kw["kv_offset"], "dtype_bytes": q.element_size(),
                        "o_bytes": o.element_size()}, ms, "bf16"),
        "library_ms": library,
        "library_note": note,
        **fresh_phases("flash-phases"),
        "shape": {"B": b, "S": s, "H": h, "Hkv": hkv, "D": d, "Dv": dv, "window": window,
                  "dtype": str(q.dtype), "o_dtype": str(o.dtype)},
    }


def time_ssd_backward(call, launches: int, hw: dict) -> dict:
    """The SSD backward kernels at the first training call (mamba2-130m: B
    4, S 2048, 24 heads of 64, state 128, bf16). Bound
    (``ssd_scan_backward``): bytes, x, dy, B, C, a, dt (and the initial
    state and the final state's gradient where given) read once, dx, dB,
    dC, da, ddt (and dinit) written once, against the recurrence's
    backward, twice the forward's 6 P N flops per (step, head), on the
    tensor cores. No single PyTorch call
    computes it. ``phase_kernel_ms``: the call by kernel with the
    wrapper's copies, from a fresh process (``fresh_phases``)."""
    import functools

    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_backward_ref

    (x, a, dt, B, C, dy, dfinal), kw = call
    init = kw.get("init_state")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    got = sk.ssd_scan_backward(x, a, dt, B, C, dy, dfinal, init_state=init)
    want = ssd_backward_ref(x.float(), a, dt, B.float(), C.float(), dy.float(), dfinal,
                            init_state=init)
    err = 0.0
    for name, gg, w in zip(("dx", "da", "ddt", "dB", "dC", "dinit"), got, want):
        if w is None:
            continue
        tol = SSD_GRAD_TOL
        if x.dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
            tol = (1e-2, 1e-3 * float(w.abs().max()))
        err = max(err, check_close(f"ssd_scan_backward {name} on the path's call", gg, w,
                                   tol=tol))
    fn = functools.partial(sk.ssd_scan_backward, init_state=init)
    ms = graph_ms(rotating(fn, x, a, dt, B, C, dy, dfinal), iters=5)
    return {
        "name": "ssd_scan_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_backward.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:65",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "kernel_ms": ms,
        "eager_ms": time_ms(rotating(fn, x, a, dt, B, C, dy, dfinal), iters=20),
        "plain_ms": time_ms(rotating(functools.partial(ssd_backward_ref, init_state=init),
                                     x, a, dt, B, C, dy, dfinal), iters=3, warmup=1),
        **bound_fields(hw, "ssd_scan_backward",
                       {"batch": b, "seq": s, "heads": h, "head_dim": p, "groups": g,
                        "state_dim": n, "dtype_bytes": x.element_size(),
                        "init_state": init is not None, "final_state_grad": dfinal is not None},
                       ms, "bf16"),
        "library_ms": None,
        **fresh_phases("ssd"),
        "shape": {"B": b, "S": s, "H": h, "P": p, "G": g, "N": n, "dtype": str(x.dtype),
                  "init_state": init is not None, "final_state_grad": dfinal is not None},
    }


def kernels_ms(fn, match: str, calls: int = 20) -> dict | str:
    """Device ms a call of ``fn`` spends in each CUDA kernel whose name holds
    ``match``, by the name's part after it (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and match in evt.name:
            name = evt.name.split(match, 1)[1].split("<")[0].split("(")[0].strip("_") or match
            out[name] = out.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / calls
    return out or "not measured (the trace held no device events)"


def fresh_phases(only: str) -> dict:
    """A backward call's device time by kernel at the training call's shape,
    traced by ``tools/bwd_probe.py --only <only>`` in a fresh process,
    beside that process's graph-replay ms: a trace of a few milliseconds
    taken this late in this script loses device events (PERF.md §6)."""
    out = WORKDIR / f"bwd_probe_{only}.json"
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "bwd_probe.py"), "--only", only,
                          "--out", str(out)], capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"tools/bwd_probe.py --only {only} failed:\n{res.stderr[-3000:]}")
    got = json.loads(out.read_text())["ssd_backward" if only == "ssd" else "flash_backward"]
    prof = got["profile_rotated"]
    return {"phase_kernel_ms": prof["kernels_ms"], "phase_sum_ms": prof["kernels_sum_ms"],
            "phase_graph_ms": got["graph_ms_rotated"],
            "phase_source": f"tools/bwd_probe.py --only {only}, a fresh process"}


def time_ssd(call, launches: int, hw: dict) -> dict:
    """The SSD kernels at the mamba2-130m prefill's call, the whole call and
    each of its three kernels. Bound (``ssd_scan``): x, B, C, a, dt and the
    initial state read once, y and the final state written once, against
    the recurrence's 6 P N flops per (step, head) on the tensor cores (the
    formula of the first, step-by-step kernel, kept so that the row
    compares across designs)."""
    import functools

    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_chunked_ref

    (x, dt, A, B, C), kw = call
    init = kw["init_state"]
    a = dt * A[None, None, :]
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y, state = sk.ssd_scan_fused(x, a, dt, B, C, **kw)
    want_y, want_st = ssd_chunked_ref(x, a, dt, B, C, **kw)
    err = max(
        check_close(f"ssd_scan y on the path's call B={b} S={s} H={h} P={p} N={n}", y, want_y,
                    tol=SSD_TOL[x.dtype]),
        check_close("ssd_scan final state on the same call", state, want_st,
                    tol=SSD_TOL[torch.float32]),
    )
    ys, fs = torch.empty_like(y), torch.empty_like(state)
    launch = rotating(lambda *t: sk.launch_ssd_scan(*t, init, ys, fs), x, a, dt, B, C)
    ms = graph_ms(rotating(functools.partial(sk.ssd_scan_fused, **kw), x, a, dt, B, C), iters=5)
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:65",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "kernel_ms": graph_ms(launch, iters=5),
        "phase_kernel_ms": kernels_ms(launch, "ssd_scan_kernel_"),
        "eager_ms": time_ms(rotating(functools.partial(sk.ssd_scan_fused, **kw), x, a, dt, B, C),
                            iters=20),
        "plain_ms": time_ms(rotating(functools.partial(ssd_chunked_ref, **kw), x, a, dt, B, C),
                            iters=5, warmup=2),
        **bound_fields(hw, "ssd_scan",
                       {"batch": b, "seq": s, "heads": h, "head_dim": p, "groups": g,
                        "state_dim": n, "dtype_bytes": x.element_size(),
                        "init_state": init is not None}, ms, "bf16"),
        "library_ms": None,
        "shape": {"B": b, "S": s, "H": h, "P": p, "G": g, "N": n, "chunk": kw["chunk"],
                  "kernel_chunk": sk.kernel_chunk(x.dtype), "dtype": str(x.dtype)},
    }


# ---------------------------------------------------------------------------
# the production-mesh dry run
# ---------------------------------------------------------------------------

DRYRUN = (("mixtral-8x7b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
          ("deepseek-v2-lite-16b", "decode_32k"))
WORLD1 = ("gemma-2b", {"seq": 2048, "batch": 4, "kind": "decode"})
ALLOC_ROUND = 512  # the caching allocator's rounding of a block, bytes


# the world-1 check: the dry run's arguments on a (1, 1) mesh, then the
# same tensors built on the card; prints one JSON line
WORLD1_CODE = f"""
import json, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
import torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer.model import init_cache, init_params
cfg, shape = get_config(sys.argv[1]), json.loads(sys.argv[2])
with dryrun.fake_group(1):
    want = dryrun.trace_step(cfg, shape, make_local_mesh(1),
                             weight_dtype=None)["memory"]["argument_bytes"]
torch.cuda.init()
before = torch.cuda.memory_allocated()
params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
cache = init_cache(cfg, shape["batch"], shape["seq"], "cuda")
inputs = torch.zeros((shape["batch"], 1), dtype=torch.int32, device="cuda")
torch.cuda.synchronize()
grown = torch.cuda.memory_allocated() - before
leaves = [inputs] + [t for layer in cache for t in layer.values() if torch.is_tensor(t)]
stack = [params]
while stack:
    x = stack.pop()
    if isinstance(x, dict):
        stack.extend(x.values())
    elif isinstance(x, list):
        stack.extend(x)
    else:
        leaves.append(x)
print(json.dumps({{"allocated_bytes": grown, "argument_bytes": want, "tensors": len(leaves)}}))
"""


def dryrun_phase(card: str) -> dict:
    """``run_one`` for ``DRYRUN`` on the single mesh, printed against the
    card's memory, and the world-1 accounting check on the card."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    result: dict = {"card_total_memory_bytes": total}
    for arch, shape in DRYRUN:
        r = dryrun.run_one(arch, shape, False, None, verbose=False)
        mem, rf = r["memory"], r["roofline"]
        log(f"  {arch} x {shape} x {r['mesh']}: per device peak "
            f"{mem['peak_bytes_per_device'] / 2**30:.2f} GiB, arguments "
            f"{mem['argument_bytes'] / 2**30:.2f} GiB, of the card's {total / 2**30:.2f} GiB "
            f"({card}); dominant {rf['dominant']} (compute {rf['compute_s'] * 1e3:.2f} ms, "
            f"memory {rf['memory_s'] * 1e3:.2f} ms, collective {rf['collective_s'] * 1e3:.2f} "
            f"ms); collective bytes {r['collectives']['total_bytes']} "
            f"{r['collectives']['bytes']}; trace {r['trace_s']} s")
        result[f"{arch}/{shape}"] = {"memory": mem, "dominant": rf["dominant"],
                                  "step_time_bound_s": rf["step_time_bound_s"],
                                  "collective_bytes": r["collectives"]["total_bytes"],
                                  "trace_s": r["trace_s"]}
    # in a fresh process: nothing else there allocates on the card
    arch, shape = WORLD1
    out = subprocess.run([sys.executable, "-c", WORLD1_CODE, arch, json.dumps(shape)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"world-1 accounting process exited {out.returncode}: {out.stderr[-2000:]}")
    w1 = json.loads(out.stdout.strip().splitlines()[-1])
    grown, want, tensors = w1["allocated_bytes"], w1["argument_bytes"], w1["tensors"]
    log(f"  world 1, {arch} bf16 params + decode cache {shape['batch']} x {shape['seq']} "
        f"(a fresh process): memory_allocated grew {grown} bytes; the dry run's "
        f"argument_bytes {want} ({tensors} tensors, at most {ALLOC_ROUND} bytes of rounding "
        f"each)")
    if not 0 <= grown - want < ALLOC_ROUND * tensors:
        fail(f"world-1 accounting: the card holds {grown} bytes, the dry run counts {want}")
    result["world1"] = {"arch": arch, "shape": shape, **w1}
    result["phase_s"] = time.perf_counter() - t0
    log(f"  dryrun phase {result['phase_s']:.1f} s")
    return result


SAMPLED_ROWS = ("segment_spmm_ragged", "gat_softmax_aggregate", "gather_spmm_ragged",
                "gather_spmm_ragged_backward")


def save_calls(captured: dict, path: str) -> None:
    """The sampled paths' largest calls (rows 1, 2, 3, 3b), on the CPU, for
    ``tools/time_sampled_rows.py`` to time another tree's kernels on."""
    calls = {k: tuple(a.detach().cpu() if torch.is_tensor(a) else a for a in captured[k])
             for k in SAMPLED_ROWS}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, path)
    log(f"saved the sampled paths' largest calls to {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save-calls", metavar="PATH",
                    help="also save the sampled paths' largest calls (tools/time_sampled_rows.py)")
    ap.add_argument("--tuned-turns", metavar="ROUNDS", type=int, default=0,
                    help="instead of the whole run: ROUNDS of untuned / tuned SAGE and GAT "
                         "passes in turns (tuned_turns)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph import named_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.roofline import hardware

    card = device_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    hw = hardware(kind)  # an unknown card fails here: its shares would be wrong
    log(f"roofline peaks (repro_torch.launch.roofline.HW): {hw}")
    t_start = time.perf_counter()
    shutil.rmtree(WORKDIR, ignore_errors=True)
    WORKDIR.mkdir(parents=True)

    build_kernels()
    if args.tuned_turns:
        return tuned_turns(args.tuned_turns)
    compare_kernels()
    compare_training_kernels()
    dense_small()
    compare_lm_kernels()
    compare_lm_backward_kernels()

    # first among the paths: recurrentgemma-2b's float32 weights, gradients
    # and moments take 46 GB, so nothing of the other phases stays beside them
    log("phase: LM training at full width (LMTrainer: bf16 on float32 weights, remat per "
        "layer, the reference's AdamW)")
    lm_train_captured: dict = {}
    lm_train = {}
    for arch in LM_TRAIN:
        torch.cuda.empty_cache()  # the earlier model's weights, gradients and moments
        lm_train[arch] = train_lm(arch, lm_train_captured, hw)
    train_launches = {k: sum(v["launches"].get(k, 0) for v in lm_train.values())
                      for k in ("flash_attention_backward", "ssd_scan_backward")}


    log("phase: build the system (ogbn-paper stand-in, 4 parts, fanouts 15/10/5)")
    t0 = time.perf_counter()
    g = named_dataset("ogbn-paper", feat_dim=128, num_classes=16, seed=0, scale=1.0)
    system = GLISPSystem.build(g, GLISPConfig(num_parts=4, fanouts=(15, 10, 5), seed=0))
    log(f"  graph {g.num_vertices} vertices {g.num_edges} edges; "
        f"build {time.perf_counter() - t0:.2f} s")

    launches = {k: 0 for k in (
        "segment_spmm_ragged", "gat_softmax_aggregate", "gather_spmm_ragged",
        "gather_spmm_ragged_backward", "gat_softmax_aggregate_backward")}
    captured: dict = {}
    seg_max, seg_max_call = segment_max_path(g)
    dense, dense_calls = dense_form_path(g)
    passes: dict = {}
    log("phase: SAGE 128->256x3, infer_layerwise + serving")
    sage = run_model(system, "sage", "segment_spmm_ragged", launches, captured, passes)
    log("phase: GAT 4 heads 128->256x3, infer_layerwise + serving")
    gat = run_model(system, "gat", "gat_softmax_aggregate", launches, captured, passes)
    log("phase: autotune (every launch shape bitwise; infer_layerwise with kernel_autotune, "
        "SAGE and GAT, bitwise the untuned passes; the artifact from a fresh process)")
    tuned = autotune_phase(system, passes)
    del passes

    train_ids = np.sort(np.random.default_rng(0).choice(g.num_vertices, g.num_vertices // 5,
                                                        replace=False))
    log(f"phase: training, {len(train_ids)} training vertices, batch "
        f"{system.config.batch_size}, prefetch {system.config.prefetch}")
    trained = {k: train_model(system, k, train_ids, launches, captured) for k in TRAIN_STEPS}
    log("phase: determinism (two runs, and a checkpoint-resume run)")
    det = {k: determinism(system, k, train_ids) for k in TRAIN_STEPS}
    log(f"phase: the training launcher, gcn-products and hgt-relnet, one epoch at scale "
        f"{LAUNCH_SCALE}")
    launched = {c: launcher_train(c, launches) for c in LAUNCH_PER_STEP}

    log(f"phase: transformer serving at full width (batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_GEN} greedy tokens)")
    lm_captured: dict = {}
    lm = {}
    for arch, (kernel, f32_layers) in LM_ARCHS.items():
        torch.cuda.empty_cache()  # the earlier model's weights and caches
        lm[arch] = serve_lm(arch, kernel, f32_layers, lm_captured, hw)

    log(f"phase: the distributed tier: {DIST_REQUESTS} requests through forked sampling "
        f"workers (mp, socket), data-parallel SAGE and GAT at S = {DP_SHARDS}")
    dist = dist_phase(g, system, train_ids, launches)

    log("phase: the production-mesh dry run (fake 256-rank group, DTensors, on the host) and "
        "its accounting on the card at world 1")
    dry = dryrun_phase(card)

    log("phase: kernel times at the path's largest shapes (CUDA events, 100 calls, "
        f"{COPIES} rotating input copies)")
    rows = [
        time_segment_sum(captured["segment_spmm_ragged"], launches["segment_spmm_ragged"], hw),
        time_gat(captured["gat_softmax_aggregate"], launches["gat_softmax_aggregate"], hw),
        time_gather(captured["gather_spmm_ragged"], launches["gather_spmm_ragged"], hw),
        time_gather_backward(captured["gather_spmm_ragged_backward"],
                             launches["gather_spmm_ragged_backward"], hw),
        time_gat_backward(captured["gat_softmax_aggregate_backward"],
                          launches["gat_softmax_aggregate_backward"], hw),
        time_segment_max(seg_max_call, seg_max["launches"], hw),
        *time_dense_forms(dense_calls, dense["launches"], hw),
        time_flash(lm_captured["gemma-2b"], lm["gemma-2b"]["launches"]["flash_attention"], hw),
        time_flash(lm_captured["deepseek-v2-lite-16b"],
                   lm["deepseek-v2-lite-16b"]["launches"]["flash_attention"], hw,
                   name="flash_attention_mla"),
        time_ssd(lm_captured["mamba2-130m"], lm["mamba2-130m"]["launches"]["ssd_scan"], hw),
        time_flash_backward(lm_train_captured["flash_attention_backward"],
                            train_launches["flash_attention_backward"], hw),
        time_ssd_backward(lm_train_captured["ssd_scan_backward"],
                          train_launches["ssd_scan_backward"], hw),
    ]
    for r in rows:
        if r["launches"] <= 0:
            fail(f"{r['name']} was never launched on the main path")
        log(f"  {r['name']}: ms {r['ms']:.4f} kernel_ms {r['kernel_ms']:.4f} "
            f"eager_ms {r['eager_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{r['roofline_op']}; share {r['bound_share']:.3f}) library_ms {r['library_ms']}")
        if "phase_kernel_ms" in r:
            log(f"    {r['name']}: by kernel {r['phase_kernel_ms']}")
        if "library_from_ids_ms" in r:
            log(f"    {r['name']}: ms / library from the ids {r['ms_over_library_from_ids']:.3f}; "
                f"kernel_ms / library {r['kernel_ms_over_library']:.3f}; "
                f"kernel_ms / bound {r['kernel_ms_over_bound']:.3f}")
        if "library_graph_ms" in r:
            ratio = r["ms_over_library_graph"]
            log(f"    {r['name']}: SDPA by graph replay {r['library_graph_ms']} ms; kernel / "
                f"SDPA {'n/a' if ratio is None else f'{ratio:.3f}'}"
                + (f" ({r['library_graph_note']})" if r["library_graph_note"] else ""))
    log("summary: " + json.dumps({
        "sage_infer_wall_s": sage["wall_s"],
        "gat_infer_wall_s": gat["wall_s"],
        "sage_slice_device_span_ms": sage["slice_device_span_ms"],
        "gat_slice_device_span_ms": gat["slice_device_span_ms"],
        "serve_bitwise": {"sage": sage["serve"]["bitwise_equal"],
                          "gat": gat["serve"]["bitwise_equal"]},
        "autotune": {"passes": tuned["passes"], "check_s": tuned["check_s"],
                     "phase_s": tuned["phase_s"]},
        "train": {k: {"step_wall_ms_mean": v["step_wall_ms_mean"],
                      "step_wall_ms_steady_median": v["step_wall_ms_steady_median"],
                      "device_idle_share": v["device_idle_share"],
                      "first_loss": v["losses"][0], "last_loss": v["losses"][-1]}
                  for k, v in trained.items()},
        "determinism": det,
        "samplewise": {k: {key: v["samplewise"][key] for key in (
            "wall_s", "vertices_computed", "edges_aggregated", "feature_rows_read",
            "computations_ratio", "wall_ratio")} for k, v in (("sage", sage), ("gat", gat))},
        "launch_train": {c: {key: v[key] for key in (
            "steps", "step_wall_ms_steady_median", "first_loss", "last_loss", "test_acc",
            "launches")} for c, v in launched.items()},
        "dist": {
            "sampling": {t: {key: dist[t][key] for key in (
                "requests_per_s", "inproc_requests_per_s", "dispatch_ms_p50",
                "dispatch_ms_p95", "server_workloads")} for t in ("mp", "socket")},
            "dp": {k: {key: v[key] for key in (
                "step_wall_ms_steady_median", "sample_s", "compute_s",
                "merged_step_device_ms_median", "twin_step_device_ms_median",
                "device_idle_share", "max_rel_loss_diff")}
                for k, v in dist["dp"].items()},
            "phase_s": dist["phase_s"]},
        "segment_max_path": seg_max,
        "dense_form_path": {k: v for k, v in dense.items() if k != "launches"},
        "lm_serve": {k: {key: v[key] for key in (
            "prefill_ms", "again_prefill_ms", "decode_ms_per_token", "roofline", "peak_memory_gb",
            "two_runs_bitwise_equal", "f32_depth", "f32_logits_max_abs_err_vs_plain",
            "f32_routing_flips_per_layer", "bf16_kernels_err_vs_f32",
            "bf16_plain_err_vs_f32")} for k, v in lm.items()},
        "lm_train": {k: {key: v[key] for key in (
            "step_wall_ms_steady_median", "step_wall_ms_simt_backward", "tokens_per_s",
            "roofline", "losses", "launches_per_step",
            "f32_depth", "f32_worst_grad_share", "bf16_step_bitwise_run_to_run",
            "bf16_grad_leaves_not_bitwise", "peak_memory_gb")} for k, v in lm_train.items()},
        "dryrun": dry,
        "total_s": time.perf_counter() - t_start,
    }))
    if args.save_calls:
        save_calls(captured, args.save_calls)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
