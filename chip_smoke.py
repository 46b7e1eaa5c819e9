"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Builds the Hopper kernels from ``src/repro_torch/kernels/csrc/``, holds
each against its plain PyTorch version on the card, then runs the port's
serving path at the paper's model width on the ``ogbn-paper`` stand-in
graph (150,000 vertices, 1.05 M edges):
``GLISPSystem.build -> infer_layerwise -> server().submit/step/response``,
for SAGE (3 layers, 128 -> 256 -> 256 -> 256, fanouts 15/10/5) and for
GAT (4 heads, same widths). Weights are random, drawn with numpy from
seed 0. Launch counters are zeroed just before each path and read just
after; each path must have gone through its kernel.

Prints the ``-Xptxas -v`` build report, every comparison with its maximum
error, wall times, a ``{"kernels": [...]}`` line with each kernel's time,
bound, plain-version and library times, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises and
exits non-zero before that line. Exits non-zero without CUDA, and where
the repository's ``src/`` is missing.

Kernel times, at the largest batch each kernel saw on the path, with the
inputs rotated over four copies so that every call reads device memory:
``ms`` is the wrapper's device time (flag reset, offsets kernel,
reduction) from CUDA-graph replay, ``kernel_ms`` the reduction kernel
alone, ``eager_ms`` the wrapper called back to back from Python (bound by
host issue time); ``plain_ms`` and ``library_ms`` are eager calls timed
with CUDA events.

Tolerances: kernel vs plain float32 rtol 1e-5 / atol 1e-5; bfloat16
rtol 1e-2 / atol 1e-2, about one rounding of the output, against the plain
version run on the inputs upcast to float32 and rounded to bfloat16 (the
kernels sum in float32 and round once); whole layer slices and served
responses float32 rtol 1e-4 / atol 1e-5 (a matmul follows the
aggregation).
"""
from __future__ import annotations

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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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


# ---------------------------------------------------------------------------
# phases 4-5: the serving path at full width
# ---------------------------------------------------------------------------


class SliceRecorder:
    """Wraps a layer's tensor slice: keeps its first batch's inputs and
    brackets every call with CUDA events (no host sync)."""

    def __init__(self, fn):
        self.fn = fn
        self.first = None
        self.events = []

    def __call__(self, h_self, h_nbr, seg, etype):
        if self.first is None:
            self.first = (h_self, h_nbr, seg, etype)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(h_self, h_nbr, seg, etype)
        stop.record()
        self.events.append((start, stop))
        return out

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class LargestCall:
    """Wraps an aggregation entry point and keeps the arguments of its
    largest call (by message elements): the path's biggest kernel shape."""

    def __init__(self, fn):
        self.fn = fn
        self.args = None

    def __call__(self, *args):
        msg = args[-3]
        if self.args is None or msg.numel() > self.args[-3].numel():
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


def matmul_rows_equal(w: torch.Tensor, small: int, large: int) -> bool:
    """Whether ``x @ w`` gives its first ``small`` rows the same bits as
    a [small, K] product as inside a [large, K] one: serving's
    batched-equals-solo invariant needs it, and cuBLAS picks its algorithm
    per shape."""
    gen = torch.Generator(device=w.device).manual_seed(0)
    x = torch.randn(large, w.shape[0], generator=gen, device=w.device)
    return bool(torch.equal((x @ w)[:small], x[:small] @ w))


def serve(system, reqs, kernel: str, launches: dict, w: torch.Tensor) -> dict:
    """Serve ``reqs`` batched (all admitted, then drained), then each solo;
    responses must agree. ``w`` is the served layer's first weight, for the
    matmul check. Returns serving numbers."""
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
        np.testing.assert_allclose(b.embeddings, s.embeddings, rtol=1e-4, atol=1e-5)
        bitwise += int(np.array_equal(b.embeddings, s.embeddings))
        diff = max(diff, float(np.abs(b.embeddings - s.embeddings).max()))
    lat = solo.stats.latency
    small = system.infer_engine._vertex_bucket(max(len(np.unique(v)) for v in reqs))
    large = batched.stats.padded_rows // batched.stats.batches
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
        "matmul_rows_bitwise": {
            "solo_bucket": small,
            "batched_bucket": large,
            "K": w.shape[0],
            "equal": matmul_rows_equal(w, small, large),
        },
        "launches": fused_gnn.LAUNCHES[kernel],
    }
    log(f"  serve {kernel}: " + json.dumps(out))
    return out


def run_model(system, kind: str, kernel: str, launches: dict, captured: dict) -> dict:
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
    slice_ms = sum(r.device_ms() for r in recorders)
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
    info["serve"] = serve(system, zipf_requests(g, 32, 1), kernel, launches,
                          model.layers[-1]["w"])
    return info


# ---------------------------------------------------------------------------
# phase 6: kernel times at the path's largest shape
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


def time_segment_sum(args, launches: int) -> dict:
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
    nbytes = valid * d * msg.element_size() + e * 4 + n * d * msg.element_size()
    bound, by = bound_ms(nbytes, valid * d)
    return {
        "name": "segment_spmm_ragged",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/fused_gnn.py:220",
        "launches": launches,
        "max_abs_err": err,
        "ms": graph_ms(rotating(fused_gnn.segment_spmm_ragged, msg, seg, n)),
        "kernel_ms": graph_ms(rotating(fused_gnn.launch_segment_sum, msg, seg, index, out)),
        "eager_ms": time_ms(rotating(fused_gnn.segment_spmm_ragged, msg, seg, n)),
        "plain_ms": time_ms(rotating(segment_spmm_ref, msg, seg, n)),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(rotating(
            lambda x, o: torch.segment_reduce(x, "sum", offsets=o, axis=0), data, offsets
        )),
        "shape": {"E": e, "valid_edges": valid, "n": n, "D": d, "dtype": str(msg.dtype)},
    }


def time_gat(args, launches: int) -> dict:
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
    esize = msg.element_size()
    nbytes = valid * h * dh * esize + valid * h * 4 + e * 4 + n * h * dh * esize
    bound, by = bound_ms(nbytes, valid * h * (2 * dh + 3))
    return {
        "name": "gat_softmax_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gat_softmax_aggregate.cu",
        "replaces": "src/repro/kernels/fused_gnn.py:285",
        "launches": launches,
        "max_abs_err": err,
        "ms": graph_ms(rotating(fused_gnn.gat_softmax_aggregate, logits, msg, seg, n)),
        "kernel_ms": graph_ms(
            rotating(fused_gnn.launch_gat_softmax_aggregate, lf, msg, seg, index, out)
        ),
        "eager_ms": time_ms(rotating(fused_gnn.gat_softmax_aggregate, logits, msg, seg, n)),
        "plain_ms": time_ms(rotating(plain_gat, logits, msg, seg, n)),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "shape": {"E": e, "valid_edges": valid, "n": n, "H": h, "dh": dh,
                  "dtype": str(msg.dtype)},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph import named_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t_start = time.perf_counter()
    shutil.rmtree(WORKDIR, ignore_errors=True)

    build_kernels()
    compare_kernels()

    log("phase: build the system (ogbn-paper stand-in, 4 parts, fanouts 15/10/5)")
    t0 = time.perf_counter()
    g = named_dataset("ogbn-paper", feat_dim=128, num_classes=16, seed=0, scale=1.0)
    system = GLISPSystem.build(g, GLISPConfig(num_parts=4, fanouts=(15, 10, 5), seed=0))
    log(f"  graph {g.num_vertices} vertices {g.num_edges} edges; "
        f"build {time.perf_counter() - t0:.2f} s")

    launches = {"segment_spmm_ragged": 0, "gat_softmax_aggregate": 0}
    captured: dict = {}
    log("phase: SAGE 128->256x3, infer_layerwise + serving")
    sage = run_model(system, "sage", "segment_spmm_ragged", launches, captured)
    log("phase: GAT 4 heads 128->256x3, infer_layerwise + serving")
    gat = run_model(system, "gat", "gat_softmax_aggregate", launches, captured)

    log("phase: kernel times at the path's largest shapes (CUDA events, 100 calls, "
        f"{COPIES} rotating input copies)")
    rows = [
        time_segment_sum(captured["segment_spmm_ragged"], launches["segment_spmm_ragged"]),
        time_gat(captured["gat_softmax_aggregate"], launches["gat_softmax_aggregate"]),
    ]
    for r in rows:
        log(f"  {r['name']}: ms {r['ms']:.4f} kernel_ms {r['kernel_ms']:.4f} "
            f"eager_ms {r['eager_ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms {r['library_ms']}")
    log("summary: " + json.dumps({
        "sage_infer_wall_s": sage["wall_s"],
        "gat_infer_wall_s": gat["wall_s"],
        "sage_slice_device_span_ms": sage["slice_device_span_ms"],
        "gat_slice_device_span_ms": gat["slice_device_span_ms"],
        "total_s": time.perf_counter() - t_start,
    }))
    shutil.rmtree(WORKDIR, ignore_errors=True)
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
