"""Launch-shape autotuner for the GNN kernels on the card.

Counterpart of ``repro/kernels/autotune.py``. The TPU kernels tile the
edges for the MXU, and the reference sweeps the tiles. Each kernel here
gives a destination row one group of threads, and three launch choices
say how:

* ``vec``, the elements each thread loads at once (16 bytes at most);
* ``tpr``, the threads of a row group (a power of two up to a warp);
* ``lean``, which of the sum kernel's two builds runs
  (``csrc/segment_sum.cu``): one edge at a time, or a batch of edges.

Untuned, ``fused_gnn`` picks them by a heuristic (:func:`default_config`).
Every choice adds each column in edge order and a long row in chunk
order, so a choice moves time and never bits.

* The key is ``(op, shape bucket, dtype)`` with every dim rounded up to a
  power of two: the reference's strings letter for letter
  (``gather_spmm/256x64x16/float32``), so one sweep covers every batch of
  an engine bucket.
* Winners live in a table of the process, which ``fused_gnn``'s forward
  launches read at call time (:func:`get_tuned`), and optionally in a
  content-addressed JSON artifact. Its name hashes the tuner version, the
  candidate grid and the card's name, so a stale artifact, a winner timed
  on another card and the reference's artifacts are never read.
* The candidates are a fixed grid (:data:`CANDIDATES`). At a shape a
  candidate is skipped before any launch when its ``vec`` does not divide
  the row, or when ``tpr * vec`` exceeds the row rounded up to a power of
  two (lanes that would load nothing).
* The heuristic's choice is timed first, then the grid in order. Another
  candidate wins only where it is faster than the best so far by more
  than :data:`MARGIN`, 3%, the event timer's run-to-run noise on one card.
  This departs from the reference's strict ``argmin`` (ties to the
  earlier candidate): there, noise moves the winner from run to run; here
  the heuristic stays unless a candidate is clearly faster.
* The inputs come from a fixed numpy seed: the reference's arrays, drawn
  in the reference's order, then moved to the card. Only the kernel whose
  launch is chosen is timed. Its CSR index, and the sort of the dense
  forms, are built once outside. Each candidate is launched once on each
  of 4 copies of the inputs (a launch that fails raises), then timed with
  CUDA events over a run of launches rotated over the copies, best of
  ``repeats``. The card sleeps while the host issues the run, so the
  events time the kernels and not the host.
* The GAT aggregate is timed on one head at the bucket's shape, as the
  reference's kernel runs. The port's layers launch all heads at once,
  with the same work for each (row, head) group.

On a CPU device there is nothing to tune: the plain versions have no
launch choice, and :func:`autotune` raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time

import numpy as np
import torch

__all__ = [
    "KernelConfig",
    "default_config",
    "TUNE_VERSION",
    "MARGIN",
    "TUNED_OPS",
    "CANDIDATES",
    "dtype_name",
    "tuned_key",
    "valid_candidates",
    "get_tuned",
    "autotune",
    "autotune_for_slice",
    "artifact_path",
    "stats",
    "sweeps",
    "reset",
]

TUNE_VERSION = 1
MARGIN = 0.03  # a candidate must beat the best so far by more than this share
TUNED_OPS = (
    "segment_spmm",
    "segment_spmm_ragged",
    "gather_spmm",
    "gather_spmm_ragged",
    "gat_softmax_aggregate",
    "segment_max",
)
_SUM_OPS = TUNED_OPS[:4]  # the ops that launch the CSR sum kernel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_VECS = {"float32": (4, 2, 1), "bfloat16": (8, 4, 2, 1)}  # 16 bytes a load at most
_TPRS = (1, 2, 4, 8, 16, 32)
_COPIES = 4  # rotating input copies
_RUNS = 20  # launches a timed run
_SLEEP_CYCLES = 100_000  # card cycles slept per launch of a run while the host issues it


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """A launch of a GNN kernel: elements per load, threads per row group,
    and (the sum kernel only) 1 for the lean build, 0 for the batched."""

    vec: int
    tpr: int
    lean: int = 1


def _candidates(op: str, dtype: str) -> tuple[KernelConfig, ...]:
    if op == "segment_max":  # one kernel, no launch choice
        return (KernelConfig(1, 1, 1),)
    leans = (1, 0) if op in _SUM_OPS else (1,)
    return tuple(
        KernelConfig(v, t, lean) for v in _VECS[dtype] for t in _TPRS for lean in leans
    )


CANDIDATES = {op: {d: _candidates(op, d) for d in _DTYPES} for op in TUNED_OPS}

_TUNED: dict[str, KernelConfig] = {}
_STATS = {"memory_hits": 0, "artifact_hits": 0, "measured": 0}
_SWEEPS: dict[str, dict] = {}


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def dtype_name(dtype) -> str:
    """The JAX name of a torch, numpy or named dtype: ``torch.bfloat16``
    and ``"bfloat16"`` give ``"bfloat16"``, ``np.float32`` ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype in _DTYPES:
        return dtype
    return np.dtype(dtype).name


def tuned_key(op: str, shape, dtype) -> str:
    """Cache key: op / pow2-bucketed dims / dtype name."""
    dims = "x".join(str(_pow2(d)) for d in shape)
    return f"{op}/{dims}/{dtype_name(dtype)}"


def default_config(op: str, shape, dtype) -> KernelConfig:
    """The heuristic's launch for ``op`` at ``shape`` = (edges, rows, row
    width) on aligned tensors: what ``fused_gnn`` launches untuned."""
    from repro_torch.kernels import fused_gnn

    if op == "segment_max":
        return CANDIDATES[op]["float32"][0]
    e, n, row = (int(d) for d in shape)
    tdtype = _DTYPES[dtype_name(dtype)]
    vec, tpr = fused_gnn.heuristic_vec_tpr(row, tdtype.itemsize)
    lean = fused_gnn._lean(e, n, tdtype) if op in _SUM_OPS else 1
    return KernelConfig(vec, tpr, lean)


def valid_candidates(op: str, shape, dtype) -> tuple[KernelConfig, ...]:
    """The configs the sweep times at ``shape``'s bucket, in order: the
    heuristic's, then the grid's, less those whose ``vec`` does not divide
    the row or whose ``tpr * vec`` exceeds the row rounded up to a power of
    two."""
    bucket = tuple(_pow2(d) for d in shape)
    row = bucket[2]
    first = default_config(op, bucket, dtype)
    rest = tuple(
        c
        for c in CANDIDATES[op][dtype_name(dtype)]
        if c != first and row % c.vec == 0 and c.tpr * c.vec <= row
    )
    return (first,) + rest


def get_tuned(op: str, shape, dtype) -> KernelConfig | None:
    """Best known config for this shape bucket, or None if never tuned."""
    if not _TUNED:
        return None
    return _TUNED.get(tuned_key(op, shape, dtype))


def stats() -> dict:
    return dict(_STATS)


def sweeps() -> dict:
    """Each sweep of this process by key: the heuristic's config and time,
    the winner's, the candidates timed and the sweep's seconds."""
    return {k: dict(v) for k, v in _SWEEPS.items()}


def reset(clear_stats: bool = True) -> None:
    """Drop the in-process table and sweep record (artifacts on disk
    survive): a test hook, and how a caller returns to the heuristic."""
    _TUNED.clear()
    _SWEEPS.clear()
    if clear_stats:
        for k in _STATS:
            _STATS[k] = 0


# -- content-addressed artifact ---------------------------------------------


def _identity(device_name: str) -> dict:
    return {
        "version": TUNE_VERSION,
        "device": device_name,
        "candidates": {
            op: {d: [dataclasses.asdict(c) for c in cands] for d, cands in grid.items()}
            for op, grid in CANDIDATES.items()
        },
    }


def artifact_path(cache_dir: str, device_name: str | None = None) -> str:
    """The artifact name embeds a digest of the tuner identity (version,
    candidate grid, and the card's name, by default
    ``torch.cuda.get_device_name()``), so incompatible tuners and other
    cards read and write different files."""
    name = torch.cuda.get_device_name() if device_name is None else device_name
    digest = hashlib.sha256(
        json.dumps(_identity(name), sort_keys=True).encode()
    ).hexdigest()[:16]
    return os.path.join(cache_dir, f"kernel_tune_v{TUNE_VERSION}_{digest}.json")


def _load_artifact(cache_dir: str, device_name: str) -> dict[str, KernelConfig]:
    path = artifact_path(cache_dir, device_name)
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    return {k: KernelConfig(**v) for k, v in raw.get("configs", {}).items()}


def _store_artifact(cache_dir: str, configs: dict[str, KernelConfig], device_name: str) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    path = artifact_path(cache_dir, device_name)
    payload = dict(_identity(device_name))
    payload["configs"] = {k: dataclasses.asdict(v) for k, v in sorted(configs.items())}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)  # atomic: readers never see a torn file


# -- measurement -------------------------------------------------------------


def _arrays(shape) -> dict:
    """The reference's measurement arrays at the bucketed shape, drawn in
    its order (float32 before the cast). The tail quarter of edges is
    padding."""
    edges, segments, dim = (_pow2(d) for d in shape)
    rng = np.random.default_rng(0)
    valid = (3 * edges) // 4
    seg = np.sort(rng.integers(0, segments, edges)).astype(np.int32)
    seg[valid:] = -1
    idx = rng.integers(0, segments, edges).astype(np.int32)
    idx[valid:] = -1
    feats = rng.standard_normal((segments, dim)).astype(np.float32)
    msg = rng.standard_normal((edges, dim)).astype(np.float32)
    logits = rng.standard_normal(edges).astype(np.float32)
    return {"seg": seg, "idx": idx, "feats": feats, "msg": msg, "logits": logits,
            "n": segments}


def _inputs(op: str, shape, dtype, device="cuda") -> dict:
    """Deterministic measurement inputs at the bucketed shape on
    ``device``: :func:`_arrays`, the floats cast to ``dtype``."""
    a = _arrays(shape)
    cast = _DTYPES[dtype_name(dtype)]
    out = {k: torch.as_tensor(a[k], device=device) for k in ("seg", "idx")}
    out.update({k: torch.as_tensor(a[k], device=device).to(cast)
                for k in ("feats", "msg", "logits")})
    out["n"] = a["n"]
    return out


def _kernel(op: str, inp: dict):
    """A function of a :class:`KernelConfig` that launches ``op``'s kernel
    once on ``inp`` and returns its output. Its operands (the CSR index,
    after the stable sort for the dense forms) are built here, once, and
    nothing is counted in ``fused_gnn.LAUNCHES``."""
    from repro_torch.kernels import fused_gnn as fg

    n, seg = inp["n"], inp["seg"]
    dev = seg.device
    if op == "segment_max":
        keys = fg.segment_max_keys(n, dev)
        out = torch.empty(n, dtype=inp["logits"].dtype, device=dev)

        def launch(cfg):
            fg.launch_segment_max(inp["logits"], seg, keys, out)
            return out

        return launch
    if op == "gat_softmax_aggregate":
        msg = inp["msg"]
        e, d = msg.shape
        lf = inp["logits"].float().view(e, 1)
        mv = msg.view(e, 1, d)
        index = fg.segment_index(seg, n)
        out = torch.empty((n, 1, d), dtype=msg.dtype, device=dev)

        def launch(cfg):
            fg.launch_gat_softmax_aggregate(lf, mv, seg, index, out, config=cfg)
            return out.view(n, d)

        return launch
    src = inp["msg"] if op.startswith("segment") else inp["feats"]
    idx = inp["idx"]
    if op in ("segment_spmm", "gather_spmm"):
        keys, perm = torch.empty_like(seg), torch.empty_like(seg)
        gathered = None if op == "segment_spmm" else torch.empty_like(seg)
        fg.launch_segment_sort(seg, n, keys, perm, None if gathered is None else idx, gathered)
        seg, idx = keys, (perm if gathered is None else gathered)
    index = fg.segment_index(seg, n)
    out = torch.empty((n, src.shape[1]), dtype=src.dtype, device=dev)
    if op == "segment_spmm_ragged":

        def launch(cfg):
            fg.launch_segment_sum(src, seg, index, out, config=cfg)
            return out

        return launch

    def launch(cfg):
        fg.launch_gather_sum(src, idx, seg, index, out, config=cfg)
        return out

    return launch


def _time_ms(launches: list, repeats: int) -> float:
    """The best of ``repeats`` mean times of one launch, from CUDA events
    around a run of :data:`_RUNS` launches rotated over ``launches``,
    each run issued while the card sleeps."""
    for f in launches:  # warm-up; a launch that fails raises here
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(_SLEEP_CYCLES * _RUNS)
        start.record()
        for i in range(_RUNS):
            launches[i % len(launches)]()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / _RUNS)
    return best


def _pick(times: list[float]) -> int:
    """The index of the winner: the first entry (the heuristic's) unless a
    later one is faster than the best so far by more than :data:`MARGIN`."""
    best = 0
    for i in range(1, len(times)):
        if times[i] < times[best] * (1.0 - MARGIN):
            best = i
    return best


def _sweep(op: str, shape, dtype, repeats: int, device) -> tuple:
    """(candidates, their times in ms) of ``op`` at ``shape``'s bucket."""
    cands = valid_candidates(op, shape, dtype)
    inp = _inputs(op, shape, dtype, device)
    copies = [inp] + [
        {k: v.clone() if torch.is_tensor(v) else v for k, v in inp.items()}
        for _ in range(_COPIES - 1)
    ]
    kernels = [_kernel(op, c) for c in copies]
    times = [_time_ms([functools.partial(k, cfg) for k in kernels], repeats) for cfg in cands]
    return cands, times


def autotune(
    op: str,
    shape,
    dtype,
    *,
    cache_dir: str | None = None,
    repeats: int = 3,
    device="cuda",
) -> KernelConfig:
    """Best launch for (op, shape bucket, dtype) on the CUDA ``device``:
    in-process table first, then the cache artifact, then a measured sweep
    (whose winner is merged back into the artifact when ``cache_dir`` is
    given). A CPU device raises ``ValueError``."""
    if op not in CANDIDATES:
        raise ValueError(f"unknown tuned op {op!r} (have {sorted(CANDIDATES)})")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"autotune needs a CUDA device, got {dev}: the plain versions on the "
            "CPU have no launch choice"
        )
    if dtype_name(dtype) not in _DTYPES:
        raise ValueError(f"the kernels take float32 and bfloat16, got {dtype}")
    key = tuned_key(op, shape, dtype)
    if key in _TUNED:
        _STATS["memory_hits"] += 1
        return _TUNED[key]
    card = torch.cuda.get_device_name(dev)
    if cache_dir is not None:
        cached = _load_artifact(cache_dir, card)
        if key in cached:
            _STATS["artifact_hits"] += 1
            _TUNED[key] = cached[key]
            return cached[key]
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        cands, times = _sweep(op, shape, dtype, repeats, dev)
    win = _pick(times)
    best = cands[win]
    _SWEEPS[key] = {
        "heuristic": dataclasses.asdict(cands[0]), "heuristic_ms": times[0],
        "winner": dataclasses.asdict(best), "winner_ms": times[win],
        "candidates": len(cands), "sweep_s": time.perf_counter() - t0,
    }
    _STATS["measured"] += 1
    _TUNED[key] = best
    if cache_dir is not None:
        merged = _load_artifact(cache_dir, card)
        merged[key] = best
        _store_artifact(cache_dir, merged, card)
    return best


def autotune_for_slice(shapes, dtype, *, cache_dir: str | None = None, device="cuda") -> None:
    """Tune a batch of (op, shape) pairs: the engine calls this with a
    layer slice's kernel shapes before the bucket's first slice, so the
    winners are in the table when that slice launches."""
    for op, shape in shapes:
        autotune(op, shape, dtype, cache_dir=cache_dir, device=device)
