"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). All sources are compiled
together, one ``nvcc`` process each, at the first call of :func:`library`,
into ``build/repro_torch_kernels/`` at the repository root, under a name
keyed by a hash of every source and flag: an edited source rebuilds, an
unchanged one loads the existing file. Nothing is built at import.

Every C entry returns ``cudaGetLastError()`` after its launch; the wrappers
raise on a non-zero code through :func:`check`. :func:`on_cpu` and
:func:`forbid_grad` are the wrappers' shared dispatch checks; the wrappers
with a backward kernel use :func:`wants_grad` instead of the latter.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library", "load_variant", "check",
    "ptxas_log", "on_cpu", "wants_grad", "forbid_grad",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c = ctypes.c_int
_l = ctypes.c_longlong
_p = ctypes.c_void_p
# C signatures of every entry, by library (source stem) and symbol
SIGNATURES = {
    "segment_sum": {
        "segment_offsets": (_p, _c, _c, _p, _p),
        "segment_index_words": (_c, _c),
        "segment_sum_scratch_rows": (_c,),
        "segment_sum": (_p, _p, _c, _p, _l, _c, _c, _c, _c, _c, _c, _p, _l, _p, _p),
        "gather_segment_sum": (_p, _p, _p, _c, _p, _l, _c, _c, _c, _c, _c, _c, _p, _l, _p, _p),
    },
    "segment_max": {
        "segment_max_key_words": (_c,),
        "segment_max": (_p, _p, _c, _c, _c, _p, _p, _p),
    },
    "segment_sort": {
        "segment_sort_pass": (_p, _p, _c, _c, _c, _c, _c, _c, _p, _p, _l, _p, _p, _p, _p),
    },
    "gat_softmax_aggregate": {
        "gat_softmax_aggregate": (_p, _p, _p, _c, _p, _c, _c, _c, _c, _c, _c, _p, _p, _p),
    },
    "gat_softmax_backward": {
        "gat_softmax_aggregate_backward": (
            _p, _p, _p, _p, _p, _p, _c, _p, _c, _c, _c, _c, _c, _c, _p, _p, _p,
        ),
    },
    "flash_attention": {
        "flash_attention": (_p,) * 6 + (_c,) * 11 + (_p,),
    },
    "flash_attention_backward": {
        "flash_attention_backward": (_p,) * 12 + (_c,) * 11 + (_p,),
    },
    "ssd_scan": {
        "ssd_scan_chunk": (_c,),
        "ssd_scan": (
            _p, _l, _l, _p, _p, _p, _l, _l, _p, _l, _l, _p, _p, _p, _p, _p,
            _c, _c, _c, _c, _c, _c, _c, _p,
        ),
    },
    "ssd_scan_backward": {
        "ssd_scan_backward_chunk": (),
        "ssd_scan_backward": (_p,) * 19 + (_c,) * 7 + (_p,),
    },
}
# entries that return a size; every other returns an int (a cudaError_t,
# or ``ssd_scan_chunk``'s and ``ssd_scan_backward_chunk``'s length)
RESTYPES = {"segment_index_words": _l, "segment_sum_scratch_rows": _l,
            "segment_max_key_words": _l}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that is not built yet, all in parallel;
    returns ``{stem: path of the shared library}``. Raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    targets = {
        src.stem: (src, BUILD_DIR / f"{src.stem}-{digest}.so")
        for src in sorted(CSRC.glob("*.cu"))
    }
    procs = {}
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, str(src)]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for stem, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        _LOGS[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, targets[stem][1])  # atomic: readers see a whole file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def ptxas_log() -> dict[str, str]:
    """nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) of
    each source compiled by this process (a variant's replaces its plain
    build's); empty for a library that was already built."""
    return dict(_LOGS)


def _bind(lib: ctypes.CDLL, stem: str) -> ctypes.CDLL:
    """Set ``argtypes``/``restype`` of every entry of ``lib`` (built from
    ``csrc/<stem>.cu``)."""
    for sym, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, sym)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(sym, _c)
    return lib


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building all
    sources first if needed, with ``argtypes``/``restype`` set."""
    if stem not in _LIBS:
        paths = build_all()
        for name, path in paths.items():
            if name in _LIBS:
                continue
            _LIBS[name] = _bind(ctypes.CDLL(str(path)), name)
    return _LIBS[stem]


def load_variant(stem: str, *flags: str) -> ctypes.CDLL:
    """Build ``csrc/<stem>.cu`` with the extra nvcc ``flags`` (a debug
    define) into a file of its own and load it in place of the plain build
    for the rest of the process; every other library loads as usual."""
    for name in SIGNATURES:
        library(name)
    fd, tmp = tempfile.mkstemp(prefix=f"{stem}-variant-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, f"-I{CSRC}", "-o", tmp, str(CSRC / f"{stem}.cu")]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _LOGS[stem] = res.stdout
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {stem}.cu {' '.join(flags)}:\n{res.stdout}")
    _LIBS[stem] = _bind(ctypes.CDLL(tmp), stem)
    return _LIBS[stem]


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")


def on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version), False when all lie on one CUDA device; raises for any
    other mix."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, got {devs}")
    return False


def wants_grad(*ts) -> bool:
    """True when autograd will need a backward: grad mode on and some of
    the tensors ``ts`` (None skipped) requiring grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def forbid_grad(name: str, *ts) -> None:
    """Raise for a kernel without a backward when autograd would need one:
    grad mode on and some of the tensors ``ts`` (None skipped) requiring
    grad. Its output would otherwise carry no ``grad_fn`` and the inputs'
    gradients would be missing without an error."""
    if wants_grad(*ts):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward kernel yet, and an input requires "
            "grad; call it under torch.no_grad() or torch.inference_mode(), or on CPU "
            "tensors (the plain version is differentiable)"
        )
