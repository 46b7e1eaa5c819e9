"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). All sources are compiled
together, one ``nvcc`` process each, at the first call of :func:`library`,
into ``build/repro_torch_kernels/`` at the repository root, under a name
keyed by a hash of every source and flag: an edited source rebuilds, an
unchanged one loads the existing file. Nothing is built at import.

Every C entry returns ``cudaGetLastError()`` after its launch; the wrappers
raise on a non-zero code through :func:`check`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library", "check", "ptxas_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c = ctypes.c_int
_p = ctypes.c_void_p
# C signatures of every entry, by library (source stem) and symbol
SIGNATURES = {
    "segment_sum": {
        "segment_offsets": (_p, _c, _c, _p, _p),
        "segment_sum": (_p, _p, _c, _p, _c, _c, _c, _c, _c, _p, _p),
    },
    "gat_softmax_aggregate": {
        "gat_softmax_aggregate": (_p, _p, _p, _c, _p, _c, _c, _c, _c, _c, _c, _p, _p),
    },
}

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
    each source compiled by this process; empty for a library that was
    already built."""
    return dict(_LOGS)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building all
    sources first if needed, with ``argtypes``/``restype`` set."""
    if stem not in _LIBS:
        paths = build_all()
        for name, path in paths.items():
            if name in _LIBS:
                continue
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[stem]


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
