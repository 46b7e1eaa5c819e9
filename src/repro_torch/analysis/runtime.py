"""Runtime companion to the static pass: the tuner-sweep guard. Port of
``repro/analysis/runtime.py``.

The reference's guard bounds jit retraces: one compile per (layer, vertex
bucket, edge bucket). Eager PyTorch traces nothing; in the port the cost
paid per new shape is the kernel autotuner's sweep. An engine with
``kernel_autotune`` tunes each new (layer, bucket) before its first slice
(``core.inference.engine``, ``autotune_for_slice``), and the tuner answers a
key it has met from its table or artifact. So the guard holds the tuner to
one sweep per (op, bucket, dtype) key over any block of inference calls.
A "compile" here is a sweep measured (``autotune.stats()['measured']``,
counted by the engine as ``sweep_count()``), and a new shape is a tuned
key the engine meets for the first time (``tuned_key_count()``):

    with recompile_guard(system) as rec:
        system.infer_layerwise(layer_fns, workdir, kernel_autotune=True)
        system.infer_layerwise(layer_fns, workdir, kernel_autotune=True)
    assert rec.compiles <= rec.new_shapes   # the repeat: 0 sweeps, 0 keys

Accepts a :class:`LayerwiseInferenceEngine` or a :class:`GLISPSystem`
(whose ``infer_engine`` may not exist until the first call inside the
guard). An untuned engine sweeps nothing and meets no key.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

__all__ = ["RecompileError", "RecompileReport", "recompile_guard"]


class RecompileError(AssertionError):
    """The engine's tuner swept more keys than it met new ones."""


@dataclass
class RecompileReport:
    """Filled in when the guarded block exits cleanly."""

    compiles: int = 0  # tuner sweeps measured in the guarded region
    new_shapes: int = 0  # new distinct (op, bucket, dtype) keys in region
    bound: int = 0  # allowed sweeps: new_shapes + extra


def _engine_of(target):
    """The engine that tunes: the target itself, or a GLISPSystem's cached
    engine (None before the first inference call)."""
    if target is None or hasattr(target, "sweep_count"):
        return target
    return getattr(target, "infer_engine", None)


def _counters(target) -> tuple[int, int]:
    engine = _engine_of(target)
    if engine is None:
        return 0, 0
    return engine.sweep_count(), engine.tuned_key_count()


@contextmanager
def recompile_guard(target, *, extra: int = 0):
    """Assert the one-sweep-per-(op, bucket, dtype) bound over a block.

    ``extra`` widens the bound for intentional sweeps (e.g. the tuner's
    table dropped mid-guard with ``autotune.reset()``). Raises
    :class:`RecompileError` on a clean exit that exceeded the bound; the
    yielded :class:`RecompileReport` carries the counts either way."""
    report = RecompileReport()
    sweeps0, keys0 = _counters(target)
    yield report
    sweeps1, keys1 = _counters(target)
    # an engine swapped mid-guard starts its counters at zero; clamp the
    # baseline so the comparison stays on the live engine's counts
    report.compiles = sweeps1 - min(sweeps0, sweeps1)
    report.new_shapes = keys1 - min(keys0, keys1)
    report.bound = report.new_shapes + extra
    if report.compiles > report.bound:
        raise RecompileError(
            f"the engine's tuner measured {report.compiles} sweep(s) for "
            f"{report.new_shapes} new (op, bucket, dtype) key(s) "
            f"(bound {report.bound}): a key is being swept twice or a shape "
            "is leaking past the bucketer"
        )
