"""Host spans the benchmark opens around its calls into the program.

``Spans`` sums host seconds by name. In a traced run each span is also a
``torch.profiler.record_function`` range named ``span:<name>``, so that the
trace can say what the host was doing while the device sat idle.

``host_timers`` is a copy of ``host_timers`` in ``chip_smoke.py`` at commit
2c9ddc5f1ad4cf75904747720f1e0edd62342e0b: it patches the engine's storage,
sampling and slice calls with host clocks, here feeding a ``Spans``. It
times layers from outside the program; spans inside the program are a
later change.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from unittest import mock

__all__ = ["Spans", "host_timers"]


class Spans:
    """Host seconds by span name."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.seconds: dict = {}

    @contextmanager
    def span(self, name: str):
        ctx = nullcontext()
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function(f"span:{name}")
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


# (owner class path, attribute, span name): the engine's stages
HOST_STAGES = (
    ("repro_torch.core.sampling.service", "SampleTicket", "result", "sampling_wait"),
    ("repro_torch.core.storage", "HybridCache", "fill", "cache_fill"),
    ("repro_torch.core.storage", "HybridCache", "read_rows", "cache_read"),
    ("repro_torch.core.storage", "DFSTier", "write_rows", "store_write"),
    ("repro_torch.core.inference.engine", "LayerwiseInferenceEngine", "_run_slice",
     "device_slice"),
)


@contextmanager
def host_timers(spans: Spans):
    """Host seconds spent in the engine's stages, by stage, into ``spans``:
    sampling waits, cache fills and reads, store writes, and the padded
    device slice (copies in and out included)."""
    import importlib

    patches = []
    for module, owner_name, attr, label in HOST_STAGES:
        owner = getattr(importlib.import_module(module), owner_name)

        def timed(*args, _orig=getattr(owner, attr), _label=label, **kw):
            with spans.span(_label):
                return _orig(*args, **kw)

        patches.append(mock.patch.object(owner, attr, timed))
    for pt in patches:
        pt.start()
    try:
        yield spans
    finally:
        for pt in patches:
            pt.stop()
