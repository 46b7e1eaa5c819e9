"""What the inference and serving drivers share: the engine's working
directory, one full layerwise pass, and two logs kept from outside the
program (the sampling service's requests, the slices' real rows)."""
from __future__ import annotations

import os
from pathlib import Path
from unittest import mock

import numpy as np

from glisp_bench.harness.core import ROOT

__all__ = ["workdir", "SampleLog", "SliceRows", "one_pass"]


def workdir(cell: str) -> str:
    """The engine's stores: one directory under ``TMPDIR`` (inside the
    checkout when it is unset), named by the cell ``cell``, reused by every pass."""
    base = os.environ.get("TMPDIR")
    root = Path(base) if base else ROOT / "build" / "glisp_bench"
    return str(root / f"glisp_bench-{cell}")


class SampleLog:
    """The sampling service's requests in the order they were submitted,
    while on: (seeds, ticket); their samples are read once answered."""

    def __init__(self, service):
        self.service = service
        self.entries: list = []
        self.on = False
        orig = service.submit

        def submit(seeds, spec=None, *, key=None):
            ticket = orig(seeds, spec, key=key)
            if self.on:
                self.entries.append((np.asarray(seeds), ticket))
            return ticket

        service.submit = submit

    def close(self) -> None:
        del self.service.submit  # the class's method again

    def samples(self, only=None) -> list:
        """(seeds, src, dst) of each answered request (of ``only``'s)."""
        out = []
        for seeds, ticket in (self.entries if only is None else only):
            hop = ticket.result().hops[0]
            out.append((seeds, hop.src, hop.dst))
        return out


class SliceRows:
    """Every layer slice's real rows and edges, as the engine sends them
    to the device (``LayerwiseInferenceEngine._run_slice``)."""

    def __init__(self):
        self.rows: list = []
        self.on = False

    def patch(self):
        from repro_torch.core.inference.engine import LayerwiseInferenceEngine

        orig = LayerwiseInferenceEngine._run_slice

        def run_slice(engine, k, slice_fn, h_self, h_nbr, seg, *rest, **kw):
            if self.on:
                self.rows.append((k, int(h_self.shape[0]), int(seg.shape[0]), int(h_self.shape[1])))
            return orig(engine, k, slice_fn, h_self, h_nbr, seg, *rest, **kw)

        return mock.patch.object(LayerwiseInferenceEngine, "_run_slice", run_slice)


def one_pass(system, fns, cfg, wd, dev, sync):
    res = system.infer_layerwise(fns, wd, out_dims=[cfg["hidden"]] * cfg["num_layers"],
                                 device=dev)
    sync()
    return res
