"""Faults planted in the program underneath a run, to show that the
comparison catches them (``readings.py --fault``, ``tests/``). The
benchmark's own runs plant none.

* ``frozen_step``: the training step returns its state unchanged (AdamW
  writes nothing);
* ``half_batch``: the loss is the mean over half of the batch's seeds;
* ``altered_sample``: one sampled neighbour of the training batches is
  replaced by another vertex where the sample is made;
* ``thin_sample``: the sampling service keeps every other sampled edge of
  each hop before it expands the next (a sampler that takes half the
  neighbours);
* ``half_rows``: each layer slice leaves half of its rows at zero;
* ``altered_answer``: one value of every final-layer row block the engine
  writes, or of every served request's embeddings, is changed where it is
  produced.

The exchange between chips is not a fault these cells can have: every
cell runs on one card.
"""
from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

__all__ = ["FAULTS", "plant"]

FAULTS = ("frozen_step", "half_batch", "altered_sample", "thin_sample", "half_rows",
          "altered_answer")


@contextmanager
def plant(name: str | None):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    if name == "frozen_step":
        from repro_torch.train import loop

        def adamw_update(params, grads, state, cfg):
            return params, state, {}

        with mock.patch.object(loop, "adamw_update", adamw_update):
            yield
    elif name == "half_batch":
        import torch

        from repro_torch.models.gnn.models import GNNModel

        def loss(model, batch):
            logits = model.apply(batch)
            half = logits.shape[0] // 2
            tgt = logits.gather(1, batch.labels.long()[:, None])[:, 0]
            return (torch.logsumexp(logits, dim=-1) - tgt)[:half].mean()

        with mock.patch.object(GNNModel, "loss", loss):
            yield
    elif name == "altered_sample":
        from repro_torch.api import pipeline

        orig = pipeline.subgraph_to_batch

        def subgraph_to_batch(sub, *args, **kw):
            if sub.hops and sub.hops[0].dst.shape[0]:
                hop = sub.hops[0]
                hop.dst = hop.dst.copy()
                hop.dst[0] = (hop.dst[0] + 1) % (int(hop.dst.max()) + 2)
            return orig(sub, *args, **kw)

        with mock.patch.object(pipeline, "subgraph_to_batch", subgraph_to_batch):
            yield
    elif name == "thin_sample":
        from repro_torch.core.sampling import service

        orig = service.execute_hop

        def execute_hop(*args, **kw):
            src, dst, eid, lost = orig(*args, **kw)
            return src[::2], dst[::2], eid[::2], lost

        with mock.patch.object(service, "execute_hop", execute_hop):
            yield
    elif name == "half_rows":
        from repro_torch.core.inference.engine import LayerwiseInferenceEngine

        orig = LayerwiseInferenceEngine._run_slice

        def run_slice(engine, *args, **kw):
            out = orig(engine, *args, **kw).copy()
            out[out.shape[0] // 2:] = 0.0
            return out

        with mock.patch.object(LayerwiseInferenceEngine, "_run_slice", run_slice):
            yield
    else:  # altered_answer
        from repro_torch.core.storage import DFSTier
        from repro_torch.serve.server import GNNServer

        write_rows = DFSTier.write_rows
        compute = GNNServer._compute

        def altered_write(store, rows, values):
            values = values.copy()
            values[0, 0] += 1.0
            return write_rows(store, rows, values)

        def altered_compute(server, live):
            outs = [o.copy() for o in compute(server, live)]
            outs[0][0, 0] += 1.0
            return outs

        with mock.patch.object(DFSTier, "write_rows", altered_write), \
                mock.patch.object(GNNServer, "_compute", altered_compute):
            yield
