"""The benchmark's wrappers around the port's GNN kernel entry points.

While a ``KernelCalls`` is on, every call of the entry points the models
and the autograd Functions reach (``repro_torch.models.gnn.models``'s
imports of ``repro_torch.kernels.ops`` and the two backwards in
``repro_torch.kernels.fused_gnn``) is kept with its tensors. After the
traced stretch, :meth:`bound_s` turns each call's shape into its least
time on the card by the frozen op counts of ``yardstick``: the valid edges
and the distinct rows read are counted then, so the wrappers add no host
sync to the stretch.
"""
from __future__ import annotations

from contextlib import ExitStack
from unittest import mock

from glisp_bench.harness import yardstick

__all__ = ["KernelCalls"]


class KernelCalls:
    def __init__(self):
        self.calls: list = []  # (op, dict of ints and tensors)
        self.on = False
        self._stack: ExitStack | None = None

    def __enter__(self) -> "KernelCalls":
        from repro_torch.kernels import fused_gnn
        from repro_torch.models.gnn import models

        def keep(op, fn, shape_of):
            def wrapped(*args, **kw):
                if self.on:
                    self.calls.append((op, shape_of(*args, **kw)))
                return fn(*args, **kw)
            return wrapped

        targets = [
            (models, "gnn_gather_aggregate", "gather_spmm_ragged",
             lambda feats, idx, seg, n, order=None: dict(
                 edges=idx.shape[0], segments=n, dim=feats.shape[1], _valid=(idx, seg),
                 _rows=idx)),
            (models, "gnn_aggregate_and_count", "segment_spmm_ragged",
             lambda msg, seg, n: dict(edges=seg.shape[0], segments=n, dim=msg.shape[1] + 1,
                                      _valid=(seg,))),
            (models, "gnn_gat_aggregate", "gat_softmax_aggregate",
             lambda logits, msg, seg, n: dict(edges=seg.shape[0], segments=n, dim=msg.shape[-1],
                                              heads=msg.shape[1] if msg.dim() == 3 else 1,
                                              _valid=(seg,))),
            (fused_gnn, "gather_spmm_ragged_backward", "gather_spmm_ragged_backward",
             lambda grad, idx, seg, n, order=None: dict(
                 edges=idx.shape[0], segments=n, dim=grad.shape[1], _valid=(idx, seg),
                 _rows=seg)),
            (fused_gnn, "gat_softmax_aggregate_backward", "gat_softmax_aggregate_backward",
             lambda grad, logits, msg, seg, index, out, stats: dict(
                 edges=seg.shape[0], segments=out.shape[0], dim=msg.shape[-1],
                 heads=msg.shape[1] if msg.dim() == 3 else 1, _valid=(seg,))),
        ]
        self._stack = ExitStack()
        for owner, attr, op, shape_of in targets:
            self._stack.enter_context(
                mock.patch.object(owner, attr, keep(op, getattr(owner, attr), shape_of)))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()

    def bound_s(self, hw: dict) -> float:
        """The least card time of every kept call, summed. The sum and
        count of ``gnn_aggregate_and_count`` are two launches of the sum
        kernel: D = the messages' width, and D = 1."""
        total = 0.0
        for op, sh in self.calls:
            shape = {k: v for k, v in sh.items() if not k.startswith("_")}
            valid = None
            for t in sh["_valid"]:  # padding is -1
                valid = t >= 0 if valid is None else valid & (t >= 0)
            shape["valid_edges"] = int(valid.sum())
            if "_rows" in sh:
                r = sh["_rows"]
                shape["rows_read"] = int(r[valid].unique().numel())
            if op == "segment_spmm_ragged":
                d = shape["dim"] - 1
                total += yardstick.bound_s(op, dict(shape, dim=d), hw)
                total += yardstick.bound_s(op, dict(shape, dim=1), hw)
            else:
                total += yardstick.bound_s(op, shape, hw)
        return total
