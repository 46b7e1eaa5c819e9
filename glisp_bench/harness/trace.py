"""The device trace of a short steady stretch of a traced run.

``Profile`` wraps ``torch.profiler`` over the stretch (the caller starts and
stops it at step or pass boundaries, the device synchronised at both
ends) and reads from its events:

* ``busy_s``: the union of the device's kernel and copy intervals;
* ``window_s``: the stretch's length by the host clock;
* ``device_ops``: device seconds by operation name, largest first;
* ``idle_gaps``: device idle seconds by the benchmark's host span
  (``span:<name>``, see ``timers.Spans``) open at each gap's midpoint;
* ``kernel_s``: device seconds of the port's GNN kernels, by the kernel
  names of ``src/repro_torch/kernels/csrc``.

A trace of a long process can lose device events, so only a short stretch
is profiled.
"""
from __future__ import annotations

import bisect
import time

__all__ = ["Profile", "GNN_KERNELS"]

# the GNN entry points' kernels (csrc/segment_sum.cu, gat_softmax_aggregate.cu,
# gat_softmax_backward.cu): the segment sums and gathers, their CSR offsets,
# the GAT softmax aggregate and its backward
GNN_KERNELS = ("segment_sum_kernel", "segment_offsets_kernel", "gat_softmax_aggregate_kernel",
               "gat_softmax_backward_kernel")


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Profile:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.read_out: dict | None = None

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """The stretch's numbers (once; later calls return the same)."""
        if self.read_out is not None:
            return self.read_out
        from torch.autograd import DeviceType

        device, spans, ops = [], [], {}
        kernel_s = 0.0
        for evt in self.prof.events():
            a, b = evt.time_range.start, evt.time_range.end
            if evt.name.startswith("span:"):
                if evt.device_type == DeviceType.CPU:
                    spans.append((a, b, evt.name[5:]))
            elif evt.device_type == DeviceType.CUDA:
                if b <= a:
                    continue
                device.append((a, b))
                ops[evt.name] = ops.get(evt.name, 0.0) + (b - a) / 1e6
                if any(k in evt.name for k in GNN_KERNELS):
                    kernel_s += (b - a) / 1e6
        busy = _union(device)
        busy_s = sum(b - a for a, b in busy) / 1e6
        gaps: dict = {}
        spans.sort()
        starts = [s[0] for s in spans]
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            mid = (end + nxt) / 2
            name = "no span"
            # the innermost span open at the gap's midpoint
            i = bisect.bisect_right(starts, mid)
            best = None
            for a, b, n in spans[max(0, i - 64):i]:
                if a <= mid <= b and (best is None or a >= best[0]):
                    best = (a, b, n)
            if best is not None:
                name = best[2]
            gaps[name] = gaps.get(name, 0.0) + (nxt - end) / 1e6
        self.read_out = {
            "busy_s": busy_s,
            "window_s": self.t1 - self.t0,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
            "kernel_s": kernel_s,
        }
        self.prof = None
        return self.read_out
