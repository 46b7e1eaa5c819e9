"""Host spans of the port's layers, on one clock.

A span is a named interval on ``time.perf_counter_ns()`` (CLOCK_MONOTONIC
on Linux, the same clock in a process and in its forked children). Spans
nest through a per-thread stack; a span opened with no open parent in its
thread (or with ``root=True``) is a *root*. When a root closes, its subtree
is folded into a :class:`Root` summary: the root's start and duration,
each span name's self time (its duration less what its children cover) and
count, and the children's intervals (capped at ``MAX_INTERVALS``). The
summaries are kept in memory, the last ``KEEP`` per root name, and read
with :func:`roots`.

The bookkeeping is always on: a clock read and a few dictionary updates a
span. It never touches the device (no synchronise, no ``.item()``), and
importing this module imports nothing beyond the standard library, so the
numpy-only sampling path and its forked workers stay free of torch.

While a ``torch.profiler`` is recording, each span also opens a
``record_function("span:<name>")`` range, which puts the program's spans
into the profiler's trace on the profiler's own clock. A forked batch
producer opens no profiler range (:func:`forked`); its root summaries ride
to the consumer with the batches (:func:`take`, :func:`absorb`), and
:func:`profiler_us` maps their times onto the profiler's clock.

    from repro_torch import tracing

    with tracing.span("engine.pass"):
        with tracing.span("engine.layer"):
            ...
    tracing.roots("engine.pass")[-1].self_ns["engine.layer"]
"""
from __future__ import annotations

import collections
import os
import sys
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "KEEP",
    "MAX_INTERVALS",
    "Root",
    "Span",
    "absorb",
    "forked",
    "profiler_us",
    "reset",
    "roots",
    "span",
    "take",
]

KEEP = 1024  # root summaries kept per root name
MAX_INTERVALS = 512  # child intervals kept per root (a pass has thousands)

_now = time.perf_counter_ns
# one anchor pair: the profiler stamps its events on the wall clock
# (CLOCK_REALTIME), the spans on the monotonic one
# glint: disable=DET003 -- maps span times onto the profiler's clock; seeds nothing
_ANCHOR_NS, _ANCHOR_WALL_NS = time.perf_counter_ns(), time.time_ns()


def profiler_us(ns: int) -> float:
    """A span time (``perf_counter_ns``) on the profiler's clock, in
    microseconds since the epoch: add the profiler's ``trace_start_ns``
    offset to compare it with an event's ``time_range``."""
    return (_ANCHOR_WALL_NS + ns - _ANCHOR_NS) / 1e3


@dataclass
class Root:
    """One closed root span and its subtree, folded."""

    name: str
    pid: int  # the process that ran it
    start_ns: int
    dur_ns: int
    self_ns: dict = field(default_factory=dict)  # span name -> self time, the root's own too
    count: dict = field(default_factory=dict)  # span name -> spans closed
    intervals: list = field(default_factory=list)  # (name, start_ns, end_ns) of children


class _Tracer:
    """The process's spans: per-thread stacks, the kept root summaries, and
    the outbox of a forked producer."""

    def __init__(self):
        self.local = threading.local()
        self.kept: dict = {}  # root name -> deque of Root
        self.lock = threading.Lock()
        self.outbox: list | None = None  # set in a forked producer
        self.ranges = True  # profiler ranges allowed in this process
        self.pid = os.getpid()

    def record(self, root: Root) -> None:
        with self.lock:
            kept = self.kept.get(root.name)
            if kept is None:
                kept = self.kept[root.name] = collections.deque(maxlen=KEEP)
            kept.append(root)
            if self.outbox is not None:
                self.outbox.append(root)


_TRACER = _Tracer()


def _profiling() -> bool:
    """Whether a torch profiler is recording in this process: its own flag,
    read without importing torch (no profiler runs before torch is loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class Span:
    """``with span(name) as s:`` — after the block, ``s.seconds`` is its
    duration and, for a root, ``s.summary`` its :class:`Root`."""

    __slots__ = ("name", "detach", "start", "end", "child_ns", "top", "saved", "range",
                 "summary", "dropped", "self_ns", "count", "intervals")

    def __init__(self, name: str, root: bool = False):
        self.name = name
        self.detach = root
        self.range = None
        self.summary = None
        self.dropped = False

    def __enter__(self) -> "Span":
        tracer = _TRACER
        try:
            stack = tracer.local.stack
        except AttributeError:
            stack = tracer.local.stack = []
        self.saved = None
        if self.detach and stack:
            # a root inside another span of this thread: a fresh stack
            self.saved = stack
            stack = tracer.local.stack = []
        if stack:
            self.top = stack[0]
        else:
            self.top = self
            self.self_ns, self.count, self.intervals = {}, {}, []
        if tracer.ranges and _profiling():
            from torch.autograd.profiler import record_function

            self.range = record_function("span:" + self.name)
            self.range.__enter__()
        stack.append(self)
        self.child_ns = 0
        self.start = _now()
        return self

    def __exit__(self, *exc) -> None:
        self.end = end = _now()
        tracer = _TRACER
        stack = tracer.local.stack
        stack.pop()
        dur = end - self.start
        top, name = self.top, self.name
        top.self_ns[name] = top.self_ns.get(name, 0) + dur - self.child_ns
        top.count[name] = top.count.get(name, 0) + 1
        if stack:
            stack[-1].child_ns += dur
            if len(top.intervals) < MAX_INTERVALS:
                top.intervals.append((name, self.start, end))
        else:
            if self.saved is not None:
                tracer.local.stack = self.saved
            if not self.dropped:
                self.summary = Root(name, tracer.pid, self.start, dur, self.self_ns,
                                    self.count, self.intervals)
                tracer.record(self.summary)
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def drop(self) -> None:
        """Keep no summary of this root (a span that found no work)."""
        self.dropped = True


def span(name: str, root: bool = False) -> Span:
    """A span named ``name``; ``root=True`` makes it a root even inside
    another span of its thread (its parent then counts it as its own time)."""
    return Span(name, root)


def roots(name: str) -> list:
    """The kept summaries of the roots named ``name``, oldest first: this
    process's and those it absorbed."""
    with _TRACER.lock:
        return list(_TRACER.kept.get(name, ()))


def absorb(summaries) -> None:
    """Keep another process's root summaries (each carries its ``pid``)."""
    for root in summaries:
        _TRACER.record(root)


def take() -> list:
    """The root summaries closed in this process since the last call, in a
    forked producer (:func:`forked`); elsewhere an empty list."""
    with _TRACER.lock:
        if _TRACER.outbox is None:
            return []
        out, _TRACER.outbox = _TRACER.outbox, []
        return out


def forked() -> None:
    """Set up a forked producer: drop what the parent had kept, keep each
    new root summary for :func:`take`, and open no profiler range here,
    even if the fork happened while a profiler was recording."""
    global _TRACER
    _TRACER = _Tracer()
    _TRACER.outbox = []
    _TRACER.ranges = False


def reset() -> None:
    """Drop every kept root summary of this process."""
    with _TRACER.lock:
        _TRACER.kept.clear()
