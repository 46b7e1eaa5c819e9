"""``producer_concurrency.train``: the producers' busy seconds over the
time at least one was busy, on hand-built ``pipeline.produce`` roots from
one producer and from three that overlap."""
from __future__ import annotations

import pytest

from glisp_bench.harness.core import read_metric

tracing = pytest.importorskip("repro_torch.tracing")

MS = 1_000_000


def _root(pid, start_ms, dur_ms, put_ms):
    """A root of ``dur_ms`` from ``start_ms``, its last ``put_ms`` waiting
    on the queue."""
    self_ns = {"pipeline.produce": 0, "sampling.wait": (dur_ms - put_ms) * MS,
               "pipeline.put": put_ms * MS}
    return tracing.Root("pipeline.produce", pid, start_ms * MS, dur_ms * MS, self_ns,
                        {n: 1 for n in self_ns}, [])


def _read(monkeypatch, kept, kind="train"):
    monkeypatch.setattr(tracing, "roots", lambda name: kept if name == "pipeline.produce" else [])
    return read_metric("producer_concurrency.train", {"kind": kind})


def test_one_producer_reads_one_whatever_it_waits(monkeypatch):
    # ten batches of 100 ms, 10 ms of each waiting on the queue, then one
    # that waits 30 s (a compile in the consumer)
    kept = [_root(7, 100 * i, 100, 10) for i in range(10)] + [_root(7, 1000, 30_100, 30_000)]
    assert _read(monkeypatch, kept) == pytest.approx(1.0)


def test_three_overlapping_producers_read_how_many_work_at_once(monkeypatch):
    # three producers, 120 ms a batch of which the last 0 / 60 / 90 ms wait
    # on the queue, started together: busy 120 + 60 + 30 ms of every 120
    kept = [_root(pid, 120 * i, 120, put) for i in range(10)
            for pid, put in ((11, 0), (12, 60), (13, 90))]
    assert _read(monkeypatch, kept) == pytest.approx(210 / 120)
    # the same, each producer 40 ms after the last: busy 3,420 ms, and some
    # producer busy all through 0 .. 1,230 ms
    kept = [_root(pid, 40 * j + 120 * i, 120, 6 * j)
            for i in range(10) for j, pid in enumerate((11, 12, 13))]
    assert _read(monkeypatch, kept) == pytest.approx(3420 / 1268)


def test_nothing_to_read(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, [_root(7, 0, 100, 100)]) is None  # no busy time
    assert _read(monkeypatch, [_root(7, 0, 100, 0)], kind="infer") is None
