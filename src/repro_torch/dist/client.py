"""The client side of ``repro_torch.dist``: a pool of partition worker processes.

:class:`WorkerPool` forks one process per partition (each hosting that
partition's :class:`~repro_torch.dist.worker.WorkerHost`), connected by a
:func:`~repro_torch.dist.transport.channel_pair` — multiprocessing pipes
(``transport="mp"``) or a socketpair (``transport="socket"``).  It
implements the ``SamplingService`` remote-dispatch contract as two named
phases:

``dispatch(p, ci, chunk, key, hop, spec) -> handle``
    serialize one chunk's :class:`SampleDispatch` to partition ``p``'s
    worker and return immediately — all partitions' chunks go out before
    any answer is read, so workers genuinely overlap;

``collect(handle) -> (None, raw_gather) | None``
    block for that dispatch's :class:`DispatchResult` (FIFO per worker),
    returning exactly what an in-process ``_dispatch_gather`` would have:
    the raw gather tuple, or ``None`` for a lost (degraded) dispatch.

Failure semantics: a worker that dies mid-request is respawned (within
the ``respawns`` budget, mirroring ``BatchPipeline``), restored from its
last crash-consistency snapshot, and the in-flight dispatches are resent
in order — the keyed RNG and per-site fault counters make the replay
bit-identical, so a crash is invisible in the sample stream.  A worker
that exhausts the budget is marked permanently down and its dispatches
answer ``None`` (degraded), exactly like an exhausted replica group.

``close(timeout=)`` escalates shutdown-frame → join → terminate → kill,
the same ladder as ``BatchPipeline.close``.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
import warnings
from collections import deque

import numpy as np

from repro_torch.core.faults import RetryPolicy
from repro_torch.dist.transport import (
    ChannelClosed,
    DispatchResult,
    HealthRequest,
    HealthResponse,
    ProtocolError,
    ResetStatsAck,
    ResetStatsRequest,
    SampleDispatch,
    ShutdownRequest,
    StatsRequest,
    StatsResponse,
    channel_pair,
)
from repro_torch.dist.worker import _worker_main

__all__ = ["WorkerPool"]

_FORK_AVAILABLE = os.name == "posix" and "fork" in mp.get_all_start_methods()

_CONTROL_TIMEOUT_S = 10.0


class _Worker:
    __slots__ = ("index", "proc", "channel", "inflight", "state", "up", "seq")

    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.channel = None
        # FIFO of (handle, SampleDispatch, t0) awaiting answers; kept until
        # collected so a respawned worker can replay them in order
        self.inflight: deque = deque()
        self.state: dict = {}  # latest crash-consistency snapshot
        self.up = False
        self.seq = 0


class WorkerPool:
    """One forked sampling-server process per partition."""

    def __init__(
        self,
        partitions,
        *,
        transport: str = "mp",
        seed: int = 0,
        cost_model: str = "algd",
        replicas: int = 1,
        fault_plan=None,
        retry_policy: RetryPolicy | None = None,
        respawns: int = 1,
        dispatch_timeout: float = 60.0,
    ):
        if transport not in ("mp", "socket"):
            raise ValueError(
                f"transport must be 'mp' or 'socket', got {transport!r}"
            )
        if not _FORK_AVAILABLE:
            raise RuntimeError(
                "WorkerPool needs POSIX fork (workers inherit the graph "
                "partitions by address); use dist_transport='inproc' here"
            )
        self.transport = transport
        self.partitions = list(partitions)
        self.dispatch_timeout = float(dispatch_timeout)
        self.respawns_left = int(respawns)
        self.respawn_count = 0
        self.latencies: list[float] = []  # client-observed dispatch ms
        self._options = dict(
            seed=int(seed),
            cost_model=cost_model,
            replicas=int(replicas),
            fault_plan=fault_plan,
            retry_policy=retry_policy,
        )
        self._closed = False
        self._workers = [_Worker(p) for p in range(len(self.partitions))]
        for w in self._workers:
            self._spawn(w)

    # -- process lifecycle ----------------------------------------------
    def _spawn(self, w: _Worker, restore: dict | None = None) -> None:
        parent_ch, child_ch = channel_pair(self.transport)
        ctx = mp.get_context("fork")
        opts = dict(self._options, restore=restore)
        with warnings.catch_warnings():
            # forking a process that has initialised CUDA (and so runs the
            # driver's threads) draws fork-safety warnings; the child runs
            # numpy sampling only and never touches torch.cuda, the pattern
            # the fork-safety rules allow, so the warnings are noise here
            warnings.simplefilter("ignore", RuntimeWarning)
            warnings.simplefilter("ignore", DeprecationWarning)
            proc = ctx.Process(
                target=_worker_main,
                args=(w.index, self.partitions[w.index], child_ch, opts),
                daemon=True,
            )
            proc.start()
        # the child's channel end must not stay open in the parent, or a
        # dead child never surfaces as EOF on our recv
        child_ch.close()
        w.proc, w.channel, w.up = proc, parent_ch, True

    def _mark_down(self, w: _Worker) -> None:
        w.up = False
        if w.channel is not None:
            w.channel.close()
        if w.proc is not None:
            w.proc.join(timeout=2.0)

    def _try_respawn(self, w: _Worker) -> bool:
        """Respawn a dead worker from its last snapshot and replay its
        in-flight dispatches in order; False once the budget is spent."""
        if self.respawns_left <= 0:
            return False
        self.respawns_left -= 1
        self.respawn_count += 1
        self._spawn(w, restore=w.state or None)
        try:
            for _, msg, _ in w.inflight:
                w.channel.send(msg)
        except ChannelClosed:
            self._mark_down(w)  # died during replay; loop may retry
        return True

    # -- the execute_hop dispatch contract ------------------------------
    def dispatch(self, p: int, ci: int, chunk, key, hop: int, spec):
        """Send one chunk's gather to partition ``p``; returns a handle
        for :meth:`collect`.  Never blocks on the answer."""
        if self._closed:
            raise RuntimeError("WorkerPool is closed")
        w = self._workers[p]
        msg = SampleDispatch(
            key=tuple(int(k) for k in key),
            hop=int(hop),
            part=int(p),
            chunk=int(ci),
            seeds=np.asarray(chunk, dtype=np.int64),
            fanout=int(spec.fanouts[hop]),
            direction=spec.direction,
            weighted=bool(spec.weighted),
            replace=bool(spec.replace),
        )
        handle = (p, w.seq)
        w.seq += 1
        w.inflight.append((handle, msg, time.perf_counter()))
        if w.up:
            try:
                w.channel.send(msg)
            except ChannelClosed:
                self._mark_down(w)  # collect() will respawn and replay
        return handle

    def collect(self, handle):
        """Block for ``handle``'s answer.  Returns ``(None, raw_gather)``
        — the in-process ``_dispatch_gather`` contract, with no serving
        server to name — or ``None`` for a lost/degraded dispatch."""
        p, _ = handle
        w = self._workers[p]
        if not w.inflight or w.inflight[0][0] != handle:
            raise ProtocolError(
                f"out-of-order collect: {handle} is not worker {p}'s "
                "oldest outstanding dispatch"
            )
        deadline = time.perf_counter() + self.dispatch_timeout
        while True:
            if not w.up:
                if not self._try_respawn(w):
                    # budget spent: permanently down, dispatch is lost
                    w.inflight.popleft()
                    return None
                continue
            try:
                if not w.channel.poll(0.05):
                    if not w.proc.is_alive():
                        self._mark_down(w)
                    elif time.perf_counter() > deadline:
                        raise TimeoutError(
                            f"worker {p} gave no answer within "
                            f"{self.dispatch_timeout}s"
                        )
                    continue
                res = w.channel.recv()
            except ChannelClosed:
                self._mark_down(w)
                continue
            _, msg, t0 = w.inflight.popleft()
            if (
                not isinstance(res, DispatchResult)
                or res.part != msg.part
                or res.chunk != msg.chunk
            ):
                raise ProtocolError(
                    f"worker {p} answered {res!r} to dispatch "
                    f"(part={msg.part}, chunk={msg.chunk})"
                )
            self.latencies.append((time.perf_counter() - t0) * 1e3)
            w.state = res.state
            if res.lost:
                return None
            if msg.weighted:
                return None, (res.src, res.dst, res.scores, res.eid)
            return None, (res.src, res.dst, res.eid)

    def drain_latencies(self) -> list[float]:
        out, self.latencies = self.latencies, []
        return out

    # -- control plane --------------------------------------------------
    def _control(self, request_msg, response_cls):
        """One control round-trip per live worker; ``None`` for dead ones.
        Only valid when no dispatches are outstanding (control frames
        share the channel with data)."""
        if any(w.inflight for w in self._workers):
            raise RuntimeError(
                "control requests require no outstanding dispatches"
            )
        replies: list = []
        for w in self._workers:
            if not w.up:
                replies.append(None)
                continue
            try:
                w.channel.send(request_msg)
                deadline = time.perf_counter() + _CONTROL_TIMEOUT_S
                while not w.channel.poll(0.05):
                    if (
                        not w.proc.is_alive()
                        or time.perf_counter() > deadline
                    ):
                        raise ChannelClosed(f"worker {w.index} unresponsive")
                res = w.channel.recv()
            except ChannelClosed:
                self._mark_down(w)
                replies.append(None)
                continue
            if not isinstance(res, response_cls):
                raise ProtocolError(
                    f"worker {w.index} answered {res!r} to "
                    f"{type(request_msg).__name__}"
                )
            replies.append(res)
        return replies

    def server_stats(self) -> dict:
        """``{site: ServerStats-field-dict}`` across every worker; dead
        workers contribute their last snapshot (their counters stopped
        when they died, which is exactly what the snapshot holds)."""
        merged: dict = {}
        for w, resp in zip(
            self._workers, self._control(StatsRequest(), StatsResponse)
        ):
            replicas = (
                resp.replicas if resp is not None
                else w.state.get("replicas", {})
            )
            merged.update(replicas)
        return merged

    def health(self) -> dict:
        """Per-site breaker health plus a ``worker.<p>`` liveness row per
        worker process."""
        out: dict = {}
        for w, resp in zip(
            self._workers, self._control(HealthRequest(), HealthResponse)
        ):
            out[f"worker.{w.index}"] = "up" if w.up else "down"
            if resp is not None:
                out.update(resp.health)
            else:
                for site in w.state.get("replicas", {}):
                    out[site] = "down"
        return out

    def workloads(self) -> np.ndarray:
        """Measured-at-the-worker modeled work per partition (summed over
        that partition's replicas) — same shape as the in-process
        ``server_workloads``."""
        sums = np.zeros(len(self.partitions))
        for site, stats in self.server_stats().items():
            part = int(site.split(".")[1])
            sums[part] += float(stats.get("work_units", 0.0))
        return sums

    def snapshot_workloads(self) -> list:
        """Per-partition work_units from the snapshots riding on already
        collected results — no control round-trip, so the service can
        difference it around a scheduling round (the per-round work
        accounting) without draining the dispatch window."""
        out = []
        for w in self._workers:
            out.append(
                sum(
                    float(s.get("work_units", 0.0))
                    for s in w.state.get("replicas", {}).values()
                )
            )
        return out

    def reset_stats(self) -> None:
        for w, resp in zip(
            self._workers, self._control(ResetStatsRequest(), ResetStatsAck)
        ):
            if resp is None and w.state.get("replicas"):
                # a dead worker cannot zero itself; zero its snapshot
                w.state = dict(w.state, replicas={})
        self.latencies = []

    # -- shutdown -------------------------------------------------------
    def close(self, timeout: float = 2.0) -> None:
        """Stop every worker: shutdown frame, then join/terminate/kill
        with bounded waits at each rung (BatchPipeline's ladder)."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.up:
                try:
                    w.channel.send(ShutdownRequest())
                except ChannelClosed:
                    pass
        for w in self._workers:
            proc = w.proc
            if proc is None:
                continue
            proc.join(timeout=timeout)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=timeout)
            if proc.is_alive():
                proc.kill()
                # glint: disable=PRJ006 -- SIGKILL is uncatchable; this
                # join only reaps the already-dead child's zombie entry
                proc.join()
            if w.channel is not None:
                w.channel.close()
            w.up = False

    def __del__(self):
        try:
            self.close(timeout=0.5)
        except Exception:
            pass
