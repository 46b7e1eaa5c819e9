"""The worker-process side of ``repro_torch.dist``: one partition's server host.

A :class:`WorkerHost` lives in its own OS process and owns one
partition's :class:`SamplingServer` replicas — the same primary+replica
group the in-process service builds, seeded identically (primary at
``seed``, replica ``r`` at ``seed + 104729*r``), with its own
``FaultInjector`` built from the same plan.  Fault decisions are a pure
function of ``(plan.seed, site, invocation)`` and every site's counter is
independent, so the worker's fault stream is bit-identical to the one the
in-process service would have produced for the same dispatch sequence.

``handle_dispatch`` mirrors ``SamplingService._dispatch_gather`` exactly:
walk non-quarantined replicas in order, up to ``RetryPolicy.max_attempts``
tries each, re-deriving the dispatch RNG from ``(key, hop, part, chunk)``
per attempt — never from the attempt number or the serving replica — so
retries and failovers redraw the bit-identical sample.  A dispatch that
exhausts every replica answers ``lost=True`` (degraded partial fanout)
instead of dying: worker death is reserved for real crashes.

Every :class:`DispatchResult` carries a crash-consistency ``state``
snapshot (per-replica stats, injector counters, breaker states).  The
pool keeps the latest snapshot per worker; a respawned worker restores it
and replays the in-flight dispatches, continuing the fault/breaker
streams exactly where its predecessor died.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.faults import InjectedFault, RetryPolicy, as_injector
from repro_torch.core.sampling.service import (
    _GATHER_TAG,
    SamplingServer,
    ServerStats,
    _gather_once,
    request_rng,
)
from repro_torch.dist.transport import (
    ChannelClosed,
    DispatchResult,
    HealthRequest,
    HealthResponse,
    ResetStatsAck,
    ResetStatsRequest,
    SampleDispatch,
    ShutdownAck,
    ShutdownRequest,
    StatsRequest,
    StatsResponse,
)

__all__ = ["WorkerHost", "REPLICA_SEED_STRIDE"]

# must match the replica seeding in SamplingService.__init__ — replica r of
# any partition draws from default_rng((seed + STRIDE*r) * 7919 + part_id)
# in both deployments, or cross-mode bit-identity breaks
REPLICA_SEED_STRIDE = 104729


class WorkerHost:
    """One partition's sampling servers, served over a transport channel."""

    def __init__(
        self,
        part_index: int,
        partition,
        channel,
        *,
        seed: int = 0,
        cost_model: str = "algd",
        replicas: int = 1,
        fault_plan=None,
        retry_policy: RetryPolicy | None = None,
        restore: dict | None = None,
    ):
        self.part_index = int(part_index)
        self.channel = channel
        self.seed = int(seed)
        self.faults = as_injector(fault_plan)
        self.retry_policy = (
            retry_policy if retry_policy is not None else RetryPolicy()
        )
        self.retry_policy.validate()
        self.group = [
            SamplingServer(
                partition,
                seed=self.seed,
                cost_model=cost_model,
                faults=self.faults,
            )
        ]
        for r in range(1, int(replicas)):
            self.group.append(
                SamplingServer(
                    partition,
                    seed=self.seed + REPLICA_SEED_STRIDE * r,
                    cost_model=cost_model,
                    replica_id=r,
                    faults=self.faults,
                )
            )
        if restore:
            self._restore(restore)

    # -- crash-consistency snapshots ------------------------------------
    def snapshot(self) -> dict:
        """Everything a respawned successor needs to continue this
        worker's deterministic streams: per-replica stats, fault-injector
        counters, and breaker states (order matches ``self.group``)."""
        snap: dict = {
            "replicas": {
                srv.site: dataclasses.asdict(srv.stats) for srv in self.group
            },
            "breakers": [
                {
                    "consecutive_failures": srv.breaker.consecutive_failures,
                    "opens": srv.breaker.opens,
                    "cooldown_left": srv.breaker._cooldown_left,
                    "half_open": srv.breaker._half_open,
                }
                for srv in self.group
            ],
        }
        if self.faults is not None:
            snap["injector"] = {
                "invocations": dict(self.faults.invocations),
                "failures": dict(self.faults.failures),
                "burst": dict(self.faults._burst_left),
            }
        return snap

    def _restore(self, snap: dict) -> None:
        for srv in self.group:
            d = snap.get("replicas", {}).get(srv.site)
            if d is not None:
                srv.stats = ServerStats(**d)
        for srv, b in zip(self.group, snap.get("breakers", [])):
            srv.breaker.consecutive_failures = int(b["consecutive_failures"])
            srv.breaker.opens = int(b["opens"])
            srv.breaker._cooldown_left = int(b["cooldown_left"])
            srv.breaker._half_open = bool(b["half_open"])
        inj = snap.get("injector")
        if inj is not None and self.faults is not None:
            self.faults.invocations = {
                str(k): int(v) for k, v in inj["invocations"].items()
            }
            self.faults.failures = {
                str(k): int(v) for k, v in inj["failures"].items()
            }
            self.faults._burst_left = {
                str(k): int(v) for k, v in inj["burst"].items()
            }

    # -- dispatch -------------------------------------------------------
    def handle_dispatch(self, msg: SampleDispatch) -> DispatchResult:
        """Mirror of ``SamplingService._dispatch_gather`` for one chunk."""
        t0 = time.perf_counter()
        policy = self.retry_policy
        retries0 = sum(srv.stats.retries for srv in self.group)
        chunk = np.asarray(msg.seeds, dtype=np.int64)
        for r, srv in enumerate(self.group):
            if not srv.breaker.allow():
                continue
            for attempt in range(1, policy.max_attempts + 1):
                # re-derived per attempt, keyed only by the dispatch
                # coordinates — retry/failover redraws bit-identically
                rng = request_rng(
                    self.seed,
                    tuple(msg.key),
                    msg.hop,
                    msg.part,
                    msg.chunk,
                    _GATHER_TAG,
                )
                try:
                    res = _gather_once(
                        srv,
                        chunk,
                        msg.fanout,
                        msg.direction,
                        weighted=msg.weighted,
                        replace=msg.replace,
                        rng=rng,
                    )
                except InjectedFault:
                    srv.breaker.record_failure()
                    if (
                        attempt < policy.max_attempts
                        and srv.breaker.state != "open"
                    ):
                        srv.stats.retries += 1
                        policy.sleep(attempt)
                        continue
                    break  # replica exhausted or quarantined: fail over
                srv.breaker.record_success()
                if r > 0:
                    srv.stats.failovers += 1
                if msg.weighted:
                    s, n, sc, e = res
                else:
                    (s, n, e), sc = res, None
                return DispatchResult(
                    part=msg.part,
                    chunk=msg.chunk,
                    src=s,
                    dst=n,
                    eid=e,
                    scores=sc,
                    retries=sum(v.stats.retries for v in self.group) - retries0,
                    failovers=r,
                    wall_ms=(time.perf_counter() - t0) * 1e3,
                    state=self.snapshot(),
                )
        # every replica exhausted: degraded partial fanout.  The CLIENT
        # counts this against degraded_dispatches — counting here too
        # would double-book it in merged stats.
        return DispatchResult(
            part=msg.part,
            chunk=msg.chunk,
            lost=True,
            retries=sum(v.stats.retries for v in self.group) - retries0,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            state=self.snapshot(),
        )

    # -- control --------------------------------------------------------
    def server_stats(self) -> dict:
        return {srv.site: dataclasses.asdict(srv.stats) for srv in self.group}

    def server_health(self) -> dict:
        return {srv.site: srv.health for srv in self.group}

    def reset_stats(self) -> None:
        for srv in self.group:
            srv.stats = ServerStats()

    # -- serve loop -----------------------------------------------------
    def serve_forever(self) -> None:
        """Answer frames until shutdown or the peer disappears."""
        while True:
            try:
                msg = self.channel.recv()
            except ChannelClosed:
                return  # parent is gone; nothing left to answer
            if isinstance(msg, SampleDispatch):
                reply = self.handle_dispatch(msg)
            elif isinstance(msg, StatsRequest):
                reply = StatsResponse(
                    part=self.part_index, replicas=self.server_stats()
                )
            elif isinstance(msg, HealthRequest):
                reply = HealthResponse(
                    part=self.part_index, health=self.server_health()
                )
            elif isinstance(msg, ResetStatsRequest):
                self.reset_stats()
                reply = ResetStatsAck(part=self.part_index)
            elif isinstance(msg, ShutdownRequest):
                try:
                    self.channel.send(ShutdownAck(part=self.part_index))
                except ChannelClosed:
                    pass
                return
            else:
                # unknown control frame: a protocol drift we refuse to
                # paper over — die loudly, the pool will notice
                raise RuntimeError(f"worker got unexpected frame {msg!r}")
            try:
                self.channel.send(reply)
            except ChannelClosed:
                return


def _worker_main(part_index: int, partition, channel, options: dict) -> None:
    """Process entry point (fork target) for one partition worker."""
    try:
        WorkerHost(part_index, partition, channel, **options).serve_forever()
    finally:
        channel.close()
