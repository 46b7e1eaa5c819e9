"""Pluggable components behind the GLISP facade.

Defines the registries named by ``GLISPConfig`` string fields (partitioners,
samplers, reorders, cache policies, storage tiers) and the
``SamplerBackend`` protocol.  Since the request-plan redesign, BOTH sampler
backends are one ``SamplingService`` behind different routing strategies
(``GatherApplyRouting`` for GLISP, ``OwnerRouting`` for the DistDGL-style
baseline) — no parallel client class hierarchies.  The preferred surface is
asynchronous:

    ticket = backend.submit(seeds, spec)        # SampleTicket (future)
    sub = ticket.result()

``backend.sample(seeds, fanouts, ...)`` remains as a submit-and-wait shim
for one release of deprecation; new call sites should build a
``SamplingSpec`` and go through ``submit``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

import numpy as np

from repro_torch.utils import Registry
from repro_torch.core.storage import CACHE_POLICIES, STORAGE_TIERS
from repro_torch.core.partition import (
    PARTITIONERS,
    Partitioner,
    PartitionPipeline,
    PartitionPlan,
)
from repro_torch.core.sampling.service import (
    DEFAULT_DIRECTION,
    GatherApplyRouting,
    OwnerRouting,
    SampledSubgraph,
    SampleTicket,
    SamplingService,
    SamplingSpec,
    SamplingServer,
    ServerStats,
    VertexRouter,
)
from repro_torch.graph.graph import GraphPartition, HeteroGraph
from repro_torch.graph.reorder import REORDER_ALGS

if TYPE_CHECKING:
    from repro_torch.api.config import GLISPConfig

__all__ = [
    "PartitionPlan",
    "Partitioner",
    "PartitionPipeline",
    "SamplerBackend",
    "GatherApplyBackend",
    "EdgeCutBackend",
    "PARTITIONERS",
    "SAMPLERS",
    "REORDERS",
    "CACHE_POLICIES",
    "STORAGE_TIERS",
]


# ---------------------------------------------------------------------------
# Partitioners: ``PARTITIONERS``, ``PartitionPlan`` and the ``Partitioner``
# protocol are owned by the partitioning subsystem (``repro_torch.core.partition``,
# mirroring the storage-owned ``CACHE_POLICIES``) and re-exported here as the
# canonical public import path.  Every entry is a ``Partitioner`` instance:
# ``PARTITIONERS.get(name).partition(g, num_parts, seed=..., direction=...)``
# (instances are also callable with the same signature).
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Sampler backends
# ---------------------------------------------------------------------------


@runtime_checkable
class SamplerBackend(Protocol):
    """The one sampling surface the facade, trainer and engine consume."""

    name: str

    def submit(
        self,
        seeds: np.ndarray,
        spec: SamplingSpec | None = None,
        *,
        key=None,
    ) -> SampleTicket: ...

    # DEPRECATED submit-and-wait shim (kept one release)
    def sample(
        self,
        seeds: np.ndarray,
        fanouts: list[int],
        *,
        weighted: bool = False,
        direction: str = DEFAULT_DIRECTION,
    ) -> SampledSubgraph: ...

    def server_workloads(self) -> np.ndarray: ...

    def reset_stats(self) -> None: ...


class _ServiceBackend:
    """Shared adapter: one ``SamplingService`` behind the backend protocol."""

    name = "base"

    def __init__(self, service: SamplingService):
        self.service = service

    # -- async request-plan surface ------------------------------------
    def submit(
        self,
        seeds: np.ndarray,
        spec: SamplingSpec | None = None,
        *,
        key=None,
    ) -> SampleTicket:
        return self.service.submit(seeds, spec, key=key)

    # -- blocking shim (one release of deprecation) --------------------
    def sample(
        self,
        seeds: np.ndarray,
        fanouts: list[int],
        *,
        weighted: bool = False,
        direction: str = DEFAULT_DIRECTION,
    ) -> SampledSubgraph:
        """DEPRECATED: submit-and-wait over :meth:`submit`."""
        return self.service.sample_khop(
            seeds, list(fanouts), weighted=weighted, direction=direction
        )

    # -- stats ---------------------------------------------------------
    def stats(self) -> ServerStats:
        return self.service.stats()

    def server_workloads(self) -> np.ndarray:
        return self.service.server_workloads()

    def reset_stats(self) -> None:
        # the service's reset clears per-server counters AND the
        # parallel/total work accumulators — no adapter workaround needed
        self.service.reset_stats()

    def close(self, timeout: float = 2.0) -> None:
        """Release the remote worker pool, if this backend has one."""
        self.service.close(timeout=timeout)

    @property
    def client(self):
        """Legacy alias: the service plays the old client role."""
        return self.service

    @property
    def parallel_work(self) -> float:
        return self.service.parallel_work

    @property
    def total_work(self) -> float:
        return self.service.total_work

    def __repr__(self) -> str:
        return f"{type(self).__name__}(servers={len(self.service.servers)})"


class GatherApplyBackend(_ServiceBackend):
    """GLISP: vertex-cut servers, Gather from every host, Apply merge."""

    name = "gather_apply"

    @property
    def router(self) -> VertexRouter:
        return self.service.router


class EdgeCutBackend(_ServiceBackend):
    """DistDGL-style baseline: one-hop answered only by the seed's owner."""

    name = "edge_cut"

    @property
    def vertex_owner(self) -> np.ndarray:
        return self.service.routing.owner


SAMPLERS: Registry = Registry("sampler backend")


@SAMPLERS.register("gather_apply")
def _build_gather_apply(
    g: HeteroGraph,
    plan: PartitionPlan,
    parts: list[GraphPartition],
    config: "GLISPConfig",
) -> GatherApplyBackend:
    cost = config.cost_model or "algd"
    servers = [SamplingServer(p, seed=config.seed, cost_model=cost) for p in parts]
    router = VertexRouter(g, plan.edge_parts, config.num_parts)
    service = SamplingService(
        servers,
        GatherApplyRouting(router),
        seed=config.seed,
        coalesce=config.coalesce,
        max_server_batch=config.max_server_batch,
        replicas=config.server_replicas,
        fault_plan=config.fault_plan,
        retry_policy=config.retry_policy,
        ticket_timeout=config.ticket_timeout,
    )
    return GatherApplyBackend(service)


@SAMPLERS.register("edge_cut")
def _build_edge_cut(
    g: HeteroGraph,
    plan: PartitionPlan,
    parts: list[GraphPartition],
    config: "GLISPConfig",
) -> EdgeCutBackend:
    if plan.vertex_owner is None:
        raise ValueError(
            "the 'edge_cut' sampler backend needs a vertex partitioner that "
            "produces owners (e.g. partitioner='ldg'); "
            f"{config.partitioner!r} yields only a vertex-cut edge assignment"
        )
    cost = config.cost_model or "scan"
    servers = [SamplingServer(p, seed=config.seed, cost_model=cost) for p in parts]
    service = SamplingService(
        servers,
        OwnerRouting(plan.vertex_owner, config.num_parts),
        seed=config.seed,
        coalesce=config.coalesce,
        max_server_batch=config.max_server_batch,
        replicas=config.server_replicas,
        fault_plan=config.fault_plan,
        retry_policy=config.retry_policy,
        ticket_timeout=config.ticket_timeout,
    )
    return EdgeCutBackend(service)


# ---------------------------------------------------------------------------
# Reorder algorithms (thin: validate + canonicalize).  Cache policies and
# storage tiers re-export from the tiered storage subsystem
# (``repro_torch.core.storage``), which owns their registries.
# ---------------------------------------------------------------------------

REORDERS: Registry = Registry("reorder algorithm")
for _alg in REORDER_ALGS:
    REORDERS.register(_alg, _alg)
