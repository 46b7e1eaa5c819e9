"""The partitioning subsystem's shared surface: ``Partitioner`` protocol,
the rich ``PartitionPlan`` artifact, and the ``PARTITIONERS`` registry.

Every registered partitioner is an *instance* implementing

    plan = partitioner.partition(g, num_parts, seed=..., direction=...)

and returns a ``PartitionPlan`` — the one artifact the rest of the stack
(build functions, sampler backends, the pipeline cache) consumes.  Besides the raw
vertex-cut edge assignment the plan carries per-partition vertex/edge
counts, the paper's Eq. (2)-(4) quality scores (RF / VB / EB) and, for
iterative partitioners, a per-iteration convergence trace.

The registry lives here (not in ``repro.api.backends``) for the same reason
``CACHE_POLICIES`` lives in ``repro.core.storage``: the subsystem owns its
own extension point and the API package re-exports it.  ``Registry`` itself
is dependency-free (``repro.utils``), so nothing below ``repro.api`` is
imported from here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.sampling.service import DEFAULT_DIRECTION
from repro_torch.graph.graph import HeteroGraph
from repro_torch.utils import Registry

__all__ = [
    "PartitionPlan",
    "Partitioner",
    "PartitionerBase",
    "PARTITIONERS",
    "hosted_vertex_counts",
]


def hosted_vertex_counts(
    g: HeteroGraph, edge_parts: np.ndarray, num_parts: int
) -> np.ndarray:
    """Vertices hosted per partition (endpoints of its edges), vectorized:
    one unique over the (partition, vertex) incidence pairs, no per-partition
    edge scan."""
    ep = edge_parts.astype(np.int64)
    n = np.int64(max(1, g.num_vertices))
    pairs = np.concatenate([ep * n + g.src, ep * n + g.dst])
    uniq = np.unique(pairs)
    return np.bincount((uniq // n).astype(np.int64), minlength=num_parts)


@dataclass(frozen=True)
class PartitionPlan:
    """Output of any registered partitioner.

    ``edge_parts[e]`` is the partition id of edge e (the vertex-cut edge
    assignment every backend builds from).  ``vertex_owner`` is set only by
    edge-cut (vertex) partitioners and is required by the ``edge_cut``
    sampler backend for owner routing.

    The remaining fields are the plan's quality scorecard, populated by
    :meth:`from_assignment` (all registry entries go through it):
    ``edge_counts``/``vertex_counts`` are |E_p| and hosted-|V_p| per
    partition, ``replication_factor``/``vertex_balance``/``edge_balance``
    the paper's Eq. (2)-(4), and ``iteration_trace`` a dict of stacked
    per-iteration arrays for iterative partitioners (AdaDNE/DNE record
    ``remaining``, ``edge_counts``, ``vertex_counts`` and ``lam``)."""

    edge_parts: np.ndarray
    vertex_owner: np.ndarray | None = None
    num_parts: int = 0
    partitioner: str = ""
    seed: int = 0
    edge_counts: np.ndarray | None = None
    vertex_counts: np.ndarray | None = None
    replication_factor: float | None = None
    vertex_balance: float | None = None
    edge_balance: float | None = None
    iteration_trace: dict | None = None

    # ------------------------------------------------------------------
    @classmethod
    def from_assignment(
        cls,
        g: HeteroGraph,
        edge_parts: np.ndarray,
        num_parts: int,
        *,
        vertex_owner: np.ndarray | None = None,
        partitioner: str = "",
        seed: int = 0,
        iteration_trace: dict | None = None,
    ) -> "PartitionPlan":
        """Build a plan with the quality scorecard computed from the raw
        vertex-cut edge assignment."""
        edge_parts = np.asarray(edge_parts)
        ec = np.bincount(edge_parts.astype(np.int64), minlength=num_parts)
        vc = hosted_vertex_counts(g, edge_parts, num_parts)
        return cls(
            edge_parts=edge_parts,
            vertex_owner=vertex_owner,
            num_parts=num_parts,
            partitioner=partitioner,
            seed=seed,
            edge_counts=ec,
            vertex_counts=vc,
            replication_factor=float(vc.sum()) / max(1, g.num_vertices),
            vertex_balance=float(vc.max()) / max(1, int(vc.min())),
            edge_balance=float(ec.max()) / max(1, int(ec.min())),
            iteration_trace=iteration_trace,
        )

    def metrics(self) -> dict:
        """The scorecard in the shape of ``partition_metrics`` (RF/VB/EB)."""
        return {
            "RF": self.replication_factor,
            "VB": self.vertex_balance,
            "EB": self.edge_balance,
            "vertices": (
                self.vertex_counts.tolist()
                if self.vertex_counts is not None
                else None
            ),
            "edges": (
                self.edge_counts.tolist()
                if self.edge_counts is not None
                else None
            ),
        }


@runtime_checkable
class Partitioner(Protocol):
    """The one partitioning surface: a named component producing a plan."""

    name: str

    def partition(
        self,
        g: HeteroGraph,
        num_parts: int,
        *,
        seed: int = 0,
        direction: str = DEFAULT_DIRECTION,
    ) -> PartitionPlan: ...


class PartitionerBase:
    """Convenience base: makes a partitioner callable like the old free
    functions (``PARTITIONERS.get(name)(g, parts, seed=0)``) so registry
    call sites keep one calling convention."""

    name = "base"

    @property
    def cache_token(self) -> str:
        """String folded into the pipeline's content-addressed cache key.
        Must change whenever the instance is configured to produce a
        different plan for the same (graph, num_parts, seed, direction) —
        the default covers stateless partitioners; configurable ones
        append their hyperparameters."""
        return self.name

    def __call__(
        self,
        g: HeteroGraph,
        num_parts: int,
        *,
        seed: int = 0,
        direction: str = DEFAULT_DIRECTION,
    ) -> PartitionPlan:
        return self.partition(g, num_parts, seed=seed, direction=direction)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


# Populated by ``repro.core.partition.__init__`` (one instance per entry:
# adadne, adadne_loop, dne, dne_loop, ldg, hash2d, random); re-exported as
# ``repro.api.PARTITIONERS``.
PARTITIONERS: Registry = Registry("partitioner")
