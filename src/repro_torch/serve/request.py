"""Serve-tier request/response pair.

A :class:`ServeRequest` is "embed these vertices now": a set of vertex ids
plus a per-request deadline.  The server answers with a
:class:`ServeResponse` carrying the final-layer embeddings in the order the
vertices were requested — or an explicit non-``ok`` status.  Nothing is ever
dropped silently: admission failure is ``status="rejected"``, a missed
deadline is ``status="timeout"``, and a partial-fanout sample (faulted
replicas exhausted) completes with ``degraded=True``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["ServeRequest", "ServeResponse"]


@dataclass(frozen=True)
class ServeRequest:
    """One inference request: vertex ids + deadline.

    ``request_id`` names the request's sampling RNG stream (the server keys
    ``SamplingService.submit`` with it), so the response is a pure function
    of ``(system, request_id, vertices)`` — bit-identical no matter how the
    request is batched with other traffic.  ``deadline_ms`` is the latency
    budget from admission; ``None`` defers to the server's configured
    default."""

    request_id: int
    vertices: np.ndarray
    deadline_ms: float | None = None
    submitted_at: float = 0.0  # monotonic admission timestamp

    # unique-sorted view the compute path runs on (submit() normalizes seeds
    # the same way, so sampling and compute agree on the row universe)
    unique: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @staticmethod
    def make(
        request_id: int,
        vertices: np.ndarray,
        deadline_ms: float | None,
        now: float,
    ) -> "ServeRequest":
        verts = np.asarray(vertices, dtype=np.int64)
        if verts.ndim != 1 or verts.shape[0] == 0:
            raise ValueError(
                f"ServeRequest needs a non-empty 1-D vertex array, got "
                f"shape {verts.shape}"
            )
        return ServeRequest(
            request_id=request_id,
            vertices=verts,
            deadline_ms=deadline_ms,
            submitted_at=now,
            unique=np.unique(verts),
        )

    def deadline_at(self, default_ms: float | None) -> float | None:
        """Absolute monotonic deadline, or None for no bound."""
        ms = self.deadline_ms if self.deadline_ms is not None else default_ms
        return None if ms is None else self.submitted_at + ms / 1e3


@dataclass
class ServeResponse:
    """The answer to one :class:`ServeRequest`.

    ``status`` is one of ``"ok"`` / ``"rejected"`` (admission queue full) /
    ``"timeout"`` (deadline passed before completion).  ``embeddings`` is
    ``(len(vertices), out_dim)`` in the requested order for ``ok``
    responses, ``None`` otherwise.  ``degraded=True`` stamps an ``ok``
    response whose sample lost dispatches to faults (partial fanout — the
    flagged-never-silent contract of ``SampledSubgraph.degraded``)."""

    request_id: int
    status: str
    embeddings: np.ndarray | None = None
    degraded: bool = False
    latency_ms: float = 0.0
    # how many requests shared the compute batch (1 = served solo)
    batch_requests: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"
