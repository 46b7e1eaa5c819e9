"""Bounded admission queue for the serving tier.

Admission control is the first SLO mechanism: a server drowning in
requests must shed load *at the door* with an explicit rejection the
client sees, not buffer unboundedly until every queued request misses its
deadline.  ``push`` therefore returns ``False`` when the queue is full —
callers turn that into a ``status="rejected"`` response and count it.
"""
from __future__ import annotations

import collections

__all__ = ["RequestQueue"]


class RequestQueue:
    """FIFO queue with a hard depth bound and explicit rejection."""

    def __init__(self, depth: int):
        if depth <= 0:
            raise ValueError(f"queue depth must be positive, got {depth}")
        self.depth = int(depth)
        # bound enforced by push() below: a full queue must REJECT (the
        # caller sees False and answers status="rejected"), which
        # deque(maxlen=) cannot express — it silently drops the oldest
        # entry instead
        self._q = collections.deque()  # glint: disable=PRJ005 -- see above

    def push(self, item) -> bool:
        """Admit ``item``; ``False`` (and no side effect) when full."""
        if len(self._q) >= self.depth:
            return False
        self._q.append(item)
        return True

    def pop(self):
        """Oldest admitted item, or ``None`` when empty."""
        return self._q.popleft() if self._q else None

    def peek(self):
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
