"""Continuous batcher: pack admitted requests into the engine's buckets.

The inference engine compiles one jit slice per (layer, vertex-bucket,
edge-bucket) shape.  The batcher's job is to ride those existing buckets:
it accumulates queued requests until the pending vertex rows would spill
past the compute budget (``max_rows``, the engine's inference batch size —
the largest vertex bucket), or until the oldest pending request has waited
``max_delay_ms`` (a partial bucket flushes on the timer rather than
starving at low load).  Because padded shapes snap to the same power-of-two
ladder the offline engine already traced, a warmed server triggers zero new
compiles — ``repro.analysis.recompile_guard`` asserts exactly that over the
serving loop.
"""
from __future__ import annotations

__all__ = ["ContinuousBatcher"]


class ContinuousBatcher:
    """Time- and size-bounded packer over (entry, rows) pairs.

    Pure scheduling — no compute, no clocks of its own: callers pass
    ``now`` (monotonic seconds) into every method, which keeps the policy
    deterministic and unit-testable."""

    def __init__(self, max_rows: int, max_delay_ms: float):
        if max_rows <= 0:
            raise ValueError(f"max_rows must be positive, got {max_rows}")
        if max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {max_delay_ms}"
            )
        self.max_rows = int(max_rows)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._pending: list = []  # (entry, rows, added_at) in arrival order
        self._rows = 0

    def add(self, entry, rows: int, now: float) -> None:
        self._pending.append((entry, int(rows), now))
        self._rows += int(rows)

    @property
    def pending_rows(self) -> int:
        return self._rows

    def __len__(self) -> int:
        return len(self._pending)

    def has_room(self) -> bool:
        """Whether another request fits before the size trigger fires."""
        return self._rows < self.max_rows

    def ready(self, now: float) -> bool:
        """Flush trigger: bucket budget reached, or the oldest pending
        request has waited out the delay timer."""
        if not self._pending:
            return False
        if self._rows >= self.max_rows:
            return True
        return (now - self._pending[0][2]) >= self.max_delay_s

    def take(self, now: float, force: bool = False) -> list | None:
        """Pop one batch (arrival order) if a trigger fired, else ``None``.

        ``force=True`` flushes a partial batch immediately — the server
        uses it when the engine would otherwise sit idle (nothing left to
        wait for).  At most ``max_rows`` rows are taken; the first entry
        is always included even if it alone exceeds the budget, so an
        oversized request cannot deadlock the batcher."""
        if not self._pending or not (force or self.ready(now)):
            return None
        batch, total = [], 0
        while self._pending:
            entry, rows, _ = self._pending[0]
            if batch and total + rows > self.max_rows:
                break
            self._pending.pop(0)
            batch.append(entry)
            total += rows
            self._rows -= rows
        return batch
