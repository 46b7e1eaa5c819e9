"""Serve-tier metrics: counters, batch occupancy, and online percentiles.

The latency estimator is the P² (piecewise-parabolic) streaming quantile
algorithm (Jain & Chlamtac, 1985): five markers per tracked quantile,
O(1) memory and update cost, no sample buffer — exact until five
observations arrive, then a parabolic approximation.  Good enough for SLO
dashboards; the benchmark cross-checks it against exact percentiles on the
recorded latency list.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["P2Quantile", "LatencyEstimator", "ServeStats"]


class P2Quantile:
    """One streaming quantile via the P² algorithm (no sample retention)."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._heights: list[float] = []  # marker heights (5 once warm)
        self._pos: list[float] = []  # actual marker positions (1-based)
        self._want: list[float] = []  # desired marker positions
        self.count = 0

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        h = self._heights
        if self.count <= 5:
            h.append(x)
            h.sort()
            if self.count == 5:
                q = self.q
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
            return
        # locate the cell containing x, clamping the extremes
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        q = self.q
        incr = [0.0, q / 2, q, (1 + q) / 2, 1.0]
        for i in range(5):
            self._want[i] += incr[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            left = self._pos[i] - self._pos[i - 1]
            right = self._pos[i + 1] - self._pos[i]
            if (d >= 1.0 and right > 1.0) or (d <= -1.0 and left > 1.0):
                s = 1.0 if d >= 0 else -1.0
                cand = self._parabolic(i, s)
                if not h[i - 1] < cand < h[i + 1]:
                    cand = self._linear(i, s)
                h[i] = cand
                self._pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s)
            * (h[i + 1] - h[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s)
            * (h[i] - h[i - 1])
            / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, s: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(s)
        return h[i] + s * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        if not self._heights:
            return 0.0
        if self.count < 5:
            # exact small-sample quantile (nearest-rank on the sorted buffer)
            idx = min(
                len(self._heights) - 1,
                max(0, round(self.q * (len(self._heights) - 1))),
            )
            return self._heights[idx]
        return self._heights[2]


class LatencyEstimator:
    """Online P50/P95/P99 over completion latencies (milliseconds)."""

    QUANTILES = (0.50, 0.95, 0.99)

    def __init__(self):
        self._est = {q: P2Quantile(q) for q in self.QUANTILES}
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)
        for est in self._est.values():
            est.add(ms)

    def quantile(self, q: float) -> float:
        return self._est[q].value()

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": self.mean,
            "p50_ms": self.p50,
            "p95_ms": self.p95,
            "p99_ms": self.p99,
            "max_ms": self.max_ms,
        }


@dataclass
class ServeStats:
    """First-class serving metrics: every path a request can take shows up
    in exactly one counter, and capacity effects (queue depth, padding
    waste, cache tiering) are observable without instrumenting callers."""

    # request lifecycle counters
    submitted: int = 0
    completed: int = 0
    rejected: int = 0  # admission-queue full: explicit, never silent
    timed_out: int = 0  # deadline passed before the response was computed
    degraded: int = 0  # ok responses built from partial-fanout samples

    # queue observability
    queue_depth: int = 0  # current
    queue_peak: int = 0

    # batch occupancy: real rows/edges vs the padded bucket shapes that
    # actually went through the jit slice (padding waste = 1 - occupancy)
    batches: int = 0
    batch_rows: int = 0
    padded_rows: int = 0
    batch_edges: int = 0
    padded_edges: int = 0

    # per-tier serving-cache hit fractions, refreshed after every batch
    # (keys as HybridStats.hit_ratios(): "0:memory", "1:disk", ..., "dfs")
    cache_hit_ratios: dict = field(default_factory=dict)

    # sampling-backend health by site (keys as system.server_health():
    # "server.<part>.<replica>", plus "worker.<part>" rows under a remote
    # dispatcher), refreshed after every batch — surfaces breaker/worker
    # state on the same dashboard as the serving counters
    server_health: dict = field(default_factory=dict)

    latency: LatencyEstimator = field(default_factory=LatencyEstimator)

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.queue_peak = max(self.queue_peak, depth)

    def note_batch(self, rows: int, padded_rows: int, edges: int, padded_edges: int) -> None:
        self.batches += 1
        self.batch_rows += rows
        self.padded_rows += padded_rows
        self.batch_edges += edges
        self.padded_edges += padded_edges

    def occupancy(self) -> float:
        """Fraction of padded vertex rows that carried real requests."""
        return self.batch_rows / self.padded_rows if self.padded_rows else 0.0

    def edge_occupancy(self) -> float:
        return self.batch_edges / self.padded_edges if self.padded_edges else 0.0

    def mean_batch_requests(self) -> float:
        done = self.completed - self.timed_out
        return done / self.batches if self.batches else 0.0

    def snapshot(self) -> dict:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "timed_out": self.timed_out,
            "degraded": self.degraded,
            "queue_depth": self.queue_depth,
            "queue_peak": self.queue_peak,
            "batches": self.batches,
            "occupancy": self.occupancy(),
            "edge_occupancy": self.edge_occupancy(),
            "cache_hit_ratios": dict(self.cache_hit_ratios),
            "server_health": dict(self.server_health),
            "latency": self.latency.summary(),
        }
