"""Exact statistics of a run's own timestamps, and the spread that bounds
are set from."""
from __future__ import annotations

import statistics

import numpy as np

__all__ = ["percentile", "rate", "spread"]


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (linear between the two nearest
    ranks), not an estimate."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("no values")
    return float(np.percentile(v, q))


def rate(count: float, seconds: float) -> float:
    """Work done over the whole window's seconds: a stall anywhere in the
    window lowers it."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
