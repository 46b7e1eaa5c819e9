"""Checks of a sampled hop against the graph, by itself.

The program draws each request's neighbours from streams keyed by its
partitioner's layout; the reference cannot draw them again without
re-implementing the partitioner. So the reference follows the program's
sampled edges, and this module checks that stage on its own: every edge
is an out-edge of the graph from a vertex of the hop's frontier, no edge
is taken more often than the graph holds it, no vertex takes more than the
hop's fanout, and the hop holds most of the edges it could
(``fill``: sampled edges over the sum of min(fanout, out-degree) over the
frontier; randomized rounding across partitions makes it a little under 1).
"""
from __future__ import annotations

import numpy as np

__all__ = ["EdgeIndex", "HopCheck"]


class EdgeIndex:
    """The graph's out-edges as sorted keys src * n + dst, with their
    multiplicities, and every vertex's out-degree."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int):
        self.n = int(n)
        keys = src.astype(np.int64) * self.n + dst.astype(np.int64)
        self.keys, self.mult = np.unique(keys, return_counts=True)
        self.outdeg = np.bincount(src, minlength=self.n)

    def multiplicity(self, s: np.ndarray, d: np.ndarray) -> np.ndarray:
        """How often the graph holds each edge s -> d (0: not an edge)."""
        if s.shape[0] == 0:
            return np.zeros(0, np.int64)
        if s.min() < 0 or d.min() < 0 or s.max() >= self.n or d.max() >= self.n:
            out = np.zeros(s.shape[0], np.int64)
            ok = (s >= 0) & (d >= 0) & (s < self.n) & (d < self.n)
            out[ok] = self.multiplicity(s[ok], d[ok])
            return out
        k = s.astype(np.int64) * self.n + d.astype(np.int64)
        pos = np.minimum(np.searchsorted(self.keys, k), self.keys.shape[0] - 1)
        return np.where(self.keys[pos] == k, self.mult[pos], 0)


class HopCheck:
    """Accumulates the faults and the fill of sampled hops."""

    def __init__(self, index: EdgeIndex):
        self.index = index
        self.bad = 0
        self.filled = 0
        self.possible = 0
        self.fills: list = []

    def fault(self, count: int = 1) -> None:
        self.bad += int(count)

    def hop(self, frontier: np.ndarray, s: np.ndarray, d: np.ndarray, fanout: int) -> None:
        """One hop: edges s[i] -> d[i] sampled for the vertices ``frontier``."""
        frontier = np.unique(frontier)
        self.bad += int((~np.isin(s, frontier)).sum())
        mult = self.index.multiplicity(s, d)
        self.bad += int((mult == 0).sum())
        if s.shape[0]:
            k = s.astype(np.int64) * self.index.n + d.astype(np.int64)
            uk, first, taken = np.unique(k, return_index=True, return_counts=True)
            self.bad += int((taken > mult[first]).sum())
            _, per_vertex = np.unique(s, return_counts=True)
            self.bad += int((per_vertex > fanout).sum())
        ok = (frontier >= 0) & (frontier < self.index.n)
        self.bad += int((~ok).sum())
        possible = int(np.minimum(self.index.outdeg[frontier[ok]], fanout).sum())
        self.filled += int(s.shape[0])
        self.possible += possible
        if possible:
            self.fills.append(s.shape[0] / possible)

    def fill(self) -> float:
        """Sampled edges over the edges the hops could hold, all hops."""
        return self.filled / self.possible if self.possible else 1.0
