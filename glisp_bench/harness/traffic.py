"""Open-loop traffic: independent users' "embed these vertices now"
requests, due on a schedule whatever the server does.

The idea of ``zipf_requests`` in ``chip_smoke.py`` and of the JAX
package's serving benchmark (Zipf popularity), rewritten at commit
2c9ddc5f1ad4cf75904747720f1e0edd62342e0b as an open loop: Poisson
arrivals at a fixed rate, a uniform number of vertices a request, each
vertex drawn by a Zipf law over the ranks 1..N (bounded: chip_smoke's
clipping of the unbounded law put about a quarter of the draws on the
last rank) of a permutation of the vertices drawn from the seed.

Every seed gets the same multiset of gaps, sizes and ranks (drawn from the
mix's ``base_seed``), in its own order and over its own permutation, so
that seeds change which vertices are hot and when, not how much work a
window holds.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Schedule", "draws", "schedule"]


class Schedule:
    """Requests ``vertices[i]`` due ``due[i]`` seconds after the start."""

    def __init__(self, due: np.ndarray, vertices: list):
        self.due = due
        self.vertices = vertices

    def __len__(self) -> int:
        return len(self.vertices)


def draws(mix: dict, count: int, seed: int, num_vertices: int, stream: int = 0):
    """``count`` requests' gaps and vertices in the seed's order: the same
    multiset of gaps, sizes and ranks for every seed (from the mix's
    ``base_seed``), ordered by the seed and mapped through the seed's
    permutation of the vertices."""
    rate = float(mix["rate_per_s"])
    base = np.random.default_rng([mix["base_seed"], stream])
    gaps = base.exponential(1.0 / rate, count)
    sizes = base.integers(mix["min_vertices"], mix["max_vertices"] + 1, count)
    weights = np.arange(1, num_vertices + 1, dtype=np.float64) ** -float(mix["zipf_exponent"])
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    ranks = np.minimum(np.searchsorted(cdf, base.random(int(sizes.sum())), side="right"),
                       num_vertices - 1)
    starts = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    rng = np.random.default_rng([int(seed), stream])
    order = rng.permutation(count)
    perm = rng.permutation(num_vertices)
    vertices = [perm[ranks[starts[i]:starts[i] + sizes[i]]].astype(np.int64) for i in order]
    return gaps[order], vertices


def schedule(mix: dict, seed: int, seconds: float, num_vertices: int, stream: int = 0) -> Schedule:
    """The requests due in ``[0, seconds)`` at the mix's ``rate_per_s``;
    ``stream`` picks another schedule of the same seed (the warm-up's)."""
    count = int(float(mix["rate_per_s"]) * seconds * 1.25) + 64
    gaps, vertices = draws(mix, count, seed, num_vertices, stream)
    due = np.cumsum(gaps)
    keep = int(np.searchsorted(due, seconds, side="left"))
    return Schedule(due[:keep], vertices[:keep])
