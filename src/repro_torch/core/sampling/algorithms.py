"""Sampling primitives: Vitter's Algorithm D (uniform without replacement,
sequential/streaming) and Efraimidis–Spirakis Algorithm A-ES (weighted without
replacement via exponential-race scores), as used by the paper's Gather ops.
"""
from __future__ import annotations

import numpy as np

__all__ = ["algorithm_d", "algorithm_a_es", "uniform_sample"]


def algorithm_d(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """Vitter's Algorithm D: k uniform indices without replacement from
    range(n), emitted in increasing order, O(k) time and O(1) extra space.

    Faithful implementation of the skip-distance method (Vitter 1987, with the
    Algorithm A fallback for small n/k ratios)."""
    if k <= 0:
        return np.zeros(0, dtype=np.int64)
    if k >= n:
        return np.arange(n, dtype=np.int64)
    out = np.empty(k, dtype=np.int64)
    i = 0  # next candidate index
    j = 0  # number selected
    n_rem, k_rem = n, k
    alpha = 13  # switch to Algorithm A when n_rem <= alpha * k_rem
    while k_rem > 1:
        if n_rem <= alpha * k_rem:
            # Algorithm A: simple sequential scan
            top = n_rem - k_rem
            while k_rem > 1:
                v = rng.random()
                s = 0
                quot = top / n_rem
                while quot > v:
                    s += 1
                    top -= 1
                    n_rem -= 1
                    quot *= top / n_rem
                i += s
                out[j] = i
                j += 1
                i += 1
                n_rem -= 1
                k_rem -= 1
            break
        # Algorithm D skip generation
        vprime = rng.random() ** (1.0 / k_rem)
        qu1 = n_rem - k_rem + 1
        while True:
            # generate U and X
            while True:
                x = n_rem * (1.0 - vprime)
                s = int(x)
                if s < qu1:
                    break
                vprime = rng.random() ** (1.0 / k_rem)
            u = rng.random()
            # acceptance test (simplified exact rejection via f(s))
            y1 = (u * n_rem / qu1) ** (1.0 / (k_rem - 1))
            vprime = y1 * (1.0 - x / n_rem) ** -1 * (qu1 / (qu1 - s))
            if vprime <= 1.0:
                break  # accept by squeeze
            # full test
            y2 = 1.0
            top2 = n_rem - 1.0
            if k_rem - 1 > s:
                bottom = n_rem - k_rem
                limit = n_rem - s
            else:
                bottom = n_rem - s - 1.0
                limit = qu1
            t = n_rem - 1.0
            while t >= limit:
                y2 *= top2 / bottom
                top2 -= 1.0
                bottom -= 1.0
                t -= 1.0
            if n_rem / (n_rem - x) >= y1 * (y2 ** (1.0 / (k_rem - 1))):
                vprime = rng.random() ** (1.0 / (k_rem - 1))
                break
            vprime = rng.random() ** (1.0 / k_rem)
        i += s
        out[j] = i
        j += 1
        i += 1
        n_rem -= s + 1
        k_rem -= 1
    # last record: uniform over the remainder
    if k_rem == 1:
        s = int(n_rem * rng.random())
        i += s
        out[j] = i
        j += 1
    return out[:j]


def uniform_sample(
    n: int, k: int, rng: np.random.Generator, use_vitter: bool = False
) -> np.ndarray:
    """k uniform indices from range(n) without replacement.  The vectorized
    numpy path is distribution-identical to Algorithm D; ``use_vitter=True``
    runs the faithful streaming implementation (validated equivalent in
    tests/test_sampling_algorithms.py)."""
    if k <= 0:
        return np.zeros(0, dtype=np.int64)
    if k >= n:
        return np.arange(n, dtype=np.int64)
    if use_vitter:
        return algorithm_d(n, k, rng)
    if k * 4 >= n:
        return np.sort(rng.permutation(n)[:k]).astype(np.int64)
    # rejection-free for k << n: Floyd's algorithm vectorized-ish
    return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)


def algorithm_a_es(
    weights: np.ndarray, k: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Efraimidis–Spirakis A-ES: weighted sampling without replacement.

    Returns (indices, scores) of the top-k items by score u_i^{1/w_i}.
    Items with zero/negative weight are never selected (score 0).
    The *scores* are what make the algorithm distributable: global top-k of
    per-server top-k equals single-machine top-k (Gather/Apply, paper Alg 3/4).
    """
    n = weights.shape[0]
    if n == 0 or k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    u = rng.random(n)
    w = np.asarray(weights, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = np.where(w > 0, u ** (1.0 / np.maximum(w, 1e-300)), 0.0)
    # never pad the draw with zero-weight items (P ∝ w means P = 0)
    k = min(k, int((w > 0).sum()))
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    if k == n:
        idx = np.argsort(-scores, kind="stable")
    else:
        part = np.argpartition(-scores, k - 1)[:k]
        idx = part[np.argsort(-scores[part], kind="stable")]
    return idx.astype(np.int64), scores[idx]
