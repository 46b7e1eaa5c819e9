"""Admission/eviction policies for ``HybridCache`` tiers (paper §III-D).

A policy tracks the chunks resident in ONE bounded tier and picks eviction
victims; the cache calls ``on_admit``/``on_access``/``forget`` as chunks
move.  Policies are pluggable through the ``CACHE_POLICIES`` registry (the
name ``GLISPConfig.cache_policy`` resolves):

    fifo       evict the oldest-admitted chunk (the paper's default)
    lru        evict the least-recently-used chunk
    locality   evict the chunk farthest (in reorder-chunk distance) from the
               active partition's fill window — after the PDS reorder a
               partition occupies a contiguous chunk interval, so distance
               to that interval predicts reuse: local chunks are re-read
               throughout the slice, far chunks are one-shot boundary
               neighbors.  Ties fall back to FIFO age.

``HybridCache.plan_fill`` sets the focus interval on every policy that
accepts one (``set_focus``), so the locality policy needs no extra wiring
at call sites.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.utils import Registry

__all__ = [
    "CACHE_POLICIES",
    "EvictionPolicy",
    "FifoPolicy",
    "LruPolicy",
    "LocalityPolicy",
    "resolve_policy",
]


CACHE_POLICIES: Registry = Registry("cache policy")


class EvictionPolicy:
    """Base: insertion-ordered chunk tracking (FIFO semantics)."""

    name = "base"

    def __init__(self):
        self._order: OrderedDict[int, None] = OrderedDict()

    def on_admit(self, c: int) -> None:
        self._order[c] = None

    def on_access(self, c: int) -> None:  # FIFO: age is admission order
        pass

    def forget(self, c: int) -> None:
        self._order.pop(c, None)

    def victim(self) -> int:
        """The chunk to evict next (must be tracked); FIFO head by default."""
        return next(iter(self._order))

    def set_focus(self, lo: int, hi: int) -> None:
        """Hint: the active fill window [lo, hi] in chunk ids (no-op for
        access-order policies)."""

    def clear(self) -> None:
        self._order.clear()

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(tracked={len(self._order)})"


@CACHE_POLICIES.register("fifo")
class FifoPolicy(EvictionPolicy):
    name = "fifo"


@CACHE_POLICIES.register("lru")
class LruPolicy(EvictionPolicy):
    name = "lru"

    def on_access(self, c: int) -> None:
        if c in self._order:
            self._order.move_to_end(c)


@CACHE_POLICIES.register("locality")
class LocalityPolicy(EvictionPolicy):
    """Locality-aware eviction: farthest-from-the-fill-window-first.

    The PDS reorder lays each partition's vertices (hubs first) into a
    contiguous run of chunk ids, so the fill window ``[lo, hi]`` of the
    active partition is exactly the high-reuse region; chunks pulled in for
    boundary neighbors sit far outside it and are rarely touched twice.
    Eviction therefore scores every tracked chunk by its distance to the
    window and drops the farthest (FIFO age breaks ties), keeping the local
    working set hot where FIFO/LRU would cycle it out."""

    name = "locality"

    def __init__(self):
        super().__init__()
        self._lo = 0
        self._hi = 0

    def set_focus(self, lo: int, hi: int) -> None:
        self._lo, self._hi = int(lo), int(hi)

    def _distance(self, c: int) -> int:
        if c < self._lo:
            return self._lo - c
        if c > self._hi:
            return c - self._hi
        return 0

    def victim(self) -> int:
        # max distance wins; insertion (FIFO) order breaks ties, which the
        # OrderedDict iteration order provides for free
        return max(self._order, key=self._distance)


def resolve_policy(policy) -> EvictionPolicy:
    """One fresh policy instance from a name, class, instance, or the legacy
    ``CachePolicy`` str-enum (its members are plain strings underneath)."""
    if isinstance(policy, EvictionPolicy):
        return policy
    if isinstance(policy, type) and issubclass(policy, EvictionPolicy):
        return policy()
    if isinstance(policy, str):  # includes CachePolicy str-enum members
        return CACHE_POLICIES.get(policy)()
    raise TypeError(f"cannot resolve cache policy from {policy!r}")
