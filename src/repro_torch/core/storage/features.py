"""``FeatureSource`` — one feature-fetch surface for the training path.

``subgraph_to_batch`` / ``BatchPipeline`` historically indexed a raw
in-memory ``[N, F]`` ndarray.  A ``FeatureSource`` abstracts that gather so
the same pipeline can serve features out-of-core through a ``HybridCache``
(AGL/GiGL-style feature stores) with zero change to batch contents:

    src = ArrayFeatureSource(g.vertex_feats)              # in-memory
    src = StoreFeatureSource.from_array(feats, workdir)   # disk-backed

Both yield bit-identical batches — the cache only changes WHERE rows come
from, never their values (property-tested in the JAX package's tests/test_storage.py).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.storage.hybrid import HybridCache, build_tiers
from repro_torch.core.storage.store import DFSTier

__all__ = [
    "ArrayFeatureSource",
    "FeatureSource",
    "StoreFeatureSource",
    "as_feature_source",
]


class FeatureSource:
    """Protocol-ish base: ``gather(rows) -> [len(rows), dim]`` float32."""

    dim: int
    num_rows: int
    dtype = np.float32

    def gather(self, rows: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def shape(self) -> tuple:
        """ndarray-compatible view so ``feats.shape[1]`` call sites work."""
        return (self.num_rows, self.dim)


class ArrayFeatureSource(FeatureSource):
    """Zero-copy wrapper over an in-memory feature matrix."""

    def __init__(self, feats: np.ndarray):
        self.feats = feats
        self.num_rows, self.dim = feats.shape
        self.dtype = feats.dtype

    def gather(self, rows: np.ndarray) -> np.ndarray:
        return self.feats[rows]

    def __repr__(self) -> str:
        return f"ArrayFeatureSource(shape={self.feats.shape})"


class StoreFeatureSource(FeatureSource):
    """Features served through a ``HybridCache`` over a chunked store —
    out-of-core training with the same tiered accounting as inference."""

    def __init__(self, cache: HybridCache):
        self.cache = cache
        self.num_rows = cache.store.num_rows
        self.dim = cache.store.dim
        self.dtype = cache.store.dtype

    @classmethod
    def from_array(
        cls,
        feats: np.ndarray,
        path: str,
        *,
        chunk_rows: int = 4096,
        tiers=("memory", "disk"),
        tier_capacities=(),
        policy="fifo",
        dynamic_frac: float = 0.10,
        compress: bool = False,
    ) -> "StoreFeatureSource":
        """Spill an in-memory matrix into a chunked store at ``path`` and
        wrap it in a fresh tier stack (the out-of-core migration helper).
        Disk tiers in the stack get a real spill directory under ``path``
        — without one an unbounded "disk" tier would keep every chunk it
        admits as a live ndarray, defeating the out-of-core point."""
        store = DFSTier(
            path,
            feats.shape[0],
            feats.shape[1],
            chunk_rows=chunk_rows,
            compress=compress,
            dtype=feats.dtype,
        )
        store.write_rows(np.arange(feats.shape[0], dtype=np.int64), feats)
        stack = build_tiers(
            tiers,
            chunk_rows,
            feats.shape[1],
            capacities=tier_capacities,
            dtype=feats.dtype,
            disk_path=path,
        )
        return cls(HybridCache(store, stack, policy=policy,
                               dynamic_frac=dynamic_frac))

    def gather(self, rows: np.ndarray) -> np.ndarray:
        return self.cache.read_rows(np.asarray(rows, dtype=np.int64))

    @property
    def stats(self):
        return self.cache.stats

    def __repr__(self) -> str:
        return f"StoreFeatureSource({self.cache!r})"


def as_feature_source(feats) -> FeatureSource:
    """ndarray -> ``ArrayFeatureSource``; a ``FeatureSource`` passes through."""
    if isinstance(feats, FeatureSource):
        return feats
    return ArrayFeatureSource(np.asarray(feats))
