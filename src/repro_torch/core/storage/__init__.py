"""repro.core.storage — the tiered storage subsystem (paper §III-D).

One pluggable ``HybridCache`` API for layer embeddings (inference) and
input features (training):

    DFSTier          authoritative chunked store (the Zarr-on-DFS stand-in)
    MemoryTier/DiskTier  bounded cache tiers above it (STORAGE_TIERS)
    CACHE_POLICIES   fifo | lru | locality eviction policies
    HybridCache      the ordered tier stack with plan_fill()/evict()
    FeatureSource    the training-side feature-fetch surface

A copy of ``repro.core.storage``.
"""
from repro_torch.core.storage.store import (
    ChunkCorruptionError,
    ChunkReadError,
    DFSTier,
    IOCost,
    StoreStats,
    block_checksum,
    chunk_runs,
)
from repro_torch.core.storage.tiers import (
    STORAGE_TIERS,
    DiskTier,
    MemoryTier,
    StorageTier,
    TierStats,
)
from repro_torch.core.storage.policies import (
    CACHE_POLICIES,
    EvictionPolicy,
    FifoPolicy,
    LocalityPolicy,
    LruPolicy,
    resolve_policy,
)
from repro_torch.core.storage.hybrid import FillPlan, HybridCache, HybridStats, build_tiers
from repro_torch.core.storage.features import (
    ArrayFeatureSource,
    FeatureSource,
    StoreFeatureSource,
    as_feature_source,
)

__all__ = [
    "ArrayFeatureSource",
    "CACHE_POLICIES",
    "ChunkCorruptionError",
    "ChunkReadError",
    "DFSTier",
    "DiskTier",
    "EvictionPolicy",
    "FeatureSource",
    "FifoPolicy",
    "FillPlan",
    "HybridCache",
    "HybridStats",
    "IOCost",
    "LocalityPolicy",
    "LruPolicy",
    "MemoryTier",
    "STORAGE_TIERS",
    "StorageTier",
    "StoreFeatureSource",
    "StoreStats",
    "TierStats",
    "as_feature_source",
    "block_checksum",
    "build_tiers",
    "chunk_runs",
    "resolve_policy",
]
