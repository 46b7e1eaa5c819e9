from repro_torch.core.inference.store import ChunkedEmbeddingStore, IOCost
from repro_torch.core.inference.cache import TwoLevelCache, CachePolicy, CacheStats
from repro_torch.core.inference.engine import (
    InferenceResult,
    LayerStats,
    LayerwiseInferenceEngine,
    samplewise_inference,
    assign_inference_owners,
    csr_gather,
)
# the tiered storage subsystem these shims delegate to
from repro_torch.core.storage import (
    DFSTier,
    FeatureSource,
    HybridCache,
    StorageTier,
    TierStats,
)

__all__ = [
    "ChunkedEmbeddingStore",
    "IOCost",
    "TwoLevelCache",
    "CachePolicy",
    "CacheStats",
    "DFSTier",
    "FeatureSource",
    "HybridCache",
    "StorageTier",
    "TierStats",
    "InferenceResult",
    "LayerStats",
    "LayerwiseInferenceEngine",
    "samplewise_inference",
    "assign_inference_owners",
    "csr_gather",
]
