from repro_torch.core.inference.engine import (
    CacheStats,
    InferenceResult,
    LayerStats,
    LayerwiseInferenceEngine,
    assign_inference_owners,
    csr_gather,
)

__all__ = [
    "CacheStats",
    "InferenceResult",
    "LayerStats",
    "LayerwiseInferenceEngine",
    "assign_inference_owners",
    "csr_gather",
]
