"""repro_torch.api — the port's GLISP system facade.

    from repro_torch.api import GLISPConfig, GLISPSystem

    system = GLISPSystem.build(graph, GLISPConfig(num_parts=4))
    trainer = system.train(model, train_ids, epochs=2)  # on the model's device
    system.infer_layerwise(model_layer_fns, workdir)   # device="cuda"
    server = system.server()
"""
from repro_torch.api.backends import (
    CACHE_POLICIES,
    PARTITIONERS,
    REORDERS,
    SAMPLERS,
    STORAGE_TIERS,
    EdgeCutBackend,
    GatherApplyBackend,
    Partitioner,
    PartitionPipeline,
    PartitionPlan,
    SamplerBackend,
)
from repro_torch.api.config import GLISPConfig
from repro_torch.api.pipeline import BatchPipeline
from repro_torch.api.system import GLISPSystem
from repro_torch.core.faults import (
    CircuitBreaker,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    RetryPolicy,
)
from repro_torch.core.sampling.service import (
    DEFAULT_DIRECTION,
    SampleRequest,
    SampleTicket,
    SampleTimeout,
    SamplingService,
    SamplingSpec,
)
from repro_torch.core.storage import (
    ArrayFeatureSource,
    DFSTier,
    FeatureSource,
    HybridCache,
    IOCost,
    StorageTier,
    StoreFeatureSource,
    as_feature_source,
)
from repro_torch.serve import GNNServer, ServeRequest, ServeResponse, ServeStats
from repro_torch.utils import Registry

__all__ = [
    "GLISPConfig",
    "GLISPSystem",
    "BatchPipeline",
    "Registry",
    "PartitionPlan",
    "Partitioner",
    "PartitionPipeline",
    "SamplerBackend",
    "GatherApplyBackend",
    "EdgeCutBackend",
    "SamplingSpec",
    "SampleRequest",
    "SampleTicket",
    "SampleTimeout",
    "SamplingService",
    "CircuitBreaker",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "RetryPolicy",
    "GNNServer",
    "ServeRequest",
    "ServeResponse",
    "ServeStats",
    "DFSTier",
    "HybridCache",
    "IOCost",
    "StorageTier",
    "FeatureSource",
    "ArrayFeatureSource",
    "StoreFeatureSource",
    "as_feature_source",
    "PARTITIONERS",
    "SAMPLERS",
    "REORDERS",
    "CACHE_POLICIES",
    "STORAGE_TIERS",
    "DEFAULT_DIRECTION",
]
