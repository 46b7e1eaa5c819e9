"""``repro.serve`` — online GNN inference serving.

The serving tier answers "embed these vertices now" requests over a
completed layerwise inference run: bounded admission, continuous batching
into the engine's compiled shape buckets, per-request deadlines, and
SLO-grade metrics.  Construct via ``GLISPSystem.server()``.
"""
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import ServeRequest, ServeResponse
from repro_torch.serve.server import GNNServer
from repro_torch.serve.stats import LatencyEstimator, P2Quantile, ServeStats

__all__ = [
    "ContinuousBatcher",
    "GNNServer",
    "LatencyEstimator",
    "P2Quantile",
    "RequestQueue",
    "ServeRequest",
    "ServeResponse",
    "ServeStats",
]
