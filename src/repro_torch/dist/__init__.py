"""``repro_torch.dist`` — sampling servers behind a real transport.

The in-process :class:`~repro_torch.core.sampling.service.SamplingService`
simulates GLISP's distributed sampling tier; this package makes it real:
:mod:`~repro_torch.dist.transport` is the versioned wire format and channel
layer, :mod:`~repro_torch.dist.worker` hosts one partition's server replicas in
its own OS process, and :mod:`~repro_torch.dist.client` is the
:class:`WorkerPool` the service dispatches through when
``GLISPConfig(dist_transport="mp"|"socket")`` is set.

The PR 3 keyed-randomness design makes the split free of semantic drift:
every dispatch's RNG is derived from ``(seed, request key, hop, server,
chunk)``, so remote mode is bit-identical to in-process mode — the
determinism tests assert it.

A copy of the JAX package's ``repro.dist`` with only its imports
rewritten: numpy and multiprocessing, no torch, so a worker forked from a
process with a live CUDA context touches no CUDA state. Its frames are
byte for byte the reference's (``PROTOCOL_VERSION`` 1).
"""
from repro_torch.dist.client import WorkerPool
from repro_torch.dist.transport import (
    PROTOCOL_VERSION,
    ChannelClosed,
    DispatchResult,
    ProtocolError,
    SampleDispatch,
    TruncatedFrame,
    VersionMismatch,
)
from repro_torch.dist.worker import WorkerHost

__all__ = [
    "PROTOCOL_VERSION",
    "ChannelClosed",
    "DispatchResult",
    "ProtocolError",
    "SampleDispatch",
    "TruncatedFrame",
    "VersionMismatch",
    "WorkerHost",
    "WorkerPool",
]
