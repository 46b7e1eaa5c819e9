"""DEPRECATED module — the chunked store moved to ``repro_torch.core.storage``.

Copy of ``repro/core/inference/store.py`` (imports rewritten).

``ChunkedEmbeddingStore`` is now a thin alias of
:class:`repro_torch.core.storage.DFSTier` (same constructor, same files on disk,
same counters) kept for one release of deprecation, mirroring the
``backend.sample()`` playbook; ``IOCost`` and ``chunk_runs`` re-export from
their new home.  New call sites should import from ``repro_torch.core.storage``.
"""
from __future__ import annotations

from repro_torch.core.storage.store import DFSTier, IOCost, StoreStats, chunk_runs

__all__ = ["ChunkedEmbeddingStore", "IOCost", "StoreStats", "chunk_runs"]


class ChunkedEmbeddingStore(DFSTier):
    """DEPRECATED alias of :class:`repro_torch.core.storage.DFSTier`."""
