"""String-keyed component registries: partitioners, sampler backends, reorder
algorithms, cache policies, storage tiers.

Counterpart of ``repro/api/registry.py``: the class lives in
``repro_torch.utils`` (dependency-free, so core subsystems such as the
``repro_torch.core.storage`` cache-policy registry define registries
without importing the API package); this module is the canonical public
import path. Unknown names raise ``ValueError`` listing what is
registered.
"""
from __future__ import annotations

from repro_torch.utils import Registry

__all__ = ["Registry"]
