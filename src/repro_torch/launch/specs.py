"""Assigned input shapes and the prefill / decode step functions. Port of
``repro/launch/specs.py`` for one card: the TPU mesh's tensor-parallel head
padding (``pad_heads_for_mesh``) and the abstract-shape helpers of the dry
run have no counterpart here."""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import forward

__all__ = ["SHAPES", "resolve_config", "make_prefill_step", "make_decode_step"]

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def resolve_config(cfg: ArchConfig, shape_name: str, model_axis: int = 0) -> ArchConfig | None:
    """Apply the long-context strategy: ``long_500k`` gives dense archs
    their windowed-KV variant; None means the combination is skipped.
    ``model_axis > 1`` (tensor-parallel head padding for a TPU mesh)
    raises: one card has no model axis."""
    if model_axis > 1:
        raise NotImplementedError(
            "tensor-parallel head padding (pad_heads_for_mesh) has no single-card counterpart"
        )
    if shape_name == "long_500k":
        if cfg.long_context == "window":
            cfg = dataclasses.replace(cfg, window=cfg.long_context_window)
        elif cfg.long_context != "native":
            return None  # "skip"
    return cfg


def make_prefill_step(cfg: ArchConfig):
    """``prefill(params, cache, batch) -> (last logits [B, Vp], cache)``
    with ``batch = {"inputs": [B, S] tokens}``, from position 0."""
    def prefill(params, cache, batch):
        logits, _, cache = forward(params, cfg, batch["inputs"], cache, 0, last_only=True)
        return logits[:, -1], cache

    return prefill


def make_decode_step(cfg: ArchConfig):
    """``decode(params, cache, batch, pos) -> (logits [B, Vp], cache)`` for
    one new token per row at absolute position ``pos``."""
    def decode(params, cache, batch, pos):
        logits, _, cache = forward(params, cfg, batch["inputs"], cache, pos)
        return logits[:, -1], cache

    return decode
