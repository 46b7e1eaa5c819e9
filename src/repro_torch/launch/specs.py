"""Assigned input shapes, their stand-in inputs, the parameter, optimizer
and cache trees without storage, and the step functions (train / prefill /
decode) shared by the dry run and the serving launcher. Port of
``repro/launch/specs.py``.

The stand-ins are tensors on the ``meta`` device (or, on ``device="cpu"``
inside a ``FakeTensorMode``, fake CPU tensors): shapes and dtypes with no
storage, where the reference uses ``jax.eval_shape``. The parameter tree
is float32, as the reference's ``init_params`` makes it (every matrix is
cast to ``cfg.dtype`` at use).

The reference's ``unroll`` (unroll the layer scans so that XLA's cost
analysis counts every layer) has no counterpart: the port runs its layers
one by one in eager PyTorch, so there is no scan to unroll.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import forward, init_cache, init_params, lm_loss
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_map

__all__ = [
    "SHAPES",
    "resolve_config",
    "pad_heads_for_mesh",
    "input_specs",
    "params_shapes",
    "opt_shapes",
    "cache_shapes",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
]

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def resolve_config(cfg: ArchConfig, shape_name: str, model_axis: int = 0) -> ArchConfig | None:
    """Apply the long-context strategy (``long_500k`` gives dense archs
    their windowed-KV variant) and, for a mesh model axis of
    ``model_axis > 1``, head padding for clean tensor-parallel tiling; None
    means the combination is skipped."""
    if shape_name == "long_500k":
        if cfg.long_context == "window":
            cfg = dataclasses.replace(cfg, window=cfg.long_context_window)
        elif cfg.long_context != "native":
            return None  # "skip"
    if model_axis > 1:
        # head padding pays off where full-sequence attention runs; decode's
        # grouped path has tiny scores, and padded kv would inflate the cache
        pad_ok = SHAPES[shape_name]["kind"] in ("train", "prefill")
        cfg = pad_heads_for_mesh(cfg, model_axis, enable_padding=pad_ok)
    return cfg


def pad_heads_for_mesh(cfg: ArchConfig, msize: int, enable_padding: bool = True) -> ArchConfig:
    """Resolve head padding and the GQA mode for an ``msize``-way
    tensor-parallel axis.

    The attention products stay free of collectives iff either (group
    mode) the kv-head dim itself shards ``msize`` ways, or (repeat mode) kv
    is replicated and the padded q heads shard as whole heads. Candidates,
    the fewest padded heads winning:
      (a) pad kv heads to msize           (group mode, kv sharded)
      (b) pad GQA groups to msize         (group mode, kv replicated)
      (c) pad q heads to lcm(msize, hkv)  (repeat mode, kv replicated)
    Past 1.5 times the real heads, or with ``enable_padding`` false, no
    padding. Dead heads are sliced away before ``wo``."""
    if cfg.kv_lora_rank or not cfg.num_heads:
        return dataclasses.replace(cfg, tp_size=msize)
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    g = h // hkv

    def ru(a, b):
        return -(-a // b) * b

    hkv_a = ru(hkv, msize)
    cands = [
        (hkv_a * g, hkv_a),  # (a)
        (hkv * ru(g, msize), hkv),  # (b)
        (ru(h, math.lcm(msize, hkv)), hkv),  # (c)
    ]
    h_pad, hkv_pad = min(cands)
    if (h_pad == h and hkv_pad == hkv) or not enable_padding or h_pad > 1.5 * h:
        return dataclasses.replace(cfg, tp_size=msize)
    return dataclasses.replace(cfg, q_head_pad=h_pad, kv_head_pad=hkv_pad, tp_size=msize)


def input_specs(cfg: ArchConfig, shape: str | dict, device="meta"):
    """Stand-ins for the inputs of ``shape`` (a name in ``SHAPES`` or a dict
    with ``seq``, ``batch`` and ``kind``): int32 tokens, or bf16 embeddings
    of width d_model for the vlm/audio stubs (``input_mode ==
    "embeddings"``); decode feeds one new token."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    b, s, kind = sh["batch"], sh["seq"], sh["kind"]

    def tok(bb, ss):
        return torch.empty((bb, ss), dtype=torch.int32, device=device)

    def emb(bb, ss):
        return torch.empty((bb, ss, cfg.d_model), dtype=torch.bfloat16, device=device)

    make = emb if cfg.input_mode == "embeddings" else tok
    if kind == "train":
        return {"inputs": make(b, s), "targets": tok(b, s)}
    if kind == "prefill":
        return {"inputs": make(b, s)}
    return {"inputs": make(b, 1)}


def _empty_like(tree, device):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def params_shapes(cfg: ArchConfig, device="meta"):
    """The parameter tree of ``init_params``, every leaf float32 as the
    reference keeps it."""
    tree = init_params(dataclasses.replace(cfg, dtype="float32"), torch.Generator(), device="meta")
    return _empty_like(tree, device)


def opt_shapes(cfg: ArchConfig, device="meta"):
    return _empty_like(adamw_init(params_shapes(cfg)), device)


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int, device="meta"):
    cache = init_cache(cfg, batch, max_len, device="meta")
    return [{k: v if isinstance(v, int) else torch.empty(v.shape, dtype=v.dtype, device=device)
             for k, v in layer.items()} for layer in cache]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None, remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``lm_loss`` (each layer recomputed in the backward with
    ``remat``), its gradients, one AdamW step; metrics ``loss``, ``nll``,
    ``aux``, ``lr`` and ``grad_norm``, the reference's keys. The params and
    moments are updated in place and returned."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, (nll, aux) = lm_loss(params, cfg, batch["inputs"], batch["targets"], remat=remat)
        found = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves, allow_unused=True)))
        grads = tree_map(lambda p: _like(p, found[id(p)]), params)
        params, opt_state, info = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), "nll": nll.detach(),
                                   "aux": aux.detach(), **info}

    return train_step


def _like(p, g):
    """``p``'s gradient ``g`` (zeros for None) in ``p``'s layout: on a mesh,
    redistributed to the parameter's placements, as the reference's step
    keeps its gradients in the parameters' shardings (a partial sum over
    the data axes becomes a reduce-scatter)."""
    if g is None:
        return torch.zeros_like(p)
    if hasattr(p, "device_mesh") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
