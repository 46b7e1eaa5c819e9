"""Decoder backbone: embedding -> layers -> norm -> tied head. Port of
``repro/models/transformer/model.py`` for the dense, MoE and SSM families
(attention or MLA mixers, gated or MoE MLPs, Mamba-2 and RG-LRU blocks).

Parameters are a plain dictionary: ``embed`` [Vp, d], ``final_norm`` [d],
(``head`` [d, Vp] when untied) and ``layers``, one dictionary per layer in
model order with the JAX package's keys (``norm1``, ``mixer``, ``norm2``,
``mlp``) and layouts. The JAX package stacks each stage's layers on a
leading ``[reps]`` axis (``stage_plan``); :func:`unstack_layers` maps that
to the port's list. Caches are one dictionary per layer too.

Dtypes: :func:`init_params` and :func:`load_jax_params` store a tensor
the JAX package only ever casts to the activation dtype before use (every
matrix, the embedding, the norm weights) in ``cfg.dtype``, cast once (the
bits of the reference's cast at every use); leaves it applies in float32 (Mamba-2's and RG-LRU's conv
taps, ``A_log``, ``D``, ``dt_bias``, RG-LRU's ``lam``) stay float32.

Three entry points share one :func:`forward`: training (no cache),
prefill (S > 1, cache) and decode (S == 1, cache). It returns the MoE
auxiliary loss beside the logits, as the JAX forward does. With
``remat=True`` (training) each layer runs under
``torch.utils.checkpoint``, the port of the reference's ``jax.checkpoint``
of its scanned body: its activations are recomputed in the backward (the
kernels' autograd Functions save their state again on that second run).
:func:`lm_loss` is the reference's training loss.

The forward casts every parameter to ``cfg.dtype`` at use, as the
reference does, so it takes float32 parameters too: the LM trainer keeps
float32 master weights, as the reference trainer does, and a bf16 config
then computes in bf16 on them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import (
    Params,
    attention_forward,
    dense_init,
    init_attention,
    init_mlp,
    mlp_forward,
    rms_norm,
)
from repro_torch.models.transformer.moe import init_moe, moe_forward
from repro_torch.models.transformer.ssm import (
    init_mamba2,
    init_rglru,
    mamba2_forward,
    rglru_forward,
)

__all__ = [
    "stage_plan",
    "init_params",
    "load_jax_params",
    "unstack_layers",
    "init_cache",
    "cache_len_for",
    "forward",
    "lm_loss",
    "param_count",
]

# leaves the JAX package applies in float32; every other leaf is stored in cfg.dtype
_FLOAT32_LEAVES = frozenset({"conv", "A_log", "D", "dt_bias", "lam"})


def stage_plan(cfg: ArchConfig) -> list[tuple[tuple[str, ...], int]]:
    """The JAX package's stages: ``(kinds of one period, repeats)``, then a
    trailing partial period as its own stage."""
    period = len(cfg.pattern)
    reps, rem = divmod(cfg.num_layers, period)
    stages: list[tuple[tuple[str, ...], int]] = []
    if reps:
        stages.append((tuple(cfg.pattern), reps))
    if rem:
        stages.append((tuple(cfg.pattern[:rem]), 1))
    return stages


def _has_mlp(kind: str) -> bool:
    return kind != "ssm"  # mamba blocks carry their own gating, no MLP


def _store(tree, dtype: torch.dtype, name: str = ""):
    """Cast every leaf to ``dtype``, except those in ``_FLOAT32_LEAVES``."""
    if isinstance(tree, dict):
        return {k: _store(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_store(v, dtype, name) for v in tree]
    return tree.to(torch.float32 if name in _FLOAT32_LEAVES else dtype)


def _init_layer(generator, cfg: ArchConfig, kind: str, device) -> Params:
    p: Params = {"norm1": torch.ones((cfg.d_model,), dtype=torch.float32, device=device)}
    if kind in ("attn", "local_attn"):
        p["mixer"] = init_attention(generator, cfg, device)
    elif kind == "ssm":
        p["mixer"] = init_mamba2(generator, cfg, device)
    elif kind == "rglru":
        p["mixer"] = init_rglru(generator, cfg, device)
    else:
        raise ValueError(kind)
    if _has_mlp(kind):
        p["norm2"] = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
        p["mlp"] = (
            init_moe(generator, cfg, device) if cfg.moe is not None
            else init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation, device)
        )
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters with the JAX package's scales (normal, 1/sqrt(fan
    in); embedding 0.02; norms 1), drawn from ``generator`` (which must live
    on ``device``) and stored as the module docstring says. The draws differ
    from ``jax.random``'s: parity tests load the JAX tree instead."""
    dev = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    params: Params = {
        "embed": dense_init(generator, (cfg.padded_vocab_size, cfg.d_model), scale=0.02,
                            device=dev).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab_size),
                                    device=dev).to(dtype)
    # cast layer by layer, so the float32 draws of one layer at a time coexist
    params["layers"] = [
        _store(_init_layer(generator, cfg, kind, dev), dtype) for kind in cfg.layer_kinds()
    ]
    return params


def unstack_layers(stages: list, cfg: ArchConfig) -> list:
    """The JAX package's per-stage trees (``stages[si][ki]``, every leaf
    with a leading ``[reps]`` axis; ``params["stages"]`` or a cache) as one
    tree per layer, in model order: layer ``r * period + ki`` of stage
    ``si`` is ``stages[si][ki]`` at index ``r``."""
    def take(tree, r):
        if isinstance(tree, dict):
            return {k: take(v, r) for k, v in tree.items()}
        return tree[r]

    layers = []
    for (kinds, reps), stage in zip(stage_plan(cfg), stages):
        for r in range(reps):
            layers.extend(take(stage[ki], r) for ki in range(len(kinds)))
    return layers


def load_jax_params(tree, cfg: ArchConfig, device="cuda") -> Params:
    """The port's parameters from the JAX package's ``init_params`` tree,
    its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``):
    ``embed``, ``final_norm`` and ``head`` as they are, ``stages`` through
    :func:`unstack_layers` into ``layers``; every leaf cast as the module
    docstring says."""
    dev = torch.device(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x), device=dev)  # a copy: JAX's arrays are read-only

    params = {k: conv(tree[k]) for k in ("embed", "final_norm", "head") if k in tree}
    params["layers"] = [conv(layer) for layer in unstack_layers(tree["stages"], cfg)]
    return _store(params, dtype)


def param_count(params: Params) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()

    return count(params)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def _init_layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device) -> Params:
    dtype = getattr(torch, cfg.dtype)
    if kind in ("attn", "local_attn"):
        if cfg.kv_lora_rank:  # MLA caches the latent and the shared RoPE key only
            return {
                "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
                "krope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype,
                                     device=device),
                "kpos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
                "pos": 0,
            }
        shape = (batch, max_len, cfg.padded_kv_heads, cfg.resolved_head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kpos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
            "pos": 0,
        }
    if kind == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        nh = s.num_heads or d_in // s.head_dim
        return {
            "state": torch.zeros((batch, nh, s.head_dim, s.state_dim), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * s.num_groups * s.state_dim),
                                dtype=dtype, device=device),
            "pos": 0,
        }
    if kind == "rglru":
        return {
            "state": torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, cfg.d_model), dtype=dtype, device=device),
            "pos": 0,
        }
    raise ValueError(kind)


def cache_len_for(cfg: ArchConfig, kind: str, seq_len: int) -> int:
    """Cache capacity per attention kind: local windows cap it; the
    long-context window variant caps full attention too."""
    if kind == "local_attn":
        return min(seq_len, cfg.local_window)
    if kind == "attn":
        if cfg.window > 0:
            return min(seq_len, cfg.window)
        return seq_len
    return 1  # ssm/rglru keep O(1) state; length unused


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> list:
    """One cache dictionary per layer, in model order (the JAX package's
    stacked caches through :func:`unstack_layers`); ``pos`` is a Python
    int, the next position to write."""
    dev = torch.device(device)
    return [
        _init_layer_cache(cfg, kind, batch, cache_len_for(cfg, kind, max_len), dev)
        for kind in cfg.layer_kinds()
    ]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer_forward(lp: Params, cfg: ArchConfig, kind: str, x, positions, cache):
    """Returns (x, new cache, the layer's MoE aux loss: a float32 scalar,
    None without experts)."""
    aux = None
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind in ("attn", "local_attn"):
        window = cfg.local_window if kind == "local_attn" else cfg.window
        y, new_cache = attention_forward(
            lp["mixer"], cfg, h, positions=positions, cache=cache, window=window
        )
    elif kind == "ssm":
        y, new_cache = mamba2_forward(lp["mixer"], cfg, h, cache=cache)
    elif kind == "rglru":
        y, new_cache = rglru_forward(lp["mixer"], cfg, h, cache=cache)
    else:
        raise ValueError(kind)
    x = (x + y).to(x.dtype)
    if _has_mlp(kind):
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if cfg.moe is not None:
            y, aux = moe_forward(lp["mlp"], cfg, h, cfg.activation)
        else:
            y = mlp_forward(lp["mlp"], h, cfg.activation)
        x = (x + y).to(x.dtype)
    return x, new_cache, aux


def _remat_layer(lp: Params, cfg: ArchConfig, kind: str, x, positions):
    x, _, aux = _layer_forward(lp, cfg, kind, x, positions, None)
    return x, aux


def forward(
    params: Params,
    cfg: ArchConfig,
    inputs: torch.Tensor,
    cache: list | None = None,
    pos: int = 0,
    *,
    last_only: bool = False,
    remat: bool = False,
):
    """Returns (logits [B, S, Vp] float32, or [B, 1, Vp] with
    ``last_only``; aux, the float32 sum of the MoE layers' load-balance
    losses (0.0 without experts); the new cache, or None without one), as
    the JAX forward does. ``inputs`` is int tokens [B, S], or embeddings
    [B, S, d] for ``input_mode == "embeddings"``. Logits of the padded
    vocabulary rows are -1e30. ``remat`` (no cache) recomputes each layer
    in the backward (``torch.utils.checkpoint``)."""
    if remat and cache is not None:
        raise ValueError("remat is for training, without a cache")
    dtype = getattr(torch, cfg.dtype)
    if cfg.input_mode == "tokens":
        x = params["embed"][inputs].to(dtype)
    else:
        x = inputs.to(dtype)
    b, s = x.shape[0], x.shape[1]
    positions = (pos + torch.arange(s, dtype=torch.int32, device=x.device))[None, :].expand(b, s)
    new_caches = [] if cache is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, kind in enumerate(cfg.layer_kinds()):
        if remat:
            x, aux = checkpoint(_remat_layer, params["layers"][li], cfg, kind, x, positions,
                                use_reentrant=False)
            nc = None
        else:
            x, nc, aux = _layer_forward(params["layers"][li], cfg, kind, x, positions,
                                        None if cache is None else cache[li])
        if aux is not None:
            aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = (x @ head.to(dtype)).float()
    if cfg.padded_vocab_size != cfg.vocab_size:  # mask padded vocab rows
        valid = torch.arange(cfg.padded_vocab_size, device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    return logits, aux_total, new_caches


class _LogitTerms(torch.autograd.Function):
    """(logsumexp of the logits over the vocabulary, the targets' logits),
    as ``torch.logsumexp`` and ``torch.gather`` give them, with the same
    gradient, exp(logits - logsumexp) times its gradient plus the target
    logit's gradient at its index, built in one logits-sized buffer: their
    autograd holds three or four such temporaries, 4.2 GB each in float32
    at 4,096 tokens of a 256,000-word vocabulary."""

    @staticmethod
    def forward(ctx, logits, targets):
        logz = torch.logsumexp(logits, dim=-1)
        ctx.save_for_backward(logits, logz, targets)
        return logz, torch.gather(logits, -1, targets[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g_logz, g_tgt):
        logits, logz, targets = ctx.saved_tensors
        grad = torch.sub(logits, logz[..., None]).exp_().mul_(g_logz[..., None])
        return grad.scatter_add_(-1, targets[..., None], g_tgt[..., None]), None


def lm_loss(
    params: Params,
    cfg: ArchConfig,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    *,
    remat: bool = True,
    z_loss: float = 1e-4,
):
    """The reference's training loss (``repro/models/transformer/model.py::
    lm_loss``): the mean NLL of ``targets`` [B, S] under the forward's
    logits (from ``logsumexp`` and the target logit), plus the MoE aux
    loss, plus ``z_loss`` times the mean squared ``logsumexp``. Returns
    (loss, (nll, aux))."""
    logits, aux, _ = forward(params, cfg, inputs, remat=remat)
    logz, tgt_logit = _LogitTerms.apply(logits, targets.long())
    nll = (logz - tgt_logit).mean()
    return nll + aux + z_loss * torch.square(logz).mean(), (nll, aux)
