"""Transformer building blocks: norms, RoPE, attention (GQA/MQA, MLA,
sliding-window, KV cache), gated MLPs. Port of
``repro/models/transformer/layers.py``.

Attention dispatch follows the tensors' device:
  * CUDA — every full-sequence attention (prefill, and training forward
    and backward) goes through the hand-written flash-attention kernels
    (``kernels.ops.mha_attention``), MLA's too (q and k 192 wide, v 128);
  * CPU — the plain paths of the JAX package: dense masked attention, or
    blockwise online-softmax attention past ``BLOCKWISE_THRESHOLD`` keys.
Decode (one query against the cache) is plain tensor code on both, as the
JAX package leaves it to XLA.

Weights: ``mm`` casts the weight to the activation dtype, as the JAX
package does; the port's parameters are stored in that dtype already
(``model.init_params`` / ``model.load_jax_params`` cast once at load), so
the cast is a no-op and gives the same bits.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import mha_attention
from repro_torch.models.transformer.config import ArchConfig

__all__ = [
    "BLOCKWISE_THRESHOLD",
    "Params",
    "mm",
    "dense_init",
    "rms_norm",
    "rope_freqs",
    "apply_rope",
    "attention_core",
    "init_attention",
    "attention_forward",
    "init_mla",
    "mla_forward",
    "init_mlp",
    "gelu",
    "mlp_forward",
]

BLOCKWISE_THRESHOLD = 4096
_BLOCK = 1024
_NEG_INF = -1e30

Params = dict[str, Any]


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul with the weight cast to the activation dtype."""
    return x @ w.to(x.dtype)


def dense_init(generator: torch.Generator, shape, scale: float | None = None, *, device=None):
    """Normal(0, scale) float32, scale 1/sqrt(fan_in) by default."""
    scale = scale if scale is not None else (1.0 / shape[0]) ** 0.5
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, 1.0, generator=generator).mul_(scale)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The variance in float32, then x * rsqrt(var + eps) * w in x's dtype
    (times ``w``, not ``1 + w``)."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] absolute positions. Rotates the
    two halves of the head (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    mask = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def _dense_attention(q, k, v, *, causal, window, q_offset):
    """q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] with Hkv | H, in grouped
    einsums (no repeat of the KV heads). Scores in q's dtype, then float32
    softmax; P is rounded to q's dtype before P.V."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k).float() / (d**0.5)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    s = torch.where(_mask(q_pos, k_pos, causal, window), s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(b, sq, h, v.shape[-1])


def _blockwise_attention(q, k, v, *, causal, window, q_offset):
    """Online softmax over KV blocks of ``_BLOCK`` keys in float32 (the
    flash-style memory footprint for long sequences)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dv = v.shape[-1]
    qf = q.reshape(b, sq, hkv, g, d).float() / (d**0.5)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    o = q.new_zeros((b, hkv, g, sq, dv), dtype=torch.float32)
    m = torch.full((b, hkv, g, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)  # noqa: E741
    for start in range(0, skv, _BLOCK):
        kblk = k[:, start:start + _BLOCK].float()
        vblk = v[:, start:start + _BLOCK].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk)
        k_pos = start + torch.arange(kblk.shape[1], device=q.device)
        s = torch.where(_mask(q_pos[:, None], k_pos[None, :], causal, window), s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vblk)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def attention_core(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full-sequence attention, q [B, Sq, H, D] over k, v [B, Skv, Hkv, D]:
    the flash-attention kernel on the card, the plain paths on the CPU."""
    if q.device.type == "cuda":
        return mha_attention(q, k, v, causal=causal, window=window, kv_offset=q_offset)
    if k.shape[1] > BLOCKWISE_THRESHOLD:
        return _blockwise_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return _dense_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def _no_head_padding(cfg: ArchConfig) -> None:
    if cfg.padded_q_heads != cfg.num_heads or cfg.padded_kv_heads != cfg.num_kv_heads:
        raise NotImplementedError(
            "tensor-parallel head padding (q_head_pad/kv_head_pad) has no single-card "
            "counterpart"
        )


def init_attention(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    if cfg.kv_lora_rank:
        return init_mla(generator, cfg, device)
    _no_head_padding(cfg)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(generator, (d, h * dh), device=device),
        "wk": dense_init(generator, (d, hkv * dh), device=device),
        "wv": dense_init(generator, (d, hkv * dh), device=device),
        "wo": dense_init(generator, (h * dh, d), device=device),
    }


def _decode_attention(q, k_all, v_all, kpos, pos, window):
    """Dense attention with an explicit key-position mask, for decode
    where the cache may be a rolling window buffer (slot order is not
    position order). q: [B, 1, H, D]; k_all/v_all: [B, L, Hkv, D]; kpos:
    [L] int32 absolute positions (-1 = empty slot)."""
    b, sq, h, d = q.shape
    hkv = k_all.shape[2]
    q5 = q.reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k_all).float() / (d**0.5)
    mask = (kpos >= 0) & (kpos <= pos)
    if window > 0:
        mask &= kpos > pos - window
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_all)
    return o.reshape(b, sq, h, v_all.shape[-1])


def _cache_write(cache_tensor, new, pos: int, rolling_len: int):
    """Write S new rows at rolling positions (pos..pos+S-1) mod L along
    axis 1; returns the cache.

    S == 1 (decode): one row at pos % L, in place.
    S >= L (prefill past a window cache): the last L tokens replace the
        whole buffer (a new tensor), rolled so slot p % L holds position p
        (no roll when S is a multiple of L).
    1 < S < L (prefill into a fresh cache): rows pos..pos+S-1, in place
        (convention: pos + S <= L).
    In place where the JAX package returns an updated copy: the caller
    hands the old cache over and never reads it again."""
    s = new.shape[1]
    L = rolling_len
    new = new.to(cache_tensor.dtype)
    if s == 1:
        cache_tensor[:, pos % L] = new[:, 0]
        return cache_tensor
    if s >= L:
        last = new[:, -L:]
        if s % L == 0:
            return last.clone()
        return torch.roll(last, shifts=(pos + s - L) % L, dims=1)
    cache_tensor[:, pos:pos + s] = new
    return cache_tensor


def _kpos_write(kpos, pos: int, s: int, rolling_len: int):
    """The absolute position held by each cache slot after
    :func:`_cache_write` (same branches, same in-place rule)."""
    L = rolling_len
    if s == 1:
        kpos[pos % L] = pos
        return kpos
    if s >= L:
        pstart = pos + s - L
        fresh = pstart + torch.arange(L, dtype=kpos.dtype, device=kpos.device)
        if s % L == 0:
            return fresh
        return torch.roll(fresh, shifts=pstart % L)
    kpos[pos:pos + s] = pos + torch.arange(s, dtype=kpos.dtype, device=kpos.device)
    return kpos


def attention_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, d]
    *,
    positions: torch.Tensor,  # [B, S] absolute positions of x's tokens
    cache: Params | None = None,  # {"k","v": [B,L,Hkv,Dh], "kpos": [L], "pos": int}
    window: int = 0,
):
    """Returns (y [B, S, d], new cache or None)."""
    if cfg.kv_lora_rank:
        return mla_forward(p, cfg, x, positions=positions, cache=cache, window=window)
    _no_head_padding(cfg)
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    q = apply_rope(mm(x, p["wq"]).reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(mm(x, p["wk"]).reshape(b, s, hkv, dh), positions, cfg.rope_theta)
    v = mm(x, p["wv"]).reshape(b, s, hkv, dh)

    def project_out(o):
        return mm(o.reshape(b, s, h * dh), p["wo"]).to(x.dtype)

    if cache is None:  # full-sequence causal (+ optional sliding window)
        return project_out(attention_core(q, k, v, causal=True, window=window)), None

    L = cache["k"].shape[1]
    pos = cache["pos"]
    ck = _cache_write(cache["k"], k, pos, L)
    cv = _cache_write(cache["v"], v, pos, L)
    kpos = _kpos_write(cache["kpos"], pos, s, L)
    new_cache = {"k": ck, "v": cv, "kpos": kpos, "pos": pos + s}
    if s > 1:
        # prefill (pos == 0 by convention): attend over the fresh k/v
        o = attention_core(q, k, v, causal=True, window=window)
    else:
        o = _decode_attention(q, ck, cv, kpos, pos, window)
    return project_out(o), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """``wq`` [d, H (dh + rd)] (each head: a dh-wide part and a RoPE'd
    rd-wide tail), ``w_dkv`` [d, r] to the latent, ``w_krope`` [d, rd] the
    shared RoPE key, ``w_uk``/``w_uv`` [r, H dh] the latent's expansion,
    ``wo`` [H dh, d]."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, r, rd = cfg.num_heads, cfg.kv_lora_rank, cfg.rope_head_dim
    return {
        "wq": dense_init(generator, (d, h * (dh + rd)), device=device),
        "w_dkv": dense_init(generator, (d, r), device=device),
        "w_krope": dense_init(generator, (d, rd), device=device),
        "w_uk": dense_init(generator, (r, h * dh), device=device),
        "w_uv": dense_init(generator, (r, h * dh), device=device),
        "wo": dense_init(generator, (h * dh, d), device=device),
    }


def mla_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, d]
    *,
    positions: torch.Tensor,
    cache: Params | None = None,  # {"ckv": [B,L,r], "krope": [B,L,rd], "kpos": [L], "pos": int}
    window: int = 0,
):
    """Returns (y [B, S, d], new cache or None). Only the latent ``ckv``
    and the RoPE'd shared key ``krope`` are cached; keys and values are
    expanded from them through ``w_uk``/``w_uv`` (the whole cache at each
    decode step, as the reference does). Prefill attends over the fresh
    expansion (the flash kernel on the card, q and k of width dh + rd, v of
    width dh); decode uses :func:`_decode_attention`."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    rd = cfg.rope_head_dim
    q = mm(x, p["wq"]).reshape(b, s, h, dh + rd)
    q_rope = apply_rope(q[..., dh:], positions, cfg.rope_theta)
    qh = torch.cat([q[..., :dh], q_rope], dim=-1)
    ckv = mm(x, p["w_dkv"])  # [B, S, r]
    krope = apply_rope(mm(x, p["w_krope"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    def expand_kv(ckv_all, krope_all):
        skv = ckv_all.shape[1]
        k_nope = mm(ckv_all, p["w_uk"]).reshape(b, skv, h, dh)
        v = mm(ckv_all, p["w_uv"]).reshape(b, skv, h, dh)
        k_rope = krope_all[:, :, None, :].expand(b, skv, h, rd).to(k_nope.dtype)
        return torch.cat([k_nope, k_rope], dim=-1), v

    def project_out(o):
        return mm(o.reshape(b, s, h * dh), p["wo"]).to(x.dtype)

    if cache is None:
        k, v = expand_kv(ckv, krope)
        return project_out(attention_core(qh, k, v, causal=True, window=window)), None

    L = cache["ckv"].shape[1]
    pos = cache["pos"]
    c_ckv = _cache_write(cache["ckv"], ckv, pos, L)
    c_kr = _cache_write(cache["krope"], krope, pos, L)
    kpos = _kpos_write(cache["kpos"], pos, s, L)
    new_cache = {"ckv": c_ckv, "krope": c_kr, "kpos": kpos, "pos": pos + s}
    if s > 1:  # prefill: attend over the fresh expansion
        k, v = expand_kv(ckv, krope)
        o = attention_core(qh, k, v, causal=True, window=window)
    else:
        k, v = expand_kv(c_ckv, c_kr)
        o = _decode_attention(qh, k, v, kpos, pos, window)
    return project_out(o), new_cache


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------


def init_mlp(
    generator: torch.Generator, d: int, d_ff: int, activation: str = "swiglu", device=None
) -> Params:
    if activation == "gelu":  # plain 2-proj MLP (gpt-style)
        return {
            "w_up": dense_init(generator, (d, d_ff), device=device),
            "w_down": dense_init(generator, (d_ff, d), device=device),
        }
    return {
        "w_gate": dense_init(generator, (d, d_ff), device=device),
        "w_up": dense_init(generator, (d, d_ff), device=device),
        "w_down": dense_init(generator, (d_ff, d), device=device),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def mlp_forward(p: Params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    if activation == "gelu":
        return mm(gelu(mm(x, p["w_up"])), p["w_down"]).to(x.dtype)
    gate = mm(x, p["w_gate"])
    act = F.silu(gate) if activation == "swiglu" else gelu(gate)
    return mm(act * mm(x, p["w_up"]), p["w_down"]).to(x.dtype)
