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

import math
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
    "tiled",
    "reshaped",
    "mesh_axes",
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
    """Matmul with the weight cast to the activation dtype. A DTensor
    whose leading dims are sharded on more than one dim (a cache sharded
    on batch and sequence) goes through :func:`_rowwise_mm`."""
    if hasattr(x, "device_mesh") and _leading_dims_sharded(x) > 1:
        return _rowwise_mm(x, w)
    return x @ w.to(x.dtype)


def _leading_dims_sharded(x) -> int:
    """How many distinct dims of ``x`` other than the last are sharded."""
    from torch.distributed.tensor import Shard

    return len({pl.dim % x.ndim for pl in x.placements if isinstance(pl, Shard)} - {x.ndim - 1})


def _rowwise_mm(x, w):
    """``x @ w`` for a DTensor ``x`` whose rows are sharded on several
    leading dims: the weight is replicated (an explicit redistribution,
    recorded like any other) and each device multiplies its own rows, the
    result keeping ``x``'s placements; the weight's gradient is a partial
    sum over the axes that shard ``x``. DTensor's matmul flattens the
    leading dims first, and PyTorch 2.11 refuses that flatten of a dim
    sharded after the first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pls = x.device_mesh, list(x.placements)
    rep = [Replicate()] * mesh.ndim
    w_grad = [Partial() if isinstance(pl, Shard) else Replicate() for pl in pls]
    w = w.to(x.dtype)
    w = w.redistribute(mesh, rep) if hasattr(w, "device_mesh") else w
    return local_map(lambda xl, wl: xl @ wl, out_placements=pls, in_placements=(pls, rep),
                     in_grad_placements=(pls, w_grad), device_mesh=mesh)(x, w)


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


def tiled(t: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``t``, ready for a reshape that splits its dim ``dim`` into
    ``lead`` blocks (heads). A plain tensor is returned as it is. A DTensor
    sharded on ``dim`` over mesh axes whose size does not divide ``lead``
    (a flat split that lands inside a head) is first unsharded on those
    axes: the all-gather that GSPMD inserts for such a reshape in the
    reference, issued here explicitly so that the dry run records it
    (DTensor refuses the uneven reshape)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    sharded = [i for i, pl in enumerate(t.placements) if isinstance(pl, Shard) and pl.dim == dim]
    if lead % math.prod(mesh.size(i) for i in sharded) == 0:
        return t
    return t.redistribute(mesh, [Replicate() if i in sharded else pl
                                 for i, pl in enumerate(t.placements)])


class _Reshape(torch.autograd.Function):
    """A DTensor's reshape whose backward first brings the gradient to the
    placements the forward's result had, then reshapes it back."""

    @staticmethod
    def forward(ctx, t, shape):
        from torch.distributed.tensor import Partial, Replicate

        out = t.reshape(shape)
        # a partial sum's gradient is replicated
        ctx.in_shape = t.shape
        ctx.placements = tuple(Replicate() if isinstance(pl, Partial) else pl
                               for pl in out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.reshape(ctx.in_shape), None


def reshaped(t: torch.Tensor, shape) -> torch.Tensor:
    """``t.reshape(shape)``. On a DTensor, the backward's reshape of the
    gradient runs in the layout of the forward's result, so that a split the
    gradient's own sharding would cut unevenly (inside a head, or a dim
    sharded over two mesh axes) is not attempted. A plain tensor is
    reshaped as it is."""
    if not hasattr(t, "device_mesh"):
        return t.reshape(shape)
    return _Reshape.apply(t, tuple(shape))


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


def mesh_axes(mesh, batch: int):
    """(the ``model`` axis's index, the placement on every other axis of a
    batch of ``batch`` rows): Shard(0) when the data axes divide the batch,
    else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    model = names.index("model")
    data = math.prod(mesh.size(i) for i, n in enumerate(names) if n != "model")
    return model, Shard(0) if batch % data == 0 else Replicate()


def _sharded_attention(q, k, v, core=None, extra=(), **kw):
    """Attention on DTensors, each device attending its own batch rows and
    heads through ``local_map``, as GSPMD runs head-sharded attention (no
    collective), where DTensor would reshard the products' merged batch and
    head dims (and PyTorch 2.11 refuses to flatten them). q, k and v are
    first placed as the sharding rules lay them out: the batch over the data
    axes (when it divides them), q's heads over ``model`` when they divide
    it, k's and v's when theirs do, else replicated there (an explicit
    redistribution, recorded like any other). Each device then takes the kv
    heads its q heads read; with kv replicated and q sharded, kv's gradient
    is a partial sum over ``model``. ``core(q, k, v, *extra, **kw)`` runs
    per device (default :func:`attention_core`); the tensors of ``extra``
    (decode's key positions) are replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    h, hkv = q.shape[2], k.shape[2]
    model, on_batch = mesh_axes(mesh, q.shape[0])

    def layout(heads):
        return [Shard(2) if i == model and heads % mesh.size(model) == 0
                else (Replicate() if i == model else on_batch) for i in range(mesh.ndim)]

    qp, kp = layout(h), layout(hkv)
    q = q.redistribute(mesh, qp)
    k, v = k.redistribute(mesh, kp), v.redistribute(mesh, kp)
    q_only = qp[model] != kp[model]  # q's heads sharded, kv's replicated
    kv_grad = [Partial() if i == model and q_only else pl for i, pl in enumerate(kp)]
    rep = [Replicate()] * mesh.ndim
    extra = [e.redistribute(mesh, rep) if hasattr(e, "device_mesh") else e for e in extra]
    extra_pl = tuple(rep if hasattr(e, "device_mesh") else None for e in extra)

    def local(ql, kl, vl, *el):
        if q_only:  # kl holds every kv head: take those this device's q heads read
            g = h // hkv
            first = mesh.get_local_rank(model) * ql.shape[2]
            lo, hi = first // g, (first + ql.shape[2] - 1) // g + 1
            if (first % g == 0 and ql.shape[2] % g == 0) or hi - lo == 1:
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]  # whole groups
            else:  # q heads that split kv groups: each q head's own kv head
                idx = (first + torch.arange(ql.shape[2], device=ql.device)) // g
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return (core or attention_core)(ql, kl, vl, *el, **kw)

    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp) + extra_pl,
                     in_grad_placements=(qp, kv_grad, kv_grad) + extra_pl,
                     device_mesh=mesh)(q, k, v, *extra)


def attention_core(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full-sequence attention, q [B, Sq, H, D] over k, v [B, Skv, Hkv, D]:
    the flash-attention kernel on the card, the plain paths on the CPU
    (on DTensors, each device's part through :func:`_sharded_attention`)."""
    if hasattr(q, "device_mesh"):
        return _sharded_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cuda":
        return mha_attention(q, k, v, causal=causal, window=window, kv_offset=q_offset)
    if k.shape[1] > BLOCKWISE_THRESHOLD:
        return _blockwise_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return _dense_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """``wq`` [d, Hp Dh] and ``wk``/``wv`` [d, Hkvp Dh] over the padded
    heads (``cfg.padded_q_heads`` / ``padded_kv_heads``, the real counts
    without padding), ``wo`` [H Dh, d] over the real heads only."""
    if cfg.kv_lora_rank:
        return init_mla(generator, cfg, device)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.padded_q_heads, cfg.padded_kv_heads
    return {
        "wq": dense_init(generator, (d, h * dh), device=device),
        "wk": dense_init(generator, (d, hkv * dh), device=device),
        "wv": dense_init(generator, (d, hkv * dh), device=device),
        "wo": dense_init(generator, (cfg.num_heads * dh, d), device=device),
    }


def _decode_attention(q, k_all, v_all, kpos, pos, window):
    """Dense attention with an explicit key-position mask, for decode
    where the cache may be a rolling window buffer (slot order is not
    position order). q: [B, 1, H, D]; k_all/v_all: [B, L, Hkv, D]; kpos:
    [L] int32 absolute positions (-1 = empty slot). On DTensors each device
    attends its own batch rows: over its own heads (:func:`_sharded_attention`),
    or, with the cache sharded on its sequence, over its own keys
    (:func:`_split_decode_attention`)."""
    if hasattr(q, "device_mesh"):
        if _seq_sharded(k_all):
            return _split_decode_attention(q, k_all, v_all, kpos, pos, window)
        return _sharded_attention(
            q, k_all, v_all, lambda ql, kl, vl, kp: _decode_attention(ql, kl, vl, kp, pos, window),
            extra=(kpos,))
    b, sq, h, _ = q.shape
    s = _decode_scores(q, k_all, kpos, pos, window)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_all)
    return reshaped(o, (b, sq, h, v_all.shape[-1]))


def _decode_scores(q, k_all, kpos, pos, window):
    """Masked float32 scores [B, Hkv, G, Sq, L] of q [B, Sq, H, D] against
    keys [B, L, Hkv, D] at absolute positions ``kpos`` [L]."""
    b, sq, h, d = q.shape
    hkv = k_all.shape[2]
    q5 = q.reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k_all).float() / (d**0.5)
    mask = (kpos >= 0) & (kpos <= pos)
    if window > 0:
        mask &= kpos > pos - window
    return torch.where(mask, s, _NEG_INF)


def _decode_partials(q, k, v, kpos, pos, window):
    """Decode attention over a slice of the keys, unnormalised: the slice's
    max score, sum of exponentials and exponential-weighted values per
    (row, head), each [B, Hkv, G, Sq, 1 or Dv] float32."""
    s = _decode_scores(q, k, kpos, pos, window)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    return mx, p.sum(-1, keepdim=True), torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())


def _combine_partials(mx, l, o, dtype):
    """The attention output [B, Sq, H, Dv] in ``dtype`` from the partials of
    :func:`_decode_partials` stacked over the key slices (dim 0)."""
    w = torch.exp(mx - mx.amax(0))
    out = (o * w).sum(0) / (l * w).sum(0)  # [B, Hkv, G, Sq, Dv]
    b, hkv, g, sq, dv = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g, dv).to(dtype)


def _seq_sharded(k) -> bool:
    """A DTensor cache [B, L, Hkv, D] whose sequence dim is sharded."""
    from torch.distributed.tensor import Shard

    return any(isinstance(pl, Shard) and pl.dim % k.ndim == 1 for pl in k.placements)


def _split_decode_attention(q, k_all, v_all, kpos, pos, window):
    """Decode attention on DTensors whose cache is sharded on its sequence
    over ``model`` (a head count that does not divide it: MQA, MLA's
    latent): each device scores its batch rows' queries, replicated over
    ``model``, against its own slice of the keys, keeping the unnormalised
    partials of :func:`_decode_partials`; those small partials are gathered
    over ``model`` and combined (:func:`_combine_partials`), so the cache
    never moves, as a contraction over a sharded dim runs under GSPMD. The
    rounding differs from the plain path's (float32 P.V), which a trace
    does not see."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    model, on_batch = mesh_axes(mesh, q.shape[0])
    chunk = -(-k_all.shape[1] // mesh.size(model))  # torch.chunk's split of the keys
    qp = [Replicate() if i == model else on_batch for i in range(mesh.ndim)]
    kp = [Shard(1) if i == model else on_batch for i in range(mesh.ndim)]
    rep = [Replicate()] * mesh.ndim
    # the partials gain a leading dim of one entry a ``model`` rank
    sliced = [Shard(0) if i == model else (Shard(1) if isinstance(on_batch, Shard) else on_batch)
              for i in range(mesh.ndim)]
    gathered = [Replicate() if i == model else pl for i, pl in enumerate(sliced)]
    q = q.redistribute(mesh, qp)
    k_all, v_all = k_all.redistribute(mesh, kp), v_all.redistribute(mesh, kp)
    if hasattr(kpos, "device_mesh"):
        kpos = kpos.redistribute(mesh, rep)

    def partials(ql, kl, vl, kposl):
        first = mesh.get_local_rank(model) * chunk
        parts = _decode_partials(ql, kl, vl, kposl[first:first + kl.shape[1]], pos, window)
        return tuple(t[None] for t in parts)

    kpos_pl = rep if hasattr(kpos, "device_mesh") else None
    parts = local_map(partials, out_placements=(sliced,) * 3,
                      in_placements=(qp, kp, kp, kpos_pl), device_mesh=mesh)(q, k_all, v_all, kpos)
    parts = [t.redistribute(mesh, gathered) for t in parts]
    return local_map(lambda mx, l, o: _combine_partials(mx, l, o, q.dtype), out_placements=qp,
                     in_placements=(gathered,) * 3, device_mesh=mesh)(*parts)


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
    """Returns (y [B, S, d], new cache or None).

    With head padding (``cfg.q_head_pad`` / ``kv_head_pad``, set by
    ``launch.specs.pad_heads_for_mesh`` for a tensor-parallel mesh) the
    projections make the padded heads and :func:`project_out` slices the
    dead ones away before ``wo``. Repeat mode (decided from ``cfg.tp_size``:
    neither the kv heads nor the GQA groups divide it, the q heads do)
    repeats the kv heads to the q heads before full-sequence attention, so
    that q shards as whole heads against a replicated kv; decode keeps the
    grouped products. Without a ``tp_size`` neither applies."""
    if cfg.kv_lora_rank:
        return mla_forward(p, cfg, x, positions=positions, cache=cache, window=window)
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    h, hkv = cfg.padded_q_heads, cfg.padded_kv_heads
    q = apply_rope(tiled(mm(x, p["wq"]), 2, h).reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(tiled(mm(x, p["wk"]), 2, hkv).reshape(b, s, hkv, dh), positions,
                   cfg.rope_theta)
    v = tiled(mm(x, p["wv"]), 2, hkv).reshape(b, s, hkv, dh)
    tp = cfg.tp_size
    repeat_mode = bool(tp and hkv % tp and (h // hkv) % tp and h % tp == 0 and h != hkv)

    def maybe_repeat(kk, vv):
        if repeat_mode:
            return (torch.repeat_interleave(kk, h // hkv, dim=2),
                    torch.repeat_interleave(vv, h // hkv, dim=2))
        return kk, vv

    def project_out(o):
        """Slice away the padded (dead) heads, keeping the real GQA
        grouping: the padded layout is (hkv_pad, g_pad, dh); the real heads
        are those with kv < hkv_real and g < g_real."""
        h_real, hkv_real = cfg.num_heads, cfg.num_kv_heads
        if h != h_real or hkv != hkv_real:
            o5 = tiled(o, 2, hkv).reshape(b, s, hkv, h // hkv, dh)
            o = reshaped(o5[:, :, :hkv_real, :h_real // hkv_real], (b, s, h_real, dh))
        return mm(reshaped(o, (b, s, h_real * dh)), p["wo"]).to(x.dtype)

    if cache is None:  # full-sequence causal (+ optional sliding window)
        kr, vr = maybe_repeat(k, v)
        return project_out(attention_core(q, kr, vr, causal=True, window=window)), None

    L = cache["k"].shape[1]
    pos = cache["pos"]
    ck = _cache_write(cache["k"], k, pos, L)
    cv = _cache_write(cache["v"], v, pos, L)
    kpos = _kpos_write(cache["kpos"], pos, s, L)
    new_cache = {"k": ck, "v": cv, "kpos": kpos, "pos": pos + s}
    if s > 1:
        # prefill (pos == 0 by convention): attend over the fresh k/v
        kr, vr = maybe_repeat(k, v)
        o = attention_core(q, kr, vr, causal=True, window=window)
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
    q = tiled(mm(x, p["wq"]), 2, h).reshape(b, s, h, dh + rd)
    q_rope = apply_rope(q[..., dh:], positions, cfg.rope_theta)
    qh = torch.cat([q[..., :dh], q_rope], dim=-1)
    ckv = mm(x, p["w_dkv"])  # [B, S, r]
    krope = apply_rope(mm(x, p["w_krope"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    def expand_kv(ckv_all, krope_all):
        skv = ckv_all.shape[1]
        k_nope = tiled(mm(ckv_all, p["w_uk"]), 2, h).reshape(b, skv, h, dh)
        v = tiled(mm(ckv_all, p["w_uv"]), 2, h).reshape(b, skv, h, dh)
        k_rope = krope_all[:, :, None, :].expand(b, skv, h, rd).to(k_nope.dtype)
        return torch.cat([k_nope, k_rope], dim=-1), v

    def project_out(o):
        return mm(reshaped(o, (b, s, h * dh)), p["wo"]).to(x.dtype)

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
