"""Mamba-2 (SSD) mixer. Port of ``repro/models/transformer/ssm.py``.

The full-sequence path (training forward and prefill) runs the SSD scan
through ``kernels.ops.ssd_scan``: the hand-written kernel on the card, the
chunked plain version (``ssd_chunked_ref``, the port of
``ssd_chunked_jnp``) on the CPU. A prefill starts from the cache's state.
The one-token decode step is plain tensor code, as in the JAX package.
RG-LRU (RecurrentGemma) is a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.transformer.config import ArchConfig, SSMConfig
from repro_torch.models.transformer.layers import Params, dense_init, mm

__all__ = ["init_mamba2", "mamba2_forward", "init_rglru", "rglru_forward"]

_RGLRU_TODO = "RG-LRU (RecurrentGemma) is not ported yet: ROADMAP queue 1, 'RG-LRU'"


def _dims(cfg: ArchConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.num_heads or d_in // s.head_dim
    return s, d_in, nh


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    d = cfg.d_model
    s, d_in, nh = _dims(cfg)
    g, n = s.num_groups, s.state_dim
    return {
        "in_proj": dense_init(generator, (d, 2 * d_in + 2 * g * n + nh), device=device),
        "conv": dense_init(generator, (s.conv_width, d_in + 2 * g * n), scale=0.2, device=device),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=device),  # A = -exp(A_log) = -1
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (d_in, d), device=device),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d. x: [B, S, C]; w: [W, C] (float32, so the
    taps sum in float32 as in the JAX package); state: [B, W-1, C] trailing
    context (decode). Returns (y in x's dtype, new_state)."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return y.to(x.dtype), new_state


def mamba2_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, d]
    *,
    cache: Params | None = None,  # {"state": [B,H,P,N], "conv": [B,W-1,C], "pos": int}
):
    """Returns (y [B, S, d], new cache or None). ``in_proj`` splits as
    z | xBC | dt; dt = softplus(dt + dt_bias), A = -exp(A_log); the block
    ends with its gated RMSNorm and ``out_proj``."""
    b, S, _ = x.shape
    s, d_in, nh = _dims(cfg)
    g, n, ph = s.num_groups, s.state_dim, s.head_dim

    z, xbc, dt = torch.split(mm(x, p["in_proj"]), [d_in, d_in + 2 * g * n, nh], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(F.silu(xbc), p["conv"], conv_state)
    xin, B_, C_ = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, S, nh]
    A = -torch.exp(p["A_log"])  # [nh]

    xh = xin.reshape(b, S, nh, ph)
    Bg = B_.reshape(b, S, g, n)
    Cg = C_.reshape(b, S, g, n)

    init_state = cache["state"] if cache is not None else None
    if S == 1 and cache is not None:
        # decode: one recurrence step
        Bh = Bg[:, 0].repeat_interleave(nh // g, dim=1).float()  # [B, nh, n]
        Ch = Cg[:, 0].repeat_interleave(nh // g, dim=1).float()
        dec = torch.exp((dt * A)[:, 0])  # [B, nh]
        state = init_state * dec[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xh[:, 0].float(), Bh, dt[:, 0]
        )
        y = torch.einsum("bhpn,bhn->bhp", state, Ch)[:, None]
    else:
        y, state = ssd_scan(xh, dt, A, Bg, Cg, chunk=s.chunk, init_state=init_state)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, S, d_in).to(x.dtype)
    # gated RMSNorm, then out
    yz = y * F.silu(z)
    yzf = yz.float()
    var = (yzf * yzf).sum(-1, keepdim=True) / yz.shape[-1]
    yz = yz * torch.rsqrt(var + 1e-6).to(yz.dtype) * p["norm_w"].to(yz.dtype)
    out = mm(yz, p["out_proj"]).to(x.dtype)
    new_cache = (
        {"state": state, "conv": new_conv, "pos": cache["pos"] + S} if cache is not None else None
    )
    return out, new_cache


def init_rglru(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    raise NotImplementedError(_RGLRU_TODO)


def rglru_forward(p: Params, cfg: ArchConfig, x, *, cache=None):
    raise NotImplementedError(_RGLRU_TODO)
