"""State-space and linear-recurrence mixers: Mamba-2 (SSD) and RG-LRU
(Griffin / RecurrentGemma). Port of ``repro/models/transformer/ssm.py``.

Mamba-2's full-sequence path (training forward and prefill) runs the SSD
scan through ``kernels.ops.ssd_scan``: the hand-written kernels on the card
(forward, and backward under autograd), the chunked plain version
(``ssd_chunked_ref``, the port of ``ssd_chunked_jnp``) on the CPU. A
prefill starts from the cache's state. The one-token decode step is plain
tensor code, as in the JAX package.

RG-LRU is plain tensor code on both devices, as the JAX package has no
kernel for it: a width-4 causal conv, then the gated first-order
recurrence h_t = a_t h_{t-1} + b_t, which the JAX package runs with
``jax.lax.associative_scan`` and the port with a doubling (Hillis-Steele)
scan of the same combine, log2(S) steps of whole-sequence products (no
cumulative product or division, which would underflow float32: log a_t
reaches -8 softplus(lam) r_t, about -18.5 a step at the initial lam).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.transformer.config import ArchConfig, SSMConfig
from repro_torch.models.transformer.layers import Params, dense_init, gelu, mesh_axes, mm

__all__ = ["init_mamba2", "mamba2_forward", "init_rglru", "rglru_forward", "linear_scan"]


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


def _pad_front_sharded(x, n: int):
    """A DTensor ``x`` [B, S, C] with ``n`` zero rows before its first along
    dim 1, each device padding its own shard (``local_map``; dim 1 first
    unsharded if a mesh axis splits it). PyTorch 2.11's sharding rule for
    the pad gives placements shorter than the mesh and fails."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pls = [Replicate() if isinstance(pl, Shard) and pl.dim % x.ndim == 1 else pl
           for pl in x.placements]
    x = x.redistribute(x.device_mesh, pls) if list(x.placements) != pls else x
    # glint: disable=TRH002 -- n is the conv width less one, a weight shape, not data
    return local_map(lambda t: F.pad(t, (0, 0, n, 0)), out_placements=pls,
                     in_placements=(pls,), device_mesh=x.device_mesh)(x)


def _sharded_ssd_scan(x, dt, A, B_, C, *, chunk: int, init_state=None):
    """:func:`ssd_scan` on DTensors, each device scanning its own batch rows
    (and heads, when the heads and the groups both divide the model axis;
    else every ``model`` rank scans them all) through ``local_map``, as
    GSPMD runs a scan over unsharded sequence. The inputs are first placed
    so (an explicit redistribution, recorded like any other); A's gradient
    is a partial sum over the axes that shard the batch. PyTorch 2.11 has
    no sharding rule for the flip in the chunked scan's cumsum
    backward."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    model, on_batch = mesh_axes(mesh, x.shape[0])
    heads = x.shape[2] % mesh.size(model) == 0 and B_.shape[2] % mesh.size(model) == 0

    def layout(dim, batch):  # ``dim``: the head (group) dim
        return [(Shard(dim) if heads else Replicate()) if i == model else batch
                for i in range(mesh.ndim)]

    xp, sp, ap = layout(2, on_batch), layout(1, on_batch), layout(0, Replicate())
    a_grad = layout(0, Partial() if isinstance(on_batch, Shard) else Replicate())
    args, pls, grads = [x, dt, A, B_, C], [xp, xp, ap, xp, xp], [xp, xp, a_grad, xp, xp]
    if init_state is not None:
        args, pls, grads = args + [init_state], pls + [sp], grads + [sp]
    args = [t.redistribute(mesh, pl) for t, pl in zip(args, pls)]

    def local(xl, dtl, al, bl, cl, *il):
        return ssd_scan(xl, dtl, al, bl, cl, chunk=chunk, init_state=il[0] if il else None)

    return local_map(local, out_placements=(xp, sp), in_placements=tuple(pls),
                     in_grad_placements=tuple(grads), device_mesh=mesh)(*args)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d. x: [B, S, C]; w: [W, C] (float32, so the
    taps sum in float32 as in the JAX package); state: [B, W-1, C] trailing
    context (decode). Returns (y in x's dtype, new_state)."""
    width = w.shape[0]
    if state is None and hasattr(x, "device_mesh"):
        xp = _pad_front_sharded(x, width - 1)
    elif state is None:
        # glint: disable=TRH002 -- conv kernel width is an architecture
        # constant (weight shape), not a data-dependent length
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
        scan = _sharded_ssd_scan if hasattr(xh, "device_mesh") else ssd_scan
        y, state = scan(xh, dt, A, Bg, Cg, chunk=s.chunk, init_state=init_state)
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


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def init_rglru(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    d = cfg.d_model
    return {
        "in_proj": dense_init(generator, (d, 2 * d), device=device),  # u branch + gate branch
        "conv": dense_init(generator, (4, d), scale=0.2, device=device),
        "w_ig": dense_init(generator, (d, d), device=device),  # input gate
        "w_rg": dense_init(generator, (d, d), device=device),  # recurrence gate
        "lam": torch.full((d,), 2.2, dtype=torch.float32, device=device),  # softplus^-1-ish init
        "out_proj": dense_init(generator, (d, d), device=device),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for a, b [B, S,
    ...]: a doubling scan of ``associative_scan``'s combine (a_l a_r,
    a_r b_l + b_r), element t combined with element t - 2^k at step k. A
    product that underflows to 0 there is harmless; differentiable."""
    n = a.shape[1]
    shift = 1
    while shift < n:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def rglru_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B, S, d]
    *,
    cache: Params | None = None,  # {"state": [B, d] float32, "conv": [B, 3, d], "pos": int}
):
    """Returns (y [B, S, d], new cache or None). ``in_proj`` splits as
    u | gate; u runs through the causal conv, then the input gate i and
    the recurrence gate r (float32); log a = -8 softplus(lam) r, the input
    b = sqrt(1 - a^2) i u; h_t = a_t h_{t-1} + b_t from the cache's state
    (zeros without one), one step at S == 1 under a cache; out =
    out_proj(h * gelu(gate))."""
    b, S, d = x.shape
    u, gate = torch.chunk(mm(x, p["in_proj"]), 2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, p["conv"], conv_state)

    i_g = torch.sigmoid(mm(u, p["w_ig"])).float()
    r_g = torch.sigmoid(mm(u, p["w_rg"])).float()
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r_g  # [B, S, d] <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-9, 1.0))
    bterm = beta * (i_g * u.float())

    if S == 1 and cache is not None:
        state = a[:, 0] * cache["state"] + bterm[:, 0]
        hs = state[:, None]
    else:
        if cache is not None:  # fold the initial state into the first input
            bterm = torch.cat([bterm[:, :1] + a[:, :1] * cache["state"][:, None], bterm[:, 1:]],
                              dim=1)
        hs = linear_scan(a, bterm)
        state = hs[:, -1]
    y = hs.to(x.dtype) * gelu(gate)
    out = mm(y, p["out_proj"]).to(x.dtype)
    new_cache = (
        {"state": state, "conv": new_conv, "pos": cache["pos"] + S} if cache is not None else None
    )
    return out, new_cache
