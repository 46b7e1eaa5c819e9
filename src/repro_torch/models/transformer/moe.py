"""Mixture-of-Experts with top-k routing and capacity-based dispatch. Port
of ``repro/models/transformer/moe.py``.

The router's auxiliary loss plays the role AdaDNE's soft balance constraint
plays for graph partitions: work (tokens) must spread evenly over servers
(experts). Dispatch is GShard/Switch-style: per expert at most
``cap = max(1, int(Tg * k / E * capacity_factor))`` slots in each of
``cfg.moe_dispatch_groups`` token groups; a slot past its expert's capacity
is dropped and its token falls through on the residual path.

On the card this stays plain tensor code, as the JAX package leaves it to
XLA: routing, the expert FFNs as batched products over [G, E, cap, d]
buffers, and the combine. Two choices keep a run's bits the same on every
run, where the reference adds with ``.at[].add`` and ``segment_sum``
(float atomics on a GPU):

* dispatch is a plain scatter: kept slots own distinct (group, expert,
  position) rows, and dropped slots are written to one spare row past the
  buffer that nothing reads;
* the combine sums each token's k slots in slot order (``tok_of_slot`` is
  ``repeat(arange(Tg), k)``, so a token's slots are consecutive), the order
  in which the reference's ``segment_sum`` adds them on the CPU.

Top-k breaks ties to the lower expert index, as ``jax.lax.top_k`` does:
a stable descending sort, then the first k.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import Params, dense_init, gelu, mm

__all__ = ["Routing", "init_moe", "route", "moe_forward"]


def init_moe(generator: torch.Generator, cfg: ArchConfig, device=None) -> Params:
    """``router`` [d, E] (scale 0.02), ``w_gate``/``w_up`` [E, d, f],
    ``w_down`` [E, f, d], and with shared experts ``shared`` holding a
    gated MLP of width ``num_shared * f``."""
    d = cfg.d_model
    e = cfg.moe
    dff = e.expert_d_ff or cfg.d_ff
    p: Params = {
        "router": dense_init(generator, (d, e.num_experts), scale=0.02, device=device),
        "w_gate": dense_init(generator, (e.num_experts, d, dff), device=device),
        "w_up": dense_init(generator, (e.num_experts, d, dff), device=device),
        "w_down": dense_init(generator, (e.num_experts, dff, d), device=device),
    }
    if e.num_shared:
        p["shared"] = {
            "w_gate": dense_init(generator, (d, e.num_shared * dff), device=device),
            "w_up": dense_init(generator, (d, e.num_shared * dff), device=device),
            "w_down": dense_init(generator, (e.num_shared * dff, d), device=device),
        }
    return p


class Routing(NamedTuple):
    """One MoE layer's routing of [G, Tg] tokens over E experts, top k."""

    probs: torch.Tensor  # [G, Tg, E] float32 router softmax
    gate_idx: torch.Tensor  # [G, Tg, k] int64 chosen experts, best first
    gate_vals: torch.Tensor  # [G, Tg, k] float32, renormalised to sum 1
    pos: torch.Tensor  # [G, Tg * k] int64 slot's position in its expert's buffer
    keep: torch.Tensor  # [G, Tg * k] bool, pos < cap
    cap: int


def route(p: Params, cfg: ArchConfig, xt: torch.Tensor) -> Routing:
    """Routing of the grouped tokens ``xt`` [G, Tg, d]: router logits in
    xt's dtype, then float32 softmax, top-k and renormalisation; each
    slot's position is the count of earlier slots (in token-major order)
    that chose its expert."""
    e = cfg.moe
    g, tg, _ = xt.shape
    logits = mm(xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = ranked[..., : e.top_k], order[..., : e.top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    cap = max(1, int(tg * e.top_k / e.num_experts * e.capacity_factor))
    flat_idx = gate_idx.reshape(g, tg * e.top_k)
    # the reference's cumsum of the one-hot over slots, taken along the last
    # axis of its [G, E, Tk] transpose: on the card PyTorch scans an inner
    # axis in parallel but an outer one nearly serially (on an H100, 355 ms
    # of a 526 ms deepseek-v2-lite prefill of 49,152 slots a layer)
    onehot = F.one_hot(flat_idx, e.num_experts).transpose(1, 2).contiguous()
    counts = torch.cumsum(onehot, dim=-1)  # [G, E, Tk]
    pos = counts.gather(1, flat_idx[:, None, :])[:, 0] - 1
    return Routing(probs, gate_idx, gate_vals, pos, pos < cap, cap)


def moe_forward(
    p: Params, cfg: ArchConfig, x: torch.Tensor, activation: str = "swiglu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d] in x's dtype, aux float32 scalar: the
    Switch load-balance loss, per group, averaged over groups)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    G = max(1, cfg.moe_dispatch_groups)
    if t % G:
        G = 1
    tg = t // G
    k, n_exp = e.top_k, e.num_experts
    xt = x.reshape(G, tg, d)
    act = F.silu if activation == "swiglu" else gelu

    r = route(p, cfg, xt)
    me = r.probs.mean(dim=1)  # [G, E]
    ce = F.one_hot(r.gate_idx[..., 0], n_exp).float().mean(dim=1)
    aux = (me * ce).sum(-1).mean() * n_exp * e.aux_loss_weight

    # dispatch: row (g * E + expert) * cap + pos of a [G * E * cap + 1, d]
    # buffer; dropped slots all go to the spare last row
    cap = r.cap
    tok_of_slot = torch.arange(tg, device=x.device).repeat_interleave(k)
    group = torch.arange(G, device=x.device)[:, None]
    base = (group * n_exp + r.gate_idx.reshape(G, tg * k)) * cap
    spare = G * n_exp * cap
    buf = x.new_zeros((spare + 1, d))
    dest = torch.where(r.keep, base + r.pos, spare)
    buf[dest.reshape(-1)] = xt[:, tok_of_slot].reshape(-1, d)
    xe = buf[:spare].view(G, n_exp, cap, d)
    # expert FFNs, batched over groups x experts
    h = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(xe.dtype))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(xe.dtype))
    ye = torch.einsum("gecf,efd->gecd", act(h) * u, p["w_down"].to(xe.dtype))
    # combine: each slot's output (0 where dropped) times its gate, summed
    # over the token's k slots in slot order
    rows = base + torch.clamp_max(r.pos, cap - 1)
    y_slots = ye.reshape(spare, d)[rows.reshape(-1)].view(G, tg, k, d)
    keep = r.keep.view(G, tg, k, 1)
    gates = r.gate_vals.to(x.dtype)[..., None]
    y_slots = torch.where(keep, y_slots, 0.0) * gates
    yt = y_slots[:, :, 0]
    for j in range(1, k):
        yt = yt + y_slots[:, :, j]

    if e.num_shared:
        sp = p["shared"]
        yt = yt + mm(act(mm(xt, sp["w_gate"])) * mm(xt, sp["w_up"]), sp["w_down"])
    return yt.reshape(b, s, d).to(x.dtype), aux
