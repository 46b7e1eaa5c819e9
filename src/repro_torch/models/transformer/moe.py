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

On a mesh (the dry run's DTensors) :func:`shard_g` pins the dispatch
buffer's and the combined tokens' group axis to the data axes, as the
reference's sharding constraint does; on a plain tensor it is the identity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import Params, dense_init, gelu, mm, reshaped

__all__ = ["Routing", "init_moe", "route", "moe_forward", "shard_g"]


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


def shard_g(t: torch.Tensor, cfg: ArchConfig, groups: int, expert_dim: bool = False):
    """The reference's group constraint. With ``groups > 1`` and
    ``cfg.data_axis_names`` set, a DTensor ``t`` [G, ...] is redistributed
    to the data axes on G and, for expert-parallel archs (E % tp_size == 0,
    ``expert_dim``), ``model`` on dim 1 (the expert dim), so that the
    dispatch product is the all-to-all; every other dim replicated. A
    plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if groups <= 1 or not cfg.data_axis_names or not isinstance(t, DTensor):
        return t
    from repro_torch.launch.shardings import placements

    ep = expert_dim and cfg.tp_size and cfg.moe.num_experts % cfg.tp_size == 0
    spec = (tuple(cfg.data_axis_names),) + tuple(
        "model" if (ep and i == 1) else None for i in range(1, t.ndim))
    return t.redistribute(t.device_mesh, placements(spec, t.device_mesh))


def _on_mesh(dispatch, combine, cfg: ArchConfig, mesh, grouped: bool):
    """``dispatch`` and ``combine`` through ``local_map`` (DTensor has no
    sharding for their scatter and gathers). Grouped, each data shard
    dispatches the groups it holds (the reference's group constraint): the
    tokens, the buffer and the routing are sharded on G over the data axes
    and replicated over ``model``. Ungrouped (one group), the tokens are
    gathered and every device routes them all, as the reference's single
    dispatch replicates its buffer. ``combine`` keeps the expert outputs'
    placement over ``model``: a partial sum stays one, and experts sharded
    there (expert parallelism) give each device the slots of its own
    experts, a partial sum over that axis; either is reduced at token
    granularity by the caller's constraint or the residual add."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.shardings import placements

    n_exp = cfg.moe.num_experts
    if grouped:
        on_g = placements((tuple(cfg.data_axis_names),), mesh)
    else:
        on_g = [Replicate() for _ in range(mesh.ndim)]
    rep = [Replicate() for _ in on_g]
    # the router's gradient sums each data shard's tokens
    router_grad = [Partial() if isinstance(pl, Shard) else pl for pl in on_g]
    mesh_dispatch = local_map(dispatch, out_placements=(on_g,) * 5, in_placements=(rep, on_g),
                              in_grad_placements=(router_grad, on_g), device_mesh=mesh,
                              redistribute_inputs=True)

    def mesh_combine(ye, rows, keep, gates):
        # ye [G, E, cap, d] -> yt [G, Tg, d]: G stays dim 0, d moves to dim 2,
        # experts sharded over an axis leave a partial sum over it
        moved = {0: 0, 3: 2}
        out, expert_axes = [], []
        for i, pl in enumerate(ye.placements):
            if isinstance(pl, Shard) and pl.dim in moved:
                out.append(Shard(moved[pl.dim]))
            elif isinstance(pl, Shard) and pl.dim == 1:
                out.append(Partial())
                expert_axes.append(i)
            elif isinstance(pl, (Partial, Replicate)):
                out.append(pl)
            else:
                raise ValueError(f"expert outputs placed {ye.placements}: no combine")

        def combine_own_experts(yl, rows, keep, gates):
            if not expert_axes:
                return combine(yl, rows, keep, gates)
            cap, el = yl.shape[2], yl.shape[1]
            first = 0
            for i in expert_axes:
                first = first * mesh.size(i) + mesh.get_local_rank(i)
            first *= el
            e, group = (rows // cap) % n_exp, rows // (cap * n_exp)
            mine = (e >= first) & (e < first + el)
            local = torch.where(mine, (group * el + e - first) * cap + rows % cap, 0)
            return combine(yl, local, keep & mine.view(keep.shape), gates)

        return local_map(combine_own_experts, out_placements=out,
                         in_placements=(ye.placements, on_g, on_g, on_g),
                         device_mesh=mesh)(ye, rows, keep, gates)

    return mesh_dispatch, mesh_combine


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
    on_mesh = hasattr(x, "device_mesh")  # a DTensor (the dry run)
    grouped = on_mesh and G > 1 and bool(cfg.data_axis_names)
    if on_mesh and not grouped:  # one dispatch group: every device routes every token
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    xt = reshaped(shard_g(x, cfg, G), (G, tg, d))  # grouped: the batch's data shards
    act = F.silu if activation == "swiglu" else gelu

    def dispatch(router, xt):
        """Routing and the dispatch buffer of the groups ``xt`` holds:
        (xe [G, E, cap, d], each slot's buffer row, whether it was kept,
        its gate, each group's load-balance term)."""
        g = xt.shape[0]
        r = route({"router": router}, cfg, xt)
        me = r.probs.mean(dim=1)  # [G, E]
        ce = F.one_hot(r.gate_idx[..., 0], n_exp).float().mean(dim=1)
        # dispatch: row (g * E + expert) * cap + pos of a [G * E * cap + 1, d]
        # buffer; dropped slots all go to the spare last row
        cap = r.cap
        tok_of_slot = torch.arange(tg, device=xt.device).repeat_interleave(k)
        group = torch.arange(g, device=xt.device)[:, None]
        base = (group * n_exp + r.gate_idx.reshape(g, tg * k)) * cap
        spare = g * n_exp * cap
        buf = xt.new_zeros((spare + 1, d))
        dest = torch.where(r.keep, base + r.pos, spare)
        buf[dest.reshape(-1)] = xt[:, tok_of_slot].reshape(-1, d)
        rows = base + torch.clamp_max(r.pos, cap - 1)
        return (buf[:spare].view(g, n_exp, cap, d), rows, r.keep.view(g, tg, k, 1),
                r.gate_vals.to(xt.dtype)[..., None], (me * ce).sum(-1))

    def combine(ye, rows, keep, gates):
        """Each slot's output (0 where dropped) times its gate, summed over
        the token's k slots in slot order."""
        g = ye.shape[0]
        y_slots = ye.reshape(-1, d)[rows.reshape(-1)].view(g, tg, k, d)
        y_slots = torch.where(keep, y_slots, 0.0) * gates
        yt = y_slots[:, :, 0]
        for j in range(1, k):
            yt = yt + y_slots[:, :, j]
        return yt

    if on_mesh:
        dispatch, combine = _on_mesh(dispatch, combine, cfg, x.device_mesh, grouped)
    xe, rows, keep, gates, aux_g = dispatch(p["router"], xt)
    aux = aux_g.mean() * n_exp * e.aux_loss_weight
    xe = shard_g(xe, cfg, G, expert_dim=True)
    # expert FFNs, batched over groups x experts
    h = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(xe.dtype))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(xe.dtype))
    ye = torch.einsum("gecf,efd->gecd", act(h) * u, p["w_down"].to(xe.dtype))
    yt = combine(ye, rows, keep, gates)
    yt = shard_g(yt, cfg, G)  # reduce at token granularity, not dispatch slot

    if e.num_shared:
        sp = p["shared"]
        yt = yt + mm(act(mm(xt, sp["w_gate"])) * mm(xt, sp["w_up"]), sp["w_down"])
    return reshaped(yt, (b, s, d)).to(x.dtype), aux
