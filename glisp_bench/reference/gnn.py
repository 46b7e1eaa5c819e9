"""The plain reference: GraphSAGE and GAT layers, the classifier loss and
AdamW in plain PyTorch, float32, with TF32 off.

It imports nothing of the program. It follows the published layers
(GraphSAGE: Hamilton et al. 2017, mean aggregator, the self row joined to
the neighbours' mean; GAT: Velickovic et al. 2018, LeakyReLU(0.2) scores,
softmax over each vertex's sampled in-edges, ELU between layers) and the
AdamW of Loshchilov and Hutter with the schedule and clipping the
configuration's ``optimizer`` states (linear warm-up, cosine decay to
``min_lr_frac``, the global gradient norm clipped to ``grad_clip``).

``precision="tf32"`` rounds every matrix product's operands to TF32 (10
mantissa bits, round to nearest) before a float32 product: the control,
the nearest precision below the configuration's float32 with TF32 off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "set_float32",
    "round_tf32",
    "mm",
    "layer",
    "apply",
    "loss",
    "adamw_step",
    "adamw_state",
    "EDGE_BLOCK",
]

EDGE_BLOCK = 1 << 20  # edges gathered at a time by the full-graph layers


def set_float32() -> None:
    """Matrix products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    """a @ b with TF32 operands, and so the backward's two products."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, grad):
        ra, rb = ctx.saved_tensors
        g = round_tf32(grad)
        return g @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _MatmulTF32.apply(a, b)
    return a @ b


def _segment_sum(vals: torch.Tensor, tgt: torch.Tensor, n: int) -> torch.Tensor:
    return vals.new_zeros((n,) + tuple(vals.shape[1:])).index_add_(0, tgt, vals)


def sage_layer(p: dict, h: torch.Tensor, tgt: torch.Tensor, nbr: torch.Tensor,
               precision: str) -> torch.Tensor:
    """relu([h, mean of the sampled neighbours' rows] W + b)."""
    n = h.shape[0]
    agg = h.new_zeros((n, h.shape[1]))
    for lo in range(0, tgt.shape[0], EDGE_BLOCK):
        t, s = tgt[lo:lo + EDGE_BLOCK], nbr[lo:lo + EDGE_BLOCK]
        agg = agg.index_add(0, t, h.index_select(0, s))
    cnt = torch.bincount(tgt, minlength=n).to(h.dtype).clamp_min(1.0)[:, None]
    return F.relu(mm(torch.cat([h, agg / cnt], dim=1), p["w"], precision) + p["b"])


def gat_layer(p: dict, h: torch.Tensor, tgt: torch.Tensor, nbr: torch.Tensor,
              precision: str) -> torch.Tensor:
    """elu(sum over in-edges of softmax(LeakyReLU(a_dst . z_v + a_src . z_u)) z_u),
    heads concatenated, z = h W."""
    n = h.shape[0]
    heads, dh = p["a_dst"].shape
    z = mm(h, p["w"], precision).view(n, heads, dh)
    sd = (z * p["a_dst"]).sum(-1)  # [n, H]
    ss = (z * p["a_src"]).sum(-1)
    e = F.leaky_relu(sd.index_select(0, tgt) + ss.index_select(0, nbr), 0.2)  # [E, H]
    mx = e.new_full((n, heads), -math.inf).scatter_reduce(
        0, tgt[:, None].expand(-1, heads), e, "amax", include_self=True)
    ex = torch.exp(e - mx.detach().index_select(0, tgt))
    den = _segment_sum(ex, tgt, n).clamp_min(1e-9)
    alpha = ex / den.index_select(0, tgt)
    out = z.new_zeros((n, heads, dh))
    for lo in range(0, tgt.shape[0], EDGE_BLOCK):
        t, s = tgt[lo:lo + EDGE_BLOCK], nbr[lo:lo + EDGE_BLOCK]
        out = out.index_add(0, t, alpha[lo:lo + EDGE_BLOCK, :, None] * z.index_select(0, s))
    return F.elu(out.reshape(n, heads * dh))


def layer(kind: str, p: dict, h, tgt, nbr, precision: str = "float32"):
    """One layer over every row of ``h``; edge e carries row ``nbr[e]``'s
    message to row ``tgt[e]`` (int64 on h's device)."""
    if kind == "sage":
        return sage_layer(p, h, tgt, nbr, precision)
    if kind == "gat":
        return gat_layer(p, h, tgt, nbr, precision)
    raise ValueError(f"no reference layer for {kind!r}")


def apply(kind: str, tree: dict, feats, layer_edges: list, seed_pos, precision="float32"):
    """Class logits of the seeds: layer k over ``layer_edges[k]`` = (tgt, nbr)."""
    h = feats
    for k, (tgt, nbr) in enumerate(layer_edges):
        h = layer(kind, tree["layers"][k], h, tgt, nbr, precision)
    return mm(h.index_select(0, seed_pos), tree["out"], precision)


def loss(kind: str, tree: dict, feats, layer_edges, seed_pos, labels, precision="float32"):
    """Mean cross-entropy of the seeds."""
    logits = apply(kind, tree, feats, layer_edges, seed_pos, precision)
    return F.cross_entropy(logits, labels)


def leaves(tree: dict) -> list:
    """(name, tensor) of every weight, in a fixed order."""
    out = [("out", tree["out"])]
    for k, layer_p in enumerate(tree["layers"]):
        out += [(f"layers.{k}.{name}", layer_p[name]) for name in sorted(layer_p)]
    return out


def adamw_state(tree: dict) -> dict:
    return {"step": 0, "mu": {n: torch.zeros_like(t) for n, t in leaves(tree)},
            "nu": {n: torch.zeros_like(t) for n, t in leaves(tree)}}


def _lr(opt: dict, step: int) -> torch.Tensor:
    """The rate at update ``step`` (1 for the first), in float32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp((s + 1) / max(1, opt["warmup_steps"]), max=1.0)
    prog = torch.clamp((s - opt["warmup_steps"]) / max(1, opt["total_steps"] - opt["warmup_steps"]),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * cos)


@torch.no_grad()
def adamw_step(tree: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One AdamW update of ``tree`` in place from ``grads`` (by leaf name);
    returns the clipped gradients the moments took."""
    state["step"] += 1
    step = state["step"]
    lr = _lr(opt, step).to(tree["out"].device)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    bc1 = 1 - b1 ** torch.tensor(float(step))
    bc2 = 1 - b2 ** torch.tensor(float(step))
    bc1, bc2 = bc1.to(lr.device), bc2.to(lr.device)
    clipped = {}
    for name, p in leaves(tree):
        g = grads[name] * scale
        clipped[name] = g
        m = state["mu"][name].mul_(b1).add_((1 - b1) * g)
        v = state["nu"][name].mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt["eps"]) + opt["weight_decay"] * p))
    return clipped
