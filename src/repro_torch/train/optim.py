"""Hand-written optimizers on parameter trees: AdamW (decoupled weight
decay) and SGD with momentum, plus global-norm clipping.

Counterpart of ``repro/train/optim.py:19-96``, on trees of tensors (nested
dicts and lists, such as ``GNNModel.param_tree()``): the same formulas in
float32, the learning-rate schedule computed in float32 tensors as ``jnp``
computes it, and leaves visited in ``jax.tree.leaves`` order (dict keys
sorted). ``sgd_update`` is functional: it returns new tensors and leaves
its inputs as they are. ``adamw_update`` writes the reference's values
into the parameters and the moments in place, leaf by leaf and in slices
of ``_SLICE`` elements (the formulas are elementwise), so that a step of a
multi-GB model holds a few slices of temporaries and not a second copy of
its moments or of its largest leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "sgd_update",
    "clip_by_global_norm",
    "lr_schedule",
    "tree_leaves",
    "tree_map",
]

_SLICE = 1 << 24  # elements adamw_update updates at a time


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of ``rest``),
    keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac·lr (``step`` an int32
    tensor; float32 result)."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _clip_scale(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in float32 as
    ``jnp`` promotes a bf16 leaf times a float32 scale; the norm)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_init(params):
    leaf = tree_leaves(params)[0]
    return {
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step in place: the params and the state's moments are
    overwritten and returned as (params, new state, {"lr", "grad_norm"})."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return (
            p.float() - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p)
        ).to(p.dtype)

    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"])):
        p, m, v = p.view(-1), m.view(-1), v.view(-1)  # views: written in place
        g = g.reshape(-1)
        for lo in range(0, p.numel(), _SLICE):
            ps, ms, vs = (t[lo:lo + _SLICE] for t in (p, m, v))
            gs = g[lo:lo + _SLICE].float() * scale
            ms.mul_(b1).add_((1 - b1) * gs)
            vs.mul_(b2).add_((1 - b2) * torch.square(gs))
            ps.copy_(upd(ps, ms, vs))
    return params, {**state, "step": step}, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def sgd_update(params, grads, state, lr: float = 0.1, momentum: float = 0.9):
    if state is None:
        state = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    vel = tree_map(lambda v, g: momentum * v + g.float(), state, grads)
    new_params = tree_map(lambda p, v: (p - lr * v).to(p.dtype), params, vel)
    return new_params, vel
