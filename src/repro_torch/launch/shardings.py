"""Sharding rules: every parameter, optimizer-state, cache and batch leaf
of the port's trees gets a spec on the ("data", "model") production mesh
(a multi-pod mesh folds its "pod" axis into data parallelism). Port of
``repro/launch/shardings.py``, rule for rule:

  embed [V, d]               -> (model, None)          vocab-sharded table
  attn wq / wk / wv [d, H*Dh] -> (None, model)         head-sharded
  attn wo [H*Dh, d]          -> (model, None)
  MLA w_uk/w_uv [r, H*Dh]    -> (None, model)
  mlp w_gate/w_up [d, F]     -> (None, model);  w_down -> (model, None)
  moe experts [E, d, F]      -> expert-parallel (E over model) when E % model
                                == 0 (DeepSeek 64/16), else tensor-parallel on
                                F (Mixtral 8 experts, F=14336)
  rglru channel params       -> channel dim over model (channels independent)
  mamba2 (130M)              -> replicated (model too small to matter)
  anything non-divisible     -> replicated (rule falls through)

KV caches: batch over data; kv-head dim over model when divisible, else the
sequence dim over model (MQA, kv = 1).

A spec is a plain tuple with one entry per tensor dim: None, a mesh axis
name, or a tuple of names (("pod", "data") shards one dim over both), so it
compares entry by entry with the reference's ``PartitionSpec``. The port's
layers are a list, one tree per layer, where the reference stacks each
stage's layers on a leading axis: a port spec is the reference's without
that axis's leading None. A cache's ``pos`` is a Python int in the port
(the reference's is an int32 per layer); its spec is ``()``.

:func:`placements` turns a spec into one DTensor placement per mesh dim and
:func:`distribute` places a tree by its specs. ``mesh`` is a
``torch.distributed.DeviceMesh`` or anything with a ``shape`` mapping axis
names to sizes (the rules read only the sizes).
"""
from __future__ import annotations

import math
from typing import Any

import torch

__all__ = [
    "data_axes",
    "model_axis_size",
    "batch_specs",
    "param_specs",
    "opt_state_specs",
    "cache_specs",
    "placements",
    "distribute",
    "local_shape",
    "device_bytes",
]


def _axes(mesh) -> dict:
    """Axis name -> size, for a ``DeviceMesh`` or a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh):
    return ("pod", "data") if "pod" in _axes(mesh) else "data"


def model_axis_size(mesh) -> int:
    return _axes(mesh)["model"]


def _div(n: int, m: int) -> bool:
    return n % m == 0


def _data_size(mesh) -> int:
    da = data_axes(mesh)
    sizes = _axes(mesh)
    return math.prod(sizes[a] for a in (da if isinstance(da, tuple) else (da,)))


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _param_rule(path: str, shape: tuple, cfg, msize: int) -> tuple:
    """``shape`` is one layer's (the port keeps no stacked layer axis)."""
    parts = path.split("/")
    leaf = parts[-1]
    nd = len(shape)

    def spec(*dims):
        return tuple(dims)

    if path == "embed":
        return ("model", None) if _div(shape[0], msize) else (None, None)
    if path == "head":
        return (None, "model") if _div(shape[1], msize) else (None, None)
    if leaf in ("norm1", "norm2", "final_norm", "A_log", "D", "dt_bias", "norm_w", "lam"):
        return (None,) * nd
    # attention: kv projections shard only over whole kv heads; a flat
    # split that lands inside head_dim makes every attention einsum
    # contract a sharded dim
    if leaf in ("wk", "wv"):
        hkv = getattr(cfg, "padded_kv_heads", 0)
        return spec(None, "model") if hkv and _div(hkv, msize) else spec(None, None)
    if leaf in ("wq", "w_uk", "w_uv"):
        return spec(None, "model") if _div(shape[-1], msize) else spec(None, None)
    if leaf == "wo":
        return spec("model", None) if _div(shape[-2], msize) else spec(None, None)
    if leaf in ("w_dkv", "w_krope"):
        return spec(None, None)
    # MoE experts [E, d, F] / [E, F, d]
    if "mlp" in parts and leaf in ("w_gate", "w_up", "w_down") and nd == 3:
        E = shape[-3]
        if _div(E, msize):  # expert parallel
            return spec("model", None, None)
        # tensor parallel within experts
        if leaf == "w_down":
            return spec(None, "model", None) if _div(shape[-2], msize) else spec(None, None, None)
        return spec(None, None, "model") if _div(shape[-1], msize) else spec(None, None, None)
    if leaf == "router":
        return spec(None, None)
    # dense / shared-expert MLPs [d, F] / [F, d]
    if leaf in ("w_gate", "w_up"):
        return spec(None, "model") if _div(shape[-1], msize) else spec(None, None)
    if leaf == "w_down":
        return spec("model", None) if _div(shape[-2], msize) else spec(None, None)
    # mamba2 / rglru projections
    if leaf in ("in_proj", "w_ig", "w_rg"):
        if cfg.family == "ssm":
            return (None,) * nd  # 130M: replicate
        return spec(None, "model") if _div(shape[-1], msize) else spec(None, None)
    if leaf == "out_proj":
        if cfg.family == "ssm":
            return (None,) * nd
        return spec("model", None) if _div(shape[-2], msize) else spec(None, None)
    if leaf == "conv":
        if cfg.family != "ssm" and _div(shape[-1], msize):
            return spec(None, "model")
        return (None,) * nd
    return (None,) * nd


def param_specs(cfg, params, mesh) -> Any:
    """``params``: the port's parameter tree (tensors on any device, or
    meta / fake tensors from ``specs.params_shapes``)."""
    msize = model_axis_size(mesh)
    return _tree_map_with_path(lambda p, x: _param_rule(p, _shape(x), cfg, msize), params)


def opt_state_specs(pspecs):
    """AdamW state mirrors params; step is replicated."""
    return {"mu": pspecs, "nu": pspecs, "step": ()}


def batch_specs(cfg, batch: int, mesh):
    da = data_axes(mesh)
    bspec = da if batch % _data_size(mesh) == 0 and batch >= _data_size(mesh) else None
    if cfg.input_mode == "embeddings":
        return {"inputs": (bspec, None, None), "targets": (bspec, None)}
    return {"inputs": (bspec, None), "targets": (bspec, None)}


def _cache_rule(path: str, shape: tuple, cfg, mesh) -> tuple:
    """One layer's cache leaf (no stacked layer axis)."""
    da = data_axes(mesh)
    msize = model_axis_size(mesh)
    dsize = _data_size(mesh)
    leaf = path.split("/")[-1]
    if leaf == "pos":
        return ()  # a Python int
    if leaf == "kpos":
        return (None,)
    batch = shape[0] if len(shape) > 0 else 1
    b = da if batch % dsize == 0 and batch >= dsize else None
    if leaf in ("k", "v"):  # [B, S, Hkv, Dh]
        if _div(shape[2], msize):
            return (b, None, "model", None)
        if _div(shape[1], msize):
            return (b, "model", None, None)  # shard sequence (MQA)
        return (b, None, None, None)
    if leaf in ("ckv", "krope"):  # [B, S, r]
        if _div(shape[1], msize):
            return (b, "model", None)
        return (b, None, None)
    if leaf == "state":  # ssm [B, H, P, N] or rglru [B, d]
        if len(shape) == 4:
            return (b, "model", None, None) if _div(shape[1], msize) else (b, None, None, None)
        return (b, "model") if _div(shape[1], msize) else (b, None)
    if leaf == "conv":  # [B, W-1, C]
        return (b, None, "model") if _div(shape[2], msize) else (b, None, None)
    return (None,) * len(shape)


def cache_specs(cfg, cache, mesh):
    return _tree_map_with_path(lambda p, x: _cache_rule(p, _shape(x), cfg, mesh), cache)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim: ``Shard(i)`` on each mesh dim named at
    entry ``i`` of ``spec`` (a tuple entry shards dim ``i`` on each of its
    axes, outermost first), ``Replicate()`` on every other and on a dim of
    size 1 (the same shard, and DTensor refuses some reshapes of a dim
    sharded there)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = _axes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None and sizes[axis] > 1:
                out[names.index(axis)] = Shard(i)
    return out


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A leaf's shape on one device: each sharded dim divided by the sizes
    of its axes (the rules shard only dims that divide)."""
    sizes = _axes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[i] //= sizes[axis]
    return tuple(out)


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` placed by ``specs``: over its
    tensor leaves, the product of the local shape times the itemsize (a
    Python int holds none)."""
    total = 0

    def add(path, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            spec = _lookup(specs, path)
            total += math.prod(local_shape(tuple(leaf.shape), spec, mesh)) * leaf.element_size()

    _tree_map_with_path(add, tree)
    return total


def _lookup(tree, path: str):
    for key in path.split("/") if path else ():
        tree = tree[key] if isinstance(tree, dict) else tree[int(key)]
    return tree


def distribute(tree, specs, mesh):
    """``tree`` of stand-ins (meta or fake tensors) as DTensors on
    ``mesh``, each placed by its spec: this process's shard is a fresh
    empty tensor of the local shape (on the stand-in's device, ``cpu`` for
    a meta one), so that it owns exactly its bytes. Python ints stay."""
    from torch.distributed.tensor import DTensor

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = _lookup(specs, path)
        device = "cpu" if leaf.device.type == "meta" else leaf.device
        local = torch.empty(local_shape(tuple(leaf.shape), spec, mesh), dtype=leaf.dtype,
                            device=device)
        return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return _tree_map_with_path(place, tree)
