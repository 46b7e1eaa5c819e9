"""GNN models in PyTorch: GCN, GraphSAGE, GAT, HGT (inference slices).

Counterpart of ``repro/models/gnn/models.py``. The per-layer parameters
carry the keys and layouts of the JAX ``GNNModel.init`` (``w`` is
[din, dout], applied as ``h @ w``), so a JAX parameter tree loads as it is
(:func:`load_jax_params`). Aggregation goes through
``repro_torch.kernels.ops``: the Hopper kernels for CUDA tensors, their
plain versions for CPU tensors. The dense products around them are
``torch.matmul``, as the JAX package leaves them to XLA.

This slice carries inference only: :meth:`GNNModel.embed_layer_fn` for the
layerwise engine and the server. ``apply``/``loss`` and the classifier head
come with training.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import gnn_aggregate_and_count, gnn_gat_aggregate

__all__ = ["GNN_KINDS", "GNNModel", "load_jax_params"]

GNN_KINDS = ("gcn", "sage", "gat", "hgt")


class GNNModel(nn.Module):
    """One of the four evaluated GNN kinds, with ``num_layers`` layers of
    width ``hidden`` over ``in_dim`` input features.

    Parameters are drawn at construction from ``np.random.default_rng(0)``
    with the shapes and scales of the JAX ``GNNModel.init``
    (:meth:`init_numpy`); :func:`load_jax_params` replaces them, for
    example with ``model.init_numpy(seed)`` for other draws."""

    def __init__(
        self,
        kind: str,
        in_dim: int,
        hidden: int = 256,
        num_layers: int = 3,
        num_heads: int = 4,
        num_etypes: int = 4,
        device="cuda",
    ):
        super().__init__()
        if kind not in GNN_KINDS:
            raise ValueError(f"kind must be one of {GNN_KINDS}, got {kind!r}")
        self.kind = kind
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_etypes = num_etypes
        self.device = resolve_device(device)
        tree = self.init_numpy(0)
        self.layers = nn.ModuleList(
            nn.ParameterDict(
                {
                    name: nn.Parameter(
                        torch.as_tensor(arr, device=self.device), requires_grad=False
                    )
                    for name, arr in p.items()
                }
            )
            for p in tree["layers"]
        )

    # -- parameters --------------------------------------------------------
    def init_numpy(self, seed: int) -> dict:
        """A parameter tree with the keys, shapes and scales of the JAX
        ``GNNModel.init`` (``repro/models/gnn/models.py:96-135``), drawn from
        ``np.random.default_rng(seed)`` in float32. JAX's own draws differ;
        tests load those through :func:`load_jax_params`."""
        rng = np.random.default_rng(seed)

        def normal(shape, scale):
            return (rng.standard_normal(shape) * scale).astype(np.float32)

        dims = [self.in_dim] + [self.hidden] * self.num_layers
        layers = []
        for k in range(self.num_layers):
            din, dout = dims[k], dims[k + 1]
            scale = (1.0 / din) ** 0.5
            if self.kind == "gcn":
                p = {"w": normal((din, dout), scale), "b": np.zeros(dout, np.float32)}
            elif self.kind == "sage":
                p = {"w": normal((2 * din, dout), scale), "b": np.zeros(dout, np.float32)}
            elif self.kind == "gat":
                h = self.num_heads
                dh = dout // h
                p = {
                    "w": normal((din, h * dh), scale),
                    "a_dst": normal((h, dh), 0.1),
                    "a_src": normal((h, dh), 0.1),
                }
            else:  # hgt
                h, e = self.num_heads, self.num_etypes
                dh = dout // h
                p = {
                    "wq": normal((din, h * dh), scale),
                    "wk": normal((e, din, h * dh), scale),
                    "wv": normal((e, din, h * dh), scale),
                    "wo": normal((h * dh, dout), scale),
                    "wskip": normal((din, dout), scale),
                }
            layers.append(p)
        return {"layers": layers}

    # -- one layer slice -----------------------------------------------------
    def layer_slice(
        self,
        k: int,
        h_self: torch.Tensor,
        h_nbr: torch.Tensor,
        seg: torch.Tensor,
        etype: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Layer ``k`` over one padded batch: ``h_self`` [n, din] rows,
        ``h_nbr`` [E, din] neighbor rows, ``seg`` [E] int32 destination row
        per edge (-1 = padding), ``etype`` [E] edge types (hgt). Same
        function as the JAX ``embed_layer_fn(...).jax``."""
        p = self.layers[k]
        n = h_self.shape[0]
        ok = seg >= 0
        if self.kind == "gcn":
            agg, cnt = gnn_aggregate_and_count(h_nbr, seg, n)
            return F.relu(((agg + h_self) / (cnt + 1.0)) @ p["w"] + p["b"])
        if self.kind == "sage":
            agg, cnt = gnn_aggregate_and_count(h_nbr, seg, n)
            cnt = torch.clamp_min(cnt, 1.0)
            return F.relu(torch.cat([h_self, agg / cnt], dim=1) @ p["w"] + p["b"])
        seg0 = torch.clamp_min(seg, 0).long()
        if self.kind == "gat":
            hh, dh = p["a_dst"].shape
            z = (h_self @ p["w"]).reshape(n, hh, dh)
            zsrc = (h_nbr @ p["w"]).reshape(-1, hh, dh)
            zsrc = torch.where(ok[:, None, None], zsrc, 0.0)
            zdst = z[seg0]
            e = F.leaky_relu(
                (zdst * p["a_dst"]).sum(-1) + (zsrc * p["a_src"]).sum(-1), 0.2
            )  # [E, H]
            out = gnn_gat_aggregate(e, zsrc, seg, n)  # all heads: [n, H, dh]
            return F.elu(out.reshape(n, hh * dh))
        # hgt: per-edge-type projections, one matmul per type over its edges
        # (the JAX slice gathers an [E, din, h*dh] weight per edge instead)
        heads = self.num_heads
        dout = p["wo"].shape[0] // heads
        q = (h_self @ p["wq"]).reshape(n, heads, dout)
        et = torch.clamp(etype.long(), 0, self.num_etypes - 1)
        ke = h_nbr.new_empty((h_nbr.shape[0], heads * dout))
        ve = h_nbr.new_empty((h_nbr.shape[0], heads * dout))
        for t in range(self.num_etypes):
            rows = torch.nonzero(et == t).squeeze(1)
            ke[rows] = h_nbr[rows] @ p["wk"][t]
            ve[rows] = h_nbr[rows] @ p["wv"][t]
        ke = ke.reshape(-1, heads, dout)
        ve = ve.reshape(-1, heads, dout)
        att = (q[seg0] * ke).sum(-1) / (dout**0.5)  # [E, H]
        msg = torch.where(ok[:, None, None], ve, 0.0)
        agg = gnn_gat_aggregate(att, msg, seg, n).reshape(n, heads * dout) @ p["wo"]
        return F.gelu(agg + h_self @ p["wskip"], approximate="tanh")

    def embed_layer_fn(self, k: int):
        """Adapter for the layerwise inference engine: one slice of the model
        as ``fn(k, h_self, h_nbr, seg[, etype]) -> h_new`` (numpy in and out,
        computed on the model's device). Engine-facing attributes:

        * ``fn.torch(h_self, h_nbr, seg, etype)``: the slice on tensors
          that already lie on the model's device, ``seg == -1`` padding;
        * ``fn.needs_etype``: True for hgt."""
        dev = self.device

        def torch_fn(h_self, h_nbr, seg, etype):
            with torch.no_grad():
                return self.layer_slice(k, h_self, h_nbr, seg, etype)

        def fn(_k, h_self, h_nbr, seg, etype=None):
            m = h_nbr.shape[0]
            sg = np.asarray(seg, np.int32) if m else np.zeros(0, np.int32)
            et = (
                np.asarray(etype, np.int32)
                if etype is not None and m
                else np.zeros(m, np.int32)
            )
            out = torch_fn(
                torch.as_tensor(np.ascontiguousarray(h_self), device=dev),
                torch.as_tensor(np.ascontiguousarray(h_nbr), device=dev),
                torch.as_tensor(sg, device=dev),
                torch.as_tensor(et, device=dev),
            )
            return out.cpu().numpy()

        fn.torch = torch_fn
        fn.needs_etype = self.kind == "hgt"
        return fn


def load_jax_params(model: GNNModel, tree: dict) -> GNNModel:
    """Copy a JAX ``GNNModel.init`` tree, converted to numpy
    (``jax.tree.map(np.asarray, params)``), into ``model``'s per-layer
    parameters, in place. Keys and shapes must match exactly; the
    classifier head ``tree["out"]`` is not part of this slice's model."""
    layers = tree["layers"]
    if len(layers) != len(model.layers):
        raise ValueError(f"tree has {len(layers)} layers, model {len(model.layers)}")
    for k, (src, dst) in enumerate(zip(layers, model.layers)):
        if set(src) != set(dst.keys()):
            raise ValueError(f"layer {k}: keys {sorted(src)} != {sorted(dst.keys())}")
        for name, arr in src.items():
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(dst[name].shape):
                raise ValueError(
                    f"layer {k} {name!r}: shape {arr.shape} != {tuple(dst[name].shape)}"
                )
            with torch.no_grad():
                dst[name].copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model
