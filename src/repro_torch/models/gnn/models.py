"""GNN models in PyTorch: GCN, GraphSAGE, GAT, HGT.

Counterpart of ``repro/models/gnn/models.py``. The parameters carry the
keys and layouts of the JAX ``GNNModel.init`` (``w`` is [din, dout],
applied as ``h @ w``; the classifier head ``out`` is [hidden, classes]),
so a JAX parameter tree loads as it is (:func:`load_jax_params`).
Aggregation goes through ``repro_torch.kernels.ops``: the Hopper kernels
for CUDA tensors, their plain versions for CPU tensors. The dense products
around them are ``torch.matmul``, as the JAX package leaves them to XLA.

Two surfaces, as in the reference:

* training: :meth:`GNNModel.layer`, :meth:`~GNNModel.apply` and
  :meth:`~GNNModel.loss` over a :class:`~repro_torch.models.gnn.batching.GNNBatch`
  on the model's device, differentiable in the parameters. Edges are taken
  in the batch's dst-sorted order; every gather whose backward is a
  scatter-add (``z[src]``, ``z[dst]``, ``h[src]``, ``q[dst]``) goes
  through ``gather_rows``, whose backward is the gather kernel over the
  batch's src-sorted order, so a training run repeats bit for bit;
* inference: :meth:`GNNModel.layer_slice` and :meth:`~GNNModel.embed_layer_fn`
  for the layerwise engine and the server, without autograd.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (
    gather_rows,
    gnn_aggregate,
    gnn_aggregate_and_count,
    gnn_gat_aggregate,
    gnn_gather_aggregate,
)

__all__ = ["GNN_KINDS", "GNNModel", "load_jax_params"]

GNN_KINDS = ("gcn", "sage", "gat", "hgt")


class GNNModel(nn.Module):
    """One of the four evaluated GNN kinds, with ``num_layers`` layers of
    width ``hidden`` over ``in_dim`` input features and a classifier head
    to ``num_classes``.

    Parameters are drawn at construction from ``np.random.default_rng(0)``
    with the shapes and scales of the JAX ``GNNModel.init``
    (:meth:`init_numpy`); :func:`load_jax_params` replaces them, for
    example with ``model.init_numpy(seed)`` for other draws. They require
    grad; the inference surfaces run without autograd."""

    def __init__(
        self,
        kind: str,
        in_dim: int,
        hidden: int = 256,
        num_layers: int = 3,
        num_classes: int = 16,
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
        self.num_classes = num_classes
        self.num_heads = num_heads
        self.num_etypes = num_etypes
        self.device = resolve_device(device)
        tree = self.init_numpy(0)
        self.layers = nn.ModuleList(
            nn.ParameterDict(
                {name: nn.Parameter(torch.as_tensor(arr, device=self.device)) for name, arr in p.items()}
            )
            for p in tree["layers"]
        )
        self.out = nn.Parameter(torch.as_tensor(tree["out"], device=self.device))

    # -- parameters --------------------------------------------------------
    def param_tree(self) -> dict:
        """The parameters as the JAX tree: ``{"layers": [{name: p}], "out": p}``."""
        return {"layers": [dict(p.items()) for p in self.layers], "out": self.out}

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
        out = normal((self.hidden, self.num_classes), (1.0 / self.hidden) ** 0.5)
        return {"layers": layers, "out": out}

    # -- training ------------------------------------------------------------
    def layer(
        self,
        k: int,
        h: torch.Tensor,
        dst: torch.Tensor,
        src: torch.Tensor,
        etype: torch.Tensor,
        src_order: torch.Tensor,
        cnt: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Layer ``k`` of the training forward (``repro/models/gnn/models.py:138-196``)
        over ``h`` [n, din] and the layer's edges in dst-sorted order:
        ``dst`` (aggregation target) and ``src`` (message source) int32 [E]
        with -1 padding at the tail, ``etype`` [E], and ``src_order``, the
        permutation that stable-sorts ``src`` with the padding last. ``cnt``
        is the precomputed in-degree column [n, 1]; gcn/sage count on the
        card when it is None."""
        p = self.layers[k]
        n = h.shape[0]
        if self.kind in ("gcn", "sage"):
            # the fused gather+aggregate reads h[src] inside the kernel
            agg = gnn_gather_aggregate(h, src, dst, n, src_order)
            if cnt is None:
                cnt = gnn_aggregate((dst >= 0).to(torch.float32)[:, None], dst, n)
            if self.kind == "gcn":
                return F.relu(((agg + h) / (cnt + 1.0)) @ p["w"] + p["b"])
            return F.relu(torch.cat([h, agg / torch.clamp_min(cnt, 1.0)], dim=1) @ p["w"] + p["b"])
        # dst is sorted, so its own sorting permutation is the identity
        by_dst = torch.arange(dst.shape[0], dtype=torch.int32, device=dst.device)
        if self.kind == "gat":
            heads, dh = p["a_dst"].shape
            z = h @ p["w"]  # [n, heads * dh]
            zsrc = gather_rows(z, src, src_order).view(-1, heads, dh)
            zdst = gather_rows(z, dst, by_dst).view(-1, heads, dh)
            e = F.leaky_relu(
                (zdst * p["a_dst"]).sum(-1) + (zsrc * p["a_src"]).sum(-1), 0.2
            )  # [E, H]
            return F.elu(gnn_gat_aggregate(e, zsrc, dst, n).reshape(n, heads * dh))
        # hgt: padding rows of h[src] are zero where the JAX layer reads
        # h[0]; their messages are masked and their rows excluded either way
        heads = self.num_heads
        dout = p["wo"].shape[0] // heads
        q = h @ p["wq"]
        hs = gather_rows(h, src, src_order)
        ke, ve = self._per_type(hs, etype, p)
        qd = gather_rows(q, dst, by_dst).view(-1, heads, dout)
        att = (qd * ke).sum(-1) / (dout**0.5)  # [E, H]
        msg = torch.where((src >= 0)[:, None, None], ve, 0.0)
        agg = gnn_gat_aggregate(att, msg, dst, n).reshape(n, heads * dout) @ p["wo"]
        return F.gelu(agg + h @ p["wskip"], approximate="tanh")

    def apply(self, batch) -> torch.Tensor:
        """Class logits [B, classes] of the batch's seeds
        (``repro/models/gnn/models.py:199-217``); ``batch`` is a
        ``GNNBatch`` on the model's device (:meth:`GNNBatch.to`)."""
        h = batch.feats
        for k in range(self.num_layers):
            order = batch.layer_dst_order[k].long()
            h = self.layer(
                k,
                h,
                batch.layer_dst[k][order],
                batch.layer_src[k][order],
                batch.layer_etype[k][order],
                batch.layer_src_order[k],
                cnt=None if batch.layer_cnt is None else batch.layer_cnt[k],
            )
            h = h * batch.valid[:, None]
        # seeds are distinct, so this gather's backward adds one row each
        return h.index_select(0, batch.seed_pos.long()) @ self.out

    def loss(self, batch) -> torch.Tensor:
        """Mean cross-entropy of the seeds: ``logsumexp - target``."""
        logits = self.apply(batch)
        tgt = logits.gather(1, batch.labels.long()[:, None])[:, 0]
        return (torch.logsumexp(logits, dim=-1) - tgt).mean()

    # -- one layer slice -----------------------------------------------------
    def _per_type(self, x: torch.Tensor, etype: torch.Tensor, p) -> tuple:
        """HGT's key and value rows [E, heads, dout]: one matmul per edge
        type over its edges (the JAX layer gathers an [E, din, h*dh] weight
        per edge instead). Each edge is written once, so the backward adds
        nothing twice."""
        heads = self.num_heads
        dout = p["wo"].shape[0] // heads
        et = torch.clamp(etype.long(), 0, self.num_etypes - 1)
        ke = x.new_empty((x.shape[0], heads * dout))
        ve = x.new_empty((x.shape[0], heads * dout))
        for t in range(self.num_etypes):
            rows = torch.nonzero(et == t).squeeze(1)
            xt = x.index_select(0, rows)
            ke[rows] = xt @ p["wk"][t]
            ve[rows] = xt @ p["wv"][t]
        return ke.reshape(-1, heads, dout), ve.reshape(-1, heads, dout)

    @torch.no_grad()
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
        heads = self.num_heads
        dout = p["wo"].shape[0] // heads
        q = (h_self @ p["wq"]).reshape(n, heads, dout)
        ke, ve = self._per_type(h_nbr, etype, p)
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
        * ``fn.needs_etype``: True for hgt;
        * ``fn.kernel_shapes(num_edges, num_vertices, in_dim)``: the
          reference's (op, (edges, segments, dim)) pairs this slice
          launches at a bucket, which the engine hands to the autotuner
          before the bucket's first slice."""
        dev = self.device

        def torch_fn(h_self, h_nbr, seg, etype):
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

        def kernel_shapes(num_edges, num_vertices, in_dim):
            if self.kind in ("gcn", "sage"):
                return [
                    ("segment_spmm_ragged", (num_edges, num_vertices, in_dim)),
                    ("segment_spmm_ragged", (num_edges, num_vertices, 1)),
                ]
            p = self.layers[k]
            dh = p["a_dst"].shape[1] if self.kind == "gat" else p["wo"].shape[0] // self.num_heads
            return [("gat_softmax_aggregate", (num_edges, num_vertices, dh))]

        fn.torch = torch_fn
        fn.needs_etype = self.kind == "hgt"
        fn.kernel_shapes = kernel_shapes
        return fn


def load_jax_params(model: GNNModel, tree: dict) -> GNNModel:
    """Copy a JAX ``GNNModel.init`` tree, converted to numpy
    (``jax.tree.map(np.asarray, params)``), into ``model``'s parameters
    (the layers and the classifier head ``out``), in place. Keys and shapes
    must match exactly."""
    layers = tree["layers"]
    if set(tree) != {"layers", "out"}:
        raise ValueError(f"tree keys {sorted(tree)} != ['layers', 'out']")
    if len(layers) != len(model.layers):
        raise ValueError(f"tree has {len(layers)} layers, model {len(model.layers)}")
    pairs = [("out", tree["out"], model.out)]
    for k, (src, dst) in enumerate(zip(layers, model.layers)):
        if set(src) != set(dst.keys()):
            raise ValueError(f"layer {k}: keys {sorted(src)} != {sorted(dst.keys())}")
        pairs += [(f"layer {k} {name!r}", arr, dst[name]) for name, arr in src.items()]
    for what, arr, dst in pairs:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: shape {arr.shape} != {tuple(dst.shape)}")
    with torch.no_grad():
        for _, arr, dst in pairs:
            dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model
