"""Host-side conversion: SampledSubgraph -> padded GNNBatch.

Counterpart of ``repro/models/gnn/batching.py``: the same bucket padding
of the vertex table and the per-layer edge lists, with every field
bit-equal to the reference's. Layer-k edge list = concat of hops
0..K-1-k, so its edges are not sorted by destination; the kernels read
CSR rows, so each layer also carries two permutations, built here with
numpy:

* ``layer_dst_order[k]``: stable-sorts the layer's edges by ``dst_pos``
  (the aggregation target), padding last. ``dst[order]`` is the CSR the
  forward aggregations read.
* ``layer_src_order[k]``: stable-sorts those dst-sorted edges by
  ``src_pos``, padding last: the order the gather backwards read
  (``kernels/fused_gnn.py``).

Summing in CSR order changes the float sum order against the JAX oracle,
which sums in edge order: results agree at float tolerance, not bitwise.
:meth:`GNNBatch.to` moves a batch to a device with pinned, non-blocking
copies; an array already in pinned memory (the batch pipeline's staging
buffers) is copied from where it lies, without pinning it again.
:func:`largest_batch` gives the shapes of the largest batch a sampling
plan can make, which sizes the pipeline's shared-memory slots.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.sampling.service import SampledSubgraph
from repro_torch.core.storage import as_feature_source
from repro_torch.utils import round_up

__all__ = ["GNNBatch", "largest_batch", "subgraph_to_batch", "sorted_order"]


@dataclass
class GNNBatch:
    feats: np.ndarray  # [V, F] float32, padded
    valid: np.ndarray  # [V] bool
    seed_pos: np.ndarray  # [B] int32 position of seeds in the table
    labels: np.ndarray  # [B] int32
    # per GNN layer k: (dst_pos [Ek], src_pos [Ek], etype [Ek]) padded, -1 pad
    layer_dst: list
    layer_src: list
    layer_etype: list
    # per layer k: [V, 1] float32 valid-edge in-degree per destination,
    # counted once here (host-side bincount); None = compute in-model
    layer_cnt: list | None = None
    # per layer k: int32 [Ek] permutations (see the module docstring)
    layer_dst_order: list | None = None
    layer_src_order: list | None = None

    @property
    def num_vertices(self) -> int:
        return self.feats.shape[0]

    def to(self, device) -> "GNNBatch":
        """This batch with every array as a tensor on ``device``. Host
        arrays are copied through pinned memory without blocking when the
        device is a CUDA card (an array that already lies in pinned memory
        is not pinned again); the copies are ordered on the current
        stream, before any kernel that reads them."""
        dev = torch.device(device)

        def move(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if dev.type == "cuda" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)

        moved = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                moved[f.name] = [move(a) for a in v]
            else:
                moved[f.name] = None if v is None else move(v)
        return GNNBatch(**moved)


def _bucket(n: int, quantum: int = 256) -> int:
    return max(quantum, round_up(n, quantum))


def sorted_order(pos: np.ndarray) -> np.ndarray:
    """int32 permutation that stable-sorts ``pos`` with padding (< 0) last."""
    key = np.where(pos < 0, np.iinfo(np.int32).max, pos)
    return np.argsort(key, kind="stable").astype(np.int32)


def largest_batch(
    num_vertices: int,
    feat_dim: int,
    batch_size: int,
    fanouts,
    num_layers: int,
    vertex_quantum: int = 256,
    edge_quantum: int = 1024,
) -> GNNBatch:
    """A batch of the largest shapes :func:`subgraph_to_batch` can give for
    ``batch_size`` seeds sampled with ``fanouts`` on a graph of
    ``num_vertices``, as zero-stride arrays that hold no memory. A hop's
    frontier is at most the graph and the seeds times the fanouts before
    it; each frontier vertex brings at most its hop's fanout in edges; the
    table holds at most the seeds and every edge's far end."""
    frontier, edges = batch_size, []
    for f in fanouts:
        edges.append(frontier * f)
        frontier = min(num_vertices, frontier * f)
    vpad = _bucket(min(num_vertices, batch_size + sum(edges)), vertex_quantum)
    epads = [_bucket(sum(edges[: num_layers - k]), edge_quantum) for k in range(num_layers)]

    def empty(shape, dtype):
        return np.broadcast_to(np.zeros((), dtype), shape)

    def per_layer(dtype):
        return [empty((e,), dtype) for e in epads]

    return GNNBatch(
        feats=empty((vpad, feat_dim), np.float32),
        valid=empty((vpad,), bool),
        seed_pos=empty((batch_size,), np.int32),
        labels=empty((batch_size,), np.int32),
        layer_dst=per_layer(np.int32),
        layer_src=per_layer(np.int32),
        layer_etype=per_layer(np.int32),
        layer_cnt=[empty((vpad, 1), np.float32) for _ in epads],
        layer_dst_order=per_layer(np.int32),
        layer_src_order=per_layer(np.int32),
    )


def subgraph_to_batch(
    sub: SampledSubgraph,
    feats,  # [N, F] ndarray or a repro_torch.core.storage.FeatureSource
    labels: np.ndarray | None,
    num_layers: int,
    edge_types_lookup=None,  # optional fn (src_gid, dst_gid) -> etype
    edge_types: np.ndarray | None = None,  # global per-edge type table
    vertex_quantum: int = 256,
    edge_quantum: int = 1024,
) -> GNNBatch:
    src = as_feature_source(feats)
    verts = sub.all_vertices()  # unique sorted gids
    vpad = _bucket(verts.shape[0], vertex_quantum)
    table = np.zeros((vpad, src.dim), dtype=np.float32)
    with tracing.span("batch.features"):
        table[: verts.shape[0]] = src.gather(verts)
    valid = np.zeros(vpad, dtype=bool)
    valid[: verts.shape[0]] = True

    seed_pos = np.searchsorted(verts, sub.seeds).astype(np.int32)
    lab = (
        labels[sub.seeds].astype(np.int32)
        if labels is not None
        else np.zeros(sub.seeds.shape[0], np.int32)
    )

    K = num_layers
    layer_dst, layer_src, layer_et, layer_cnt = [], [], [], []
    dst_orders, src_orders = [], []
    for k in range(K):
        hops = sub.hops[: K - k]
        src = np.concatenate([h.src for h in hops]) if hops else np.zeros(0, np.int64)
        dst = np.concatenate([h.dst for h in hops]) if hops else np.zeros(0, np.int64)
        eid = (
            np.concatenate([h.eid for h in hops])
            if hops and all(h.eid is not None for h in hops)
            else None
        )
        epad = _bucket(src.shape[0], edge_quantum)
        d_pos = np.full(epad, -1, dtype=np.int32)
        s_pos = np.full(epad, -1, dtype=np.int32)
        et = np.zeros(epad, dtype=np.int32)
        d_pos[: src.shape[0]] = np.searchsorted(verts, src)  # aggregation target
        s_pos[: src.shape[0]] = np.searchsorted(verts, dst)  # message source
        if src.shape[0]:
            if edge_types is not None and eid is not None:
                # direct: sampled edge ids index the global edge-type table
                et[: src.shape[0]] = edge_types[eid]
            elif edge_types_lookup is not None:
                et[: src.shape[0]] = edge_types_lookup(src, dst)
        layer_dst.append(d_pos)
        layer_src.append(s_pos)
        layer_et.append(et)
        layer_cnt.append(
            np.bincount(d_pos[d_pos >= 0], minlength=vpad)
            .astype(np.float32)
            .reshape(vpad, 1)
        )
        by_dst = sorted_order(d_pos)
        dst_orders.append(by_dst)
        src_orders.append(sorted_order(s_pos[by_dst]))
    return GNNBatch(
        feats=table,
        valid=valid,
        seed_pos=seed_pos,
        labels=lab,
        layer_dst=layer_dst,
        layer_src=layer_src,
        layer_etype=layer_et,
        layer_cnt=layer_cnt,
        layer_dst_order=dst_orders,
        layer_src_order=src_orders,
    )
