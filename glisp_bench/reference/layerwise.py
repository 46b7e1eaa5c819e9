"""The inference and serving cells' comparison: every vertex's embeddings
layer by layer over the whole graph, from the graph's features and the
benchmark's weights, over the one-hop samples the program drew.

The engine samples each layer's hop per partition from streams keyed by
its partitioner's layout, and the server one hop per request; the
reference follows those samples (``samples`` says why) and checks them by
themselves: each layer's requests cover every vertex once, and every hop
passes ``samples.HopCheck``.

Numbers compared, each against its limit:

* ``embed_gap``: the largest |program - reference| over the compared
  embeddings, over the largest |reference| among them;
* ``sample_faults``, ``sample_fill``: as in ``train_check``.
"""
from __future__ import annotations

import numpy as np
import torch

from glisp_bench.reference import gnn
from glisp_bench.reference.samples import HopCheck

__all__ = ["engine_edges", "embed", "final_rows", "embed_gap"]


def engine_edges(requests: list, n: int, num_layers: int, fanouts, hc: HopCheck) -> list:
    """Per layer (tgt, nbr) over the whole graph from the engine's sample
    requests, in the order it submitted them: ``requests`` [(seeds, src,
    dst)], one per partition, layer after layer."""
    if not requests or len(requests) % num_layers:
        hc.fault()
        return [(np.zeros(0, np.int64), np.zeros(0, np.int64))] * num_layers
    per = len(requests) // num_layers
    out = []
    for k in range(num_layers):
        reqs = requests[k * per:(k + 1) * per]
        seeds = np.concatenate([r[0] for r in reqs])
        if seeds.shape[0] != n or not np.array_equal(np.sort(seeds), np.arange(n)):
            hc.fault()  # each vertex is computed once a layer
        src = np.concatenate([r[1] for r in reqs])
        dst = np.concatenate([r[2] for r in reqs])
        for seeds_p, s, d in reqs:
            hc.hop(seeds_p, s, d, fanouts[k])
        out.append((src, dst))
    return out


def embed(cfg: dict, arrays: dict, weights: dict, layer_edges: list, device, upto: int,
          precision: str = "float32") -> torch.Tensor:
    """Every vertex's embedding after layers 0 .. upto-1."""
    gnn.set_float32()
    n = arrays["num_vertices"]
    h = torch.as_tensor(arrays["vertex_feats"], device=device)
    with torch.no_grad():
        for k in range(upto):
            src, dst = layer_edges[k]
            ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
            tgt = torch.as_tensor(src[ok], device=device)
            nbr = torch.as_tensor(dst[ok], device=device)
            h = gnn.layer(cfg["model"], weights["layers"][k], h, tgt, nbr, precision)
    return h


def final_rows(cfg: dict, weights: dict, h_prev: torch.Tensor, verts: np.ndarray, src: np.ndarray,
               dst: np.ndarray, precision: str = "float32") -> torch.Tensor:
    """The last layer's rows of ``verts`` over their sampled edges
    src -> dst, from the previous layer's embeddings ``h_prev``."""
    k = cfg["num_layers"] - 1
    rows = np.unique(np.concatenate([verts, dst]))
    dev = h_prev.device
    local = lambda v: torch.as_tensor(np.searchsorted(rows, v), device=dev)  # noqa: E731
    keep = np.isin(src, rows) & np.isin(dst, rows)
    with torch.no_grad():
        out = gnn.layer(cfg["model"], weights["layers"][k],
                        h_prev.index_select(0, torch.as_tensor(rows, device=dev)),
                        local(src[keep]), local(dst[keep]), precision)
    return out.index_select(0, local(verts))


def embed_gap(prog, ref) -> float:
    """max |prog - ref| over max |ref| (numpy or tensors)."""
    p = torch.as_tensor(np.asarray(prog)) if not torch.is_tensor(prog) else prog
    r = ref.to(p.device) if torch.is_tensor(ref) else torch.as_tensor(np.asarray(ref))
    if p.shape != r.shape:
        return float("inf")
    if not torch.isfinite(p).all():
        return float("inf")
    scale = float(r.abs().max()) if r.numel() else 1.0
    return float((p.double() - r.double()).abs().max()) / max(scale, 1e-30) if r.numel() else 0.0
