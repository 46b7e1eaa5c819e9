"""The inputs every cell hands to the program and to the reference alike:
the graph, the training vertices and the model's weights.

The graph is fixed by the configuration (its ``graph_seed``): a deployment
trains and serves one graph, so every run of a cell does the same work.
``--seed`` draws the weights, the training vertices, the sampling keys and
the traffic. Weights are drawn on the device with a ``torch.Generator`` in
one call, then cut into the leaves of ``GNNModel``'s parameter tree at the
scales of its ``init_numpy``.
"""
from __future__ import annotations

import numpy as np

from glisp_bench.harness.graphgen import power_law_graph

__all__ = ["make_graph", "train_ids", "leaf_shapes", "make_weights", "layer_dims"]


def make_graph(cfg: dict) -> dict:
    """The configuration's graph as arrays (see ``graphgen``)."""
    return power_law_graph(
        cfg["num_vertices"], avg_degree=cfg["avg_degree"], feat_dim=cfg["feat_dim"],
        num_classes=cfg["num_classes"], seed=cfg["graph_seed"])


def train_ids(cfg: dict, seed: int) -> np.ndarray:
    """The training vertices: ``train_share`` of the graph, drawn from the
    seed, sorted."""
    n = cfg["num_vertices"]
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, max(1, int(n * cfg["train_share"])), replace=False))


def layer_dims(cfg: dict) -> list:
    return [cfg["feat_dim"]] + [cfg["hidden"]] * cfg["num_layers"]


def leaf_shapes(cfg: dict) -> list:
    """(path, shape, scale) of every weight: ``("layers", k, name)`` or
    ``("out",)``; scale 0 is a zero leaf (a bias)."""
    dims = layer_dims(cfg)
    out = []
    for k in range(cfg["num_layers"]):
        din, dout = dims[k], dims[k + 1]
        s = (1.0 / din) ** 0.5
        if cfg["model"] == "sage":
            leaves = {"w": ((2 * din, dout), s), "b": ((dout,), 0.0)}
        elif cfg["model"] == "gat":
            h = cfg["num_heads"]
            leaves = {"w": ((din, dout), s), "a_dst": ((h, dout // h), 0.1),
                      "a_src": ((h, dout // h), 0.1)}
        else:
            raise ValueError(f"no weights for the model kind {cfg['model']!r}")
        out += [(("layers", k, name), shape, sc) for name, (shape, sc) in sorted(leaves.items())]
    out.append((("out",), (cfg["hidden"], cfg["num_classes"]), (1.0 / cfg["hidden"]) ** 0.5))
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{"layers": [{name: tensor}], "out": tensor}``, float32 on
    ``device``, from one normal draw of a generator seeded with ``seed``."""
    import math

    import torch

    specs = leaf_shapes(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {"layers": [{} for _ in range(cfg["num_layers"])], "out": None}
    lo = 0
    for path, shape, scale in specs:
        size = math.prod(shape)
        leaf = flat[lo:lo + size].view(shape) * scale
        lo += size
        if path[0] == "out":
            tree["out"] = leaf
        else:
            tree["layers"][path[1]][path[2]] = leaf
    return tree
