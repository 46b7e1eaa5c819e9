"""The graph every cell runs on, made from the configuration's numbers.

A frozen copy of ``power_law_graph`` from ``src/repro_torch/graph/generate.py``
at commit 2c9ddc5f1ad4cf75904747720f1e0edd62342e0b, changed only to return
the arrays as a dict: the benchmark makes its inputs itself, so a later
change to the program's generator cannot change what is measured. The
harness hands the arrays to the program (``repro_torch.graph.HeteroGraph``)
and to the reference alike.
"""
from __future__ import annotations

import numpy as np

__all__ = ["power_law_graph"]


def power_law_graph(
    num_vertices: int,
    avg_degree: float = 8.0,
    num_vertex_types: int = 3,
    num_edge_types: int = 4,
    feat_dim: int = 0,
    num_classes: int = 0,
    seed: int = 0,
    num_communities: int | None = None,
    community_mix: float = 0.7,
) -> dict:
    """Degree-corrected community power-law multigraph.

    Preferential attachment (endpoint drawn from the existing edge-endpoint
    list ⇒ degree-proportional) restricted to the new vertex's community with
    probability ``community_mix``, else global — real graphs have BOTH a
    power-law tail and community structure; the latter is the data locality
    GLISP's partitioner/reorder exploit (paper §I "inherent structural
    properties").  Vectorized in growth batches.
    """
    rng = np.random.default_rng(seed)
    m = max(1, int(round(avg_degree / 2)))
    if num_communities is None:
        num_communities = max(8, num_vertices // 512)  # chunk-scale communities
    C = max(1, min(num_communities, num_vertices // 64))
    comm = rng.integers(0, C, size=num_vertices).astype(np.int32)
    n0 = max(2 * m, 16 * C)
    core_src = rng.integers(0, n0, size=n0 * m)
    core_dst = rng.integers(0, n0, size=n0 * m)
    srcs = [core_src.astype(np.int64)]
    dsts = [core_dst.astype(np.int64)]
    endpoints = np.concatenate([core_src, core_dst]).astype(np.int64)
    comm_endpoints = [endpoints[comm[endpoints] == c] for c in range(C)]
    # celebrity pool: early vertices accumulate global hub degree (the
    # power-law hotspots that drive the paper's load-balance problem)
    n_celeb = max(4, num_vertices // 20000)
    celeb_endpoints = endpoints[endpoints < n_celeb]
    celeb_p = 0.05

    v = n0
    batch = max(1024, num_vertices // 64)
    while v < num_vertices:
        b = min(batch, num_vertices - v)
        new_ids = np.repeat(np.arange(v, v + b, dtype=np.int64), m)
        nedge = b * m
        # global preferential endpoint
        pref_g = endpoints[rng.integers(0, endpoints.shape[0], size=nedge)]
        # community preferential endpoint (grouped by community)
        pref_c = pref_g.copy()
        ecomm = comm[new_ids]
        for c in np.unique(ecomm):
            pool = comm_endpoints[c]
            sel = np.flatnonzero(ecomm == c)
            if pool.shape[0]:
                pref_c[sel] = pool[rng.integers(0, pool.shape[0], size=sel.shape[0])]
        unif = rng.integers(0, v, size=nedge)
        u = rng.random(nedge)
        take_celeb = u < celeb_p
        take_comm = (~take_celeb) & (u < celeb_p + community_mix)
        take_pref = rng.random(nedge) < 0.9
        pool = celeb_endpoints if celeb_endpoints.shape[0] else endpoints
        pref_celeb = pool[rng.integers(0, pool.shape[0], size=nedge)]
        targets = np.where(
            take_celeb,
            pref_celeb,
            np.where(take_comm, pref_c, np.where(take_pref, pref_g, unif)),
        )
        flip = rng.random(nedge) < 0.5
        s = np.where(flip, new_ids, targets)
        d = np.where(flip, targets, new_ids)
        srcs.append(s)
        dsts.append(d)
        fresh = np.concatenate([s, d])
        endpoints = np.concatenate([endpoints, fresh])
        fc = comm[fresh]
        for c in np.unique(fc):
            comm_endpoints[c] = np.concatenate(
                [comm_endpoints[c], fresh[fc == c]]
            )
        new_celebs = fresh[fresh < n_celeb]
        if new_celebs.shape[0]:
            celeb_endpoints = np.concatenate([celeb_endpoints, new_celebs])
        if endpoints.shape[0] > 8 * num_vertices * m:
            endpoints = endpoints[
                rng.integers(0, endpoints.shape[0], size=4 * num_vertices * m)
            ]
        v += b

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    vt = rng.integers(0, num_vertex_types, size=num_vertices).astype(np.int16)
    # edge type correlated with endpoint types (realistic hetero structure)
    et = (
        (vt[src].astype(np.int64) * 7 + vt[dst].astype(np.int64) * 3 + rng.integers(0, 2, size=src.shape[0]))
        % num_edge_types
    ).astype(np.int16)
    ew = rng.gamma(2.0, 1.0, size=src.shape[0]).astype(np.float32)
    feats = (
        rng.standard_normal((num_vertices, feat_dim)).astype(np.float32)
        if feat_dim
        else None
    )
    labels = (
        rng.integers(0, num_classes, size=num_vertices).astype(np.int32)
        if num_classes
        else None
    )
    return dict(
        num_vertices=num_vertices,
        src=src,
        dst=dst,
        edge_types=et,
        vertex_types=vt,
        edge_weights=ew,
        vertex_feats=feats,
        labels=labels,
    )
