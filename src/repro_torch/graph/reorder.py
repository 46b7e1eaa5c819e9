"""Graph reorder algorithms (paper §II-C, §III-D and Fig. 14).

All algorithms return a *permutation*: ``perm[new_local_id] = old_index``.
Equivalently vertices are sorted by a key:

    NS   (natural sort)          key = global_id
    DS   (degree sort)           key = -degree
    PS   (partition sort)        key = (partition_id, global_id)
    PDS  (partition degree sort) key = (partition_id, -degree)   <- paper's alg
    BFS                          BFS order (within partition when parts given)
"""
from __future__ import annotations

import numpy as np

__all__ = ["reorder_permutation", "REORDER_ALGS", "bfs_order"]

REORDER_ALGS = ("NS", "DS", "PS", "PDS", "BFS")


def bfs_order(
    indptr: np.ndarray, indices: np.ndarray, num_vertices: int, seed: int = 0
) -> np.ndarray:
    """Vectorized-frontier BFS order covering all components."""
    visited = np.zeros(num_vertices, dtype=bool)
    order = np.empty(num_vertices, dtype=np.int64)
    pos = 0
    rng = np.random.default_rng(seed)
    start_candidates = rng.permutation(num_vertices)
    ci = 0
    while pos < num_vertices:
        while ci < num_vertices and visited[start_candidates[ci]]:
            ci += 1
        if ci >= num_vertices:
            rest = np.flatnonzero(~visited)
            order[pos : pos + rest.shape[0]] = rest
            pos += rest.shape[0]
            break
        frontier = np.array([start_candidates[ci]], dtype=np.int64)
        visited[frontier] = True
        while frontier.shape[0]:
            order[pos : pos + frontier.shape[0]] = frontier
            pos += frontier.shape[0]
            # expand all frontier neighbors at once
            starts, ends = indptr[frontier], indptr[frontier + 1]
            total = int((ends - starts).sum())
            if total == 0:
                break
            nbrs = np.concatenate(
                [indices[s:e] for s, e in zip(starts, ends)]
            ) if frontier.shape[0] < 1024 else indices[
                np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
            ]
            nbrs = np.unique(nbrs)
            nbrs = nbrs[~visited[nbrs]]
            visited[nbrs] = True
            frontier = nbrs
    return order


def reorder_permutation(
    alg: str,
    *,
    global_ids: np.ndarray,
    degrees: np.ndarray,
    partition_ids: np.ndarray | None = None,
    indptr: np.ndarray | None = None,
    indices: np.ndarray | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Return perm of local indices (``perm[new_id] = old_idx``)."""
    n = global_ids.shape[0]
    alg = alg.upper()
    if alg == "NS":
        return np.argsort(global_ids, kind="stable")
    if alg == "DS":
        return np.argsort(-degrees, kind="stable")
    if alg == "PS":
        assert partition_ids is not None
        return np.lexsort((global_ids, partition_ids))
    if alg == "PDS":
        assert partition_ids is not None
        return np.lexsort((-degrees, partition_ids))
    if alg == "BFS":
        assert indptr is not None and indices is not None
        if partition_ids is None:
            return bfs_order(indptr, indices, n, seed)
        # real BFS over each partition's INDUCED subgraph (symmetrized so a
        # weakly-connected group is one BFS component), groups in partition
        # order — replaces the old hub-first degree-sort approximation
        out = []
        for p in np.unique(partition_ids):
            members = np.flatnonzero(partition_ids == p)
            sub_indptr, sub_indices = _induced_subgraph(
                indptr, indices, members
            )
            local = bfs_order(
                sub_indptr, sub_indices, members.shape[0], seed + int(p)
            )
            out.append(members[local])
        return np.concatenate(out)
    raise ValueError(f"unknown reorder algorithm {alg!r}")


def _induced_subgraph(
    indptr: np.ndarray, indices: np.ndarray, members: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrized CSR of the subgraph induced by sorted ``members``
    (local ids = positions in ``members``), fully vectorized."""
    from repro_torch.utils import csr_slots

    m = members.shape[0]
    lens = indptr[members + 1] - indptr[members]
    if int(lens.sum()) == 0:
        return np.zeros(m + 1, dtype=np.int64), np.zeros(0, dtype=np.int64)
    nbrs = indices[csr_slots(indptr, members)]
    srcs = np.repeat(np.arange(m, dtype=np.int64), lens)
    # keep edges whose target is also a member; map to local ids
    pos = np.searchsorted(members, nbrs)
    pos = np.minimum(pos, m - 1)
    keep = members[pos] == nbrs
    u, v = srcs[keep], pos[keep]
    # symmetrize so BFS coverage matches weak connectivity
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    order = np.argsort(uu, kind="stable")
    uu, vv = uu[order], vv[order]
    sub_indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(sub_indptr, uu + 1, 1)
    np.cumsum(sub_indptr, out=sub_indptr)
    return sub_indptr, vv
