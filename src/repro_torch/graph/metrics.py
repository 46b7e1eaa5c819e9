"""Partition quality metrics of paper Eq. (2)-(4): RF, EB, VB."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.graph import GraphPartition, HeteroGraph

__all__ = [
    "replication_factor",
    "edge_balance",
    "vertex_balance",
    "partition_metrics",
    "metrics_from_edge_assignment",
]


def replication_factor(parts: list[GraphPartition], num_global_vertices: int) -> float:
    return sum(p.num_vertices for p in parts) / max(1, num_global_vertices)


def edge_balance(parts: list[GraphPartition]) -> float:
    ne = [p.num_edges for p in parts]
    return max(ne) / max(1, min(ne))


def vertex_balance(parts: list[GraphPartition]) -> float:
    nv = [p.num_vertices for p in parts]
    return max(nv) / max(1, min(nv))


def partition_metrics(parts: list[GraphPartition], num_global_vertices: int) -> dict:
    return {
        "RF": replication_factor(parts, num_global_vertices),
        "EB": edge_balance(parts),
        "VB": vertex_balance(parts),
        "vertices": [p.num_vertices for p in parts],
        "edges": [p.num_edges for p in parts],
    }


def metrics_from_edge_assignment(
    g: HeteroGraph, edge_parts: np.ndarray, num_parts: int
) -> dict:
    """RF/EB/VB straight from a vertex-cut edge assignment (no materialize)."""
    nv, ne, total_v = [], [], 0
    for p in range(num_parts):
        mask = edge_parts == p
        ne.append(int(mask.sum()))
        vcount = np.union1d(g.src[mask], g.dst[mask]).shape[0]
        nv.append(int(vcount))
        total_v += vcount
    return {
        "RF": total_v / max(1, g.num_vertices),
        "EB": max(ne) / max(1, min(ne)),
        "VB": max(nv) / max(1, min(nv)),
        "vertices": nv,
        "edges": ne,
    }


def metrics_from_vertex_assignment(
    g: HeteroGraph, vertex_parts: np.ndarray, num_parts: int
) -> dict:
    """Metrics for an *edge-cut* (vertex assignment) partitioning with one-hop
    halo replication, as used by DistDGL-style systems: each partition stores
    its own vertices plus the endpoints of cut edges, and every edge incident
    to a partition's vertices (so one-hop sampling is local)."""
    nv, ne, total_v = [], [], 0
    sp = vertex_parts[g.src]
    dp = vertex_parts[g.dst]
    for p in range(num_parts):
        emask = (sp == p) | (dp == p)  # halo edges replicated
        ne.append(int(emask.sum()))
        verts = np.union1d(g.src[emask], g.dst[emask])
        own = np.flatnonzero(vertex_parts == p)
        vcount = np.union1d(verts, own).shape[0]
        nv.append(vcount)
        total_v += vcount
    return {
        "RF": total_v / max(1, g.num_vertices),
        "EB": max(ne) / max(1, min(ne)),
        "VB": max(nv) / max(1, min(nv)),
        "vertices": nv,
        "edges": ne,
    }
