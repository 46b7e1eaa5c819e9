"""Graph data structures.

``HeteroGraph`` is the *global* (unpartitioned) heterogeneous multigraph held
as COO + lazily-built CSR.  ``GraphPartition`` is the compact, read-only,
contiguous structure of paper Fig. 6 for one vertex-cut partition:

    global_id        int64 [Nv]   sorted ascending; local vertex id == index
    vertex_types     int16 [Nv]
    out_indptr       int64 [Nv+1] CSR offsets (edges sorted by (src,etype,dst))
    out_dst          int32 [Ne]   destination *local* ids; edge local id == idx
    in_indptr        int64 [Nv+1]
    in_src           int32 [Ne]   source local id of each incoming edge
    in_edge_id       int32 [Ne]   local edge id of each incoming edge
                                  (paper: in_edges stores (dst_id, edge_id))
    out_et_types     int16 [*]    edge-type ids per (vertex, type) group
    out_et_cum       int64 [*]    pre-accumulated per-vertex counts -> ranges
    out_et_indptr    int64 [Nv+1] offsets into out_et_types/out_et_cum
    (in_et_* mirror the above for incoming edges)
    out_degrees      int64 [Nv]   GLOBAL out-degree (original graph)
    in_degrees       int64 [Nv]   GLOBAL in-degree
    partition_bits   uint8 [Nv, ceil(P/8)]  bit p set => vertex also lives on p
    edge_weights     float32 [Ne] optional (weighted sampling)

No hash maps: global->local is a binary search over global_id, the per-edge
type id is a binary search over the aggregated (types, cum) representation.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from repro_torch.utils import ceil_div, nbytes_of

# ---------------------------------------------------------------------------
# Global graph
# ---------------------------------------------------------------------------


@dataclass
class HeteroGraph:
    num_vertices: int
    src: np.ndarray  # int64 [E]
    dst: np.ndarray  # int64 [E]
    edge_types: np.ndarray  # int16 [E]
    vertex_types: np.ndarray  # int16 [N]
    edge_weights: np.ndarray | None = None  # float32 [E]
    vertex_feats: np.ndarray | None = None  # float32 [N, F] optional
    labels: np.ndarray | None = None  # int32 [N] optional
    _csr: dict = field(default_factory=dict, repr=False)

    # -- basic properties ---------------------------------------------------
    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_vertex_types(self) -> int:
        return int(self.vertex_types.max()) + 1 if self.num_vertices else 0

    @property
    def num_edge_types(self) -> int:
        return int(self.edge_types.max()) + 1 if self.num_edges else 0

    def out_degrees(self) -> np.ndarray:
        if "outdeg" not in self._csr:
            self._csr["outdeg"] = np.bincount(
                self.src, minlength=self.num_vertices
            ).astype(np.int64)
        return self._csr["outdeg"]

    def in_degrees(self) -> np.ndarray:
        if "indeg" not in self._csr:
            self._csr["indeg"] = np.bincount(
                self.dst, minlength=self.num_vertices
            ).astype(np.int64)
        return self._csr["indeg"]

    def out_csr(self):
        """(indptr, order) with edges ordered by (src, etype, dst)."""
        if "out" not in self._csr:
            order = np.lexsort((self.dst, self.edge_types, self.src))
            indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
            np.cumsum(self.out_degrees(), out=indptr[1:])
            self._csr["out"] = (indptr, order)
        return self._csr["out"]

    def in_csr(self):
        if "in" not in self._csr:
            order = np.lexsort((self.src, self.edge_types, self.dst))
            indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
            np.cumsum(self.in_degrees(), out=indptr[1:])
            self._csr["in"] = (indptr, order)
        return self._csr["in"]

    def neighbors(self, v: int, direction: str = "out") -> np.ndarray:
        if direction == "out":
            indptr, order = self.out_csr()
            return self.dst[order[indptr[v] : indptr[v + 1]]]
        indptr, order = self.in_csr()
        return self.src[order[indptr[v] : indptr[v + 1]]]


# ---------------------------------------------------------------------------
# Per-vertex edge-type aggregation (shared by out/in indexes)
# ---------------------------------------------------------------------------


def _build_etype_index(indptr: np.ndarray, etypes_sorted: np.ndarray):
    """Build the aggregated (indptr, types, cum) edge-type index of Fig. 6.

    ``etypes_sorted`` are the edge types laid out in CSR order where each
    vertex's edges are contiguous and sorted by type.  Returns per-vertex
    groups: ``et_indptr[v]:et_indptr[v+1]`` indexes into ``et_types`` /
    ``et_cum`` where ``et_cum`` holds the *pre-accumulated* count so the range
    of type ``t`` inside vertex v's neighbor list is
    ``[cum_{k-1}, cum_k)`` relative to ``indptr[v]``.
    """
    nv = indptr.shape[0] - 1
    ne = etypes_sorted.shape[0]
    if ne == 0:
        z = np.zeros(nv + 1, dtype=np.int64)
        return z, np.zeros(0, np.int16), np.zeros(0, np.int32)
    # boundaries where (vertex, type) changes
    vert_of_edge = np.repeat(np.arange(nv, dtype=np.int64), np.diff(indptr))
    change = np.empty(ne, dtype=bool)
    change[0] = True
    change[1:] = (vert_of_edge[1:] != vert_of_edge[:-1]) | (
        etypes_sorted[1:] != etypes_sorted[:-1]
    )
    group_starts = np.flatnonzero(change)
    group_vert = vert_of_edge[group_starts]
    group_type = etypes_sorted[group_starts].astype(np.int16)
    group_ends = np.append(group_starts[1:], ne)
    # cumulative count *within* each vertex: end offset relative to indptr[v]
    group_cum = (group_ends - indptr[group_vert]).astype(np.int32)
    et_indptr = np.zeros(nv + 1, dtype=np.int64)
    np.add.at(et_indptr, group_vert + 1, 1)
    np.cumsum(et_indptr, out=et_indptr)
    return et_indptr, group_type, group_cum


# ---------------------------------------------------------------------------
# Partition structure (paper Fig. 6)
# ---------------------------------------------------------------------------

_FIELDS = [
    "global_id",
    "vertex_types",
    "out_indptr",
    "out_dst",
    "in_indptr",
    "in_src",
    "in_edge_id",
    "out_et_indptr",
    "out_et_types",
    "out_et_cum",
    "in_et_indptr",
    "in_et_types",
    "in_et_cum",
    "out_degrees",
    "in_degrees",
    "partition_bits",
    "edge_weights",
    "edge_global_id",
]


@dataclass
class GraphPartition:
    part_id: int
    num_parts: int
    global_id: np.ndarray
    vertex_types: np.ndarray
    out_indptr: np.ndarray
    out_dst: np.ndarray
    in_indptr: np.ndarray
    in_src: np.ndarray
    in_edge_id: np.ndarray
    out_et_indptr: np.ndarray
    out_et_types: np.ndarray
    out_et_cum: np.ndarray
    in_et_indptr: np.ndarray
    in_et_types: np.ndarray
    in_et_cum: np.ndarray
    out_degrees: np.ndarray  # global degrees
    in_degrees: np.ndarray
    partition_bits: np.ndarray
    edge_weights: np.ndarray | None = None
    # global edge id per local edge (CSR out order); lets sampling return ids
    # that index the global graph's edge_types/edge_weights.  None for
    # partitions persisted before this field existed.
    edge_global_id: np.ndarray | None = None

    # -- sizes ----------------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return int(self.global_id.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.out_dst.shape[0])

    def memory_bytes(self) -> int:
        return sum(
            getattr(self, f).nbytes
            for f in _FIELDS
            if getattr(self, f) is not None
        )

    # -- O(log N) / O(1) queries replacing stored fields ----------------------
    def global_to_local(self, gids: np.ndarray) -> np.ndarray:
        """Binary search; -1 for ids not present."""
        gids = np.asarray(gids, dtype=np.int64)
        pos = np.searchsorted(self.global_id, gids)
        pos = np.minimum(pos, self.num_vertices - 1)
        ok = self.global_id[pos] == gids
        return np.where(ok, pos, -1).astype(np.int64)

    def local_to_global(self, lids: np.ndarray) -> np.ndarray:
        return self.global_id[np.asarray(lids)]

    def local_out_degree(self, lids: np.ndarray) -> np.ndarray:
        lids = np.asarray(lids)
        return self.out_indptr[lids + 1] - self.out_indptr[lids]

    def local_in_degree(self, lids: np.ndarray) -> np.ndarray:
        lids = np.asarray(lids)
        return self.in_indptr[lids + 1] - self.in_indptr[lids]

    def edge_type_of(self, edge_lids: np.ndarray) -> np.ndarray:
        """Edge type via binary search in the aggregated per-vertex index."""
        edge_lids = np.asarray(edge_lids, dtype=np.int64)
        # vertex owning each edge: binary search in out_indptr
        v = np.searchsorted(self.out_indptr, edge_lids, side="right") - 1
        rel = edge_lids - self.out_indptr[v]
        out = np.empty(edge_lids.shape[0], dtype=np.int16)
        for i in range(edge_lids.shape[0]):  # small query batches in practice
            s, e = self.out_et_indptr[v[i]], self.out_et_indptr[v[i] + 1]
            k = np.searchsorted(self.out_et_cum[s:e], rel[i], side="right")
            out[i] = self.out_et_types[s + k]
        return out

    def out_neighbors(self, lid: int, etype: int | None = None):
        """(dst_local_ids, edge_local_ids) of vertex ``lid``, optionally one type."""
        s, e = int(self.out_indptr[lid]), int(self.out_indptr[lid + 1])
        if etype is None:
            return self.out_dst[s:e], np.arange(s, e, dtype=np.int64)
        ts, te = self.out_et_indptr[lid], self.out_et_indptr[lid + 1]
        types = self.out_et_types[ts:te]
        k = np.searchsorted(types, etype)
        if k >= types.shape[0] or types[k] != etype:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64))
        lo = 0 if k == 0 else int(self.out_et_cum[ts + k - 1])
        hi = int(self.out_et_cum[ts + k])
        return self.out_dst[s + lo : s + hi], np.arange(s + lo, s + hi, dtype=np.int64)

    def vertex_on_partitions(self, lids: np.ndarray) -> list[np.ndarray]:
        """Partition ids on which each vertex is replicated (from the bit array)."""
        lids = np.asarray(lids)
        bits = np.unpackbits(self.partition_bits[lids], axis=1, bitorder="little")
        return [np.flatnonzero(row[: self.num_parts]) for row in bits]

    def interior_mask(self) -> np.ndarray:
        """True for vertices that live on exactly one partition (interior)."""
        bits = np.unpackbits(self.partition_bits, axis=1, bitorder="little")
        return bits[:, : self.num_parts].sum(axis=1) == 1

    # -- persistence (contiguous binary layout + separate meta file) ----------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {"part_id": self.part_id, "num_parts": self.num_parts, "fields": {}}
        with open(os.path.join(path, "data.bin"), "wb") as f:
            off = 0
            for name in _FIELDS:
                arr = getattr(self, name)
                if arr is None:
                    continue
                arr = np.ascontiguousarray(arr)
                f.write(arr.tobytes())
                meta["fields"][name] = {
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "offset": off,
                }
                off += arr.nbytes
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "GraphPartition":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        buf = np.memmap(os.path.join(path, "data.bin"), dtype=np.uint8, mode="r")
        kwargs = {"part_id": meta["part_id"], "num_parts": meta["num_parts"]}
        for name in _FIELDS:
            info = meta["fields"].get(name)
            if info is None:
                kwargs[name] = None
                continue
            dt = np.dtype(info["dtype"])
            count = int(np.prod(info["shape"])) if info["shape"] else 1
            arr = np.frombuffer(
                buf, dtype=dt, count=count, offset=info["offset"]
            ).reshape(info["shape"])
            kwargs[name] = arr
        return cls(**kwargs)


# ---------------------------------------------------------------------------
# Partition materialization: edge assignment -> GraphPartition list
# ---------------------------------------------------------------------------


def build_partitions(
    g: HeteroGraph, edge_parts: np.ndarray, num_parts: int
) -> list[GraphPartition]:
    """Materialize the Fig.-6 structure for a vertex-cut edge assignment.

    ``edge_parts[e]`` is the partition id of edge e.  Vertices incident to
    edges in several partitions become boundary vertices (replicated).
    """
    assert edge_parts.shape[0] == g.num_edges
    outdeg_g = g.out_degrees()
    indeg_g = g.in_degrees()

    # global vertex -> set-of-partitions bit array (computed once, shared)
    nbytes = ceil_div(num_parts, 8)
    vbits = np.zeros((g.num_vertices, nbytes), dtype=np.uint8)
    ep8 = edge_parts.astype(np.int64)
    for p in range(num_parts):
        mask = ep8 == p
        byte, bit = p // 8, p % 8
        touched = np.union1d(g.src[mask], g.dst[mask])
        vbits[touched, byte] |= np.uint8(1 << bit)

    parts = []
    for p in range(num_parts):
        eids = np.flatnonzero(ep8 == p)
        src, dst, et = g.src[eids], g.dst[eids], g.edge_types[eids]
        gids = np.union1d(src, dst)  # sorted ascending
        nv = gids.shape[0]
        s_loc = np.searchsorted(gids, src).astype(np.int32)
        d_loc = np.searchsorted(gids, dst).astype(np.int32)

        # out CSR, edges sorted by (src_local, etype, dst_local)
        order = np.lexsort((d_loc, et, s_loc))
        s_loc, d_loc, et = s_loc[order], d_loc[order], et[order]
        eids_sorted = eids[order]
        out_indptr = np.zeros(nv + 1, dtype=np.int64)
        np.add.at(out_indptr, s_loc + 1, 1)
        np.cumsum(out_indptr, out=out_indptr)
        out_et_indptr, out_et_types, out_et_cum = _build_etype_index(
            out_indptr, et
        )

        # in CSR: incoming edges sorted by (dst_local, etype, src_local);
        # stores (src_local, edge_local_id) per paper
        in_order = np.lexsort((s_loc, et, d_loc))
        in_indptr = np.zeros(nv + 1, dtype=np.int64)
        np.add.at(in_indptr, d_loc[in_order] + 1, 1)
        np.cumsum(in_indptr, out=in_indptr)
        in_et_indptr, in_et_types, in_et_cum = _build_etype_index(
            in_indptr, et[in_order]
        )

        parts.append(
            GraphPartition(
                part_id=p,
                num_parts=num_parts,
                global_id=gids.astype(np.int64),
                vertex_types=g.vertex_types[gids].astype(np.int16),
                out_indptr=out_indptr,
                out_dst=d_loc.astype(np.int32),
                in_indptr=in_indptr,
                in_src=s_loc[in_order].astype(np.int32),
                in_edge_id=in_order.astype(np.int32),
                out_et_indptr=out_et_indptr,
                out_et_types=out_et_types,
                out_et_cum=out_et_cum,
                in_et_indptr=in_et_indptr,
                in_et_types=in_et_types,
                in_et_cum=in_et_cum,
                out_degrees=outdeg_g[gids].astype(np.int32),
                in_degrees=indeg_g[gids].astype(np.int32),
                partition_bits=vbits[gids],
                edge_weights=(
                    g.edge_weights[eids_sorted].astype(np.float32)
                    if g.edge_weights is not None
                    else None
                ),
                edge_global_id=eids_sorted.astype(np.int64),
            )
        )
    return parts


def naive_partition_memory_bytes(g: HeteroGraph, edge_parts: np.ndarray, num_parts: int) -> int:
    """Memory model of the 'existing frameworks' layout (Table III bench).

    DistDGL/GraphLearn represent a heterogeneous graph as ONE HOMOGENEOUS
    SUBGRAPH PER EDGE TYPE (paper §I): each subgraph keeps its own in+out
    CSRs, its own vertex array, an explicit global<->local hash map (~2x a
    plain array) and explicit 64-bit edge ids, plus the COO endpoints that
    DGL retains alongside the CSRs.
    """
    total = 0
    for p in range(num_parts):
        eids = np.flatnonzero(edge_parts == p)
        src, dst, et = g.src[eids], g.dst[eids], g.edge_types[eids]
        gids = np.union1d(src, dst)
        nv = gids.shape[0]
        for t in np.unique(et):
            sel = et == t
            e_t = int(sel.sum())
            v_t = np.union1d(src[sel], dst[sel]).shape[0]
            total += 2 * (8 * (v_t + 1) + 8 * e_t)  # in + out CSR
            total += 16 * e_t  # COO (src, dst) retained
            total += 8 * e_t  # explicit edge local ids
            total += 8 * v_t  # per-type vertex global ids
            total += 32 * v_t  # global<->local hash map (~2x key+value)
        total += nv * 8 * 2  # degrees
    return total
