"""The partition→reorder→materialize pipeline with a content-addressed cache.

``GLISPSystem.build`` used to run the partitioner inline on every call — the
only build stage with no artifact reuse, and by far the most expensive one at
scale.  ``PartitionPipeline`` makes the three preprocessing stages explicit:

    1. **partition**   — any ``Partitioner`` registry entry -> ``PartitionPlan``
    2. **reorder**     — the per-vertex locality permutation (PDS/BFS/...)
       grouped by the plan's per-vertex partition
    3. **materialize** — ``build_partitions`` -> ``GraphPartition`` list

Stages 1-2 are pure functions of (graph content, pipeline config), so their
artifacts are cached on disk under a content-addressed key::

    sha256(graph arrays) + {partitioner, num_parts, seed, direction,
                            reorder, cache version}  ->  <key>.npz

A second ``run`` over the same graph+config loads the plan and permutation
in milliseconds and reports ``cache_hit=True``; repeated training/inference
runs skip repartitioning entirely.  Materialization is recomputed (it is
deterministic given the plan and an order of magnitude cheaper than
partitioning).  Bump ``CACHE_VERSION`` when a partitioner's algorithm
changes so stale artifacts can never resurrect.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zipfile
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.partition.base import (
    DEFAULT_DIRECTION,
    PARTITIONERS,
    Partitioner,
    PartitionPlan,
)
from repro_torch.graph.graph import GraphPartition, HeteroGraph, build_partitions
from repro_torch.graph.reorder import REORDER_ALGS, reorder_permutation

__all__ = ["PartitionPipeline", "PipelineResult", "graph_fingerprint"]

CACHE_VERSION = 1


def graph_fingerprint(g: HeteroGraph) -> str:
    """Content hash of the graph structure (the partition/reorder inputs)."""
    h = hashlib.sha256()
    h.update(np.int64(g.num_vertices).tobytes())
    for arr in (g.src, g.dst, g.edge_types, g.vertex_types):
        h.update(np.ascontiguousarray(arr).tobytes())
    if g.edge_weights is not None:
        h.update(np.ascontiguousarray(g.edge_weights).tobytes())
    return h.hexdigest()


def derive_vertex_partition(g: HeteroGraph, plan: PartitionPlan) -> np.ndarray:
    """Per-vertex partition id used as the reorder grouping key: the plan's
    ``vertex_owner`` when the partitioner produced one, else the lowest-id
    hosting partition of the vertex-cut assignment (deterministic, one
    vectorized scatter-min over the edge endpoints)."""
    if plan.vertex_owner is not None:
        return plan.vertex_owner.astype(np.int64)
    sentinel = np.iinfo(np.int64).max
    owner = np.full(g.num_vertices, sentinel, dtype=np.int64)
    ep = plan.edge_parts.astype(np.int64)
    np.minimum.at(owner, g.src, ep)
    np.minimum.at(owner, g.dst, ep)
    owner[owner == sentinel] = 0  # isolated vertices
    return owner


@dataclass
class PipelineResult:
    plan: PartitionPlan
    perm: np.ndarray  # reorder permutation: perm[new_id] = old vertex id
    partitions: list[GraphPartition]
    seconds: dict = field(default_factory=dict)  # stage -> wall seconds
    cache_hit: bool = False
    cache_key: str | None = None

    @property
    def partition_seconds(self) -> float:
        return self.seconds.get("partition", 0.0)


class PartitionPipeline:
    """Explicit three-stage preprocessing pipeline (see module docstring).

    ``partitioner`` is a registry name or any ``Partitioner`` instance;
    ``cache_dir=None`` disables the artifact cache (every run computes)."""

    def __init__(
        self,
        partitioner: str | Partitioner,
        num_parts: int,
        *,
        reorder: str = "pds",
        seed: int = 0,
        direction: str = DEFAULT_DIRECTION,
        cache_dir: str | None = None,
    ):
        if isinstance(partitioner, str):
            partitioner = PARTITIONERS.get(partitioner)
        self.partitioner = partitioner
        if num_parts <= 0:
            raise ValueError(f"num_parts must be positive, got {num_parts}")
        self.num_parts = int(num_parts)
        alg = reorder.upper()
        if alg not in REORDER_ALGS:
            raise ValueError(
                f"reorder must be one of {REORDER_ALGS}, got {reorder!r}"
            )
        self.reorder = alg
        self.seed = int(seed)
        self.direction = direction
        self.cache_dir = cache_dir

    # ------------------------------------------------------------------
    def cache_key(self, g: HeteroGraph) -> str:
        # the partitioner contributes its cache_token (name + every
        # hyperparameter that changes the plan), so differently-configured
        # instances of the same algorithm never share an artifact
        part = self.partitioner
        token = getattr(
            part, "cache_token", getattr(part, "name", type(part).__name__)
        )
        cfg = {
            "v": CACHE_VERSION,
            "partitioner": str(token),
            "num_parts": self.num_parts,
            "seed": self.seed,
            "direction": self.direction,
            "reorder": self.reorder,
        }
        h = hashlib.sha256(graph_fingerprint(g).encode())
        h.update(json.dumps(cfg, sort_keys=True).encode())
        return h.hexdigest()[:32]

    def _cache_path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"glisp-partition-{key}.npz")

    # ------------------------------------------------------------------
    def _load(self, path: str) -> tuple[PartitionPlan, np.ndarray] | None:
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                plan = PartitionPlan(
                    edge_parts=z["edge_parts"],
                    vertex_owner=(
                        z["vertex_owner"] if "vertex_owner" in z.files else None
                    ),
                    num_parts=meta["num_parts"],
                    partitioner=meta["partitioner"],
                    seed=meta["seed"],
                    edge_counts=z["edge_counts"],
                    vertex_counts=z["vertex_counts"],
                    replication_factor=meta["rf"],
                    vertex_balance=meta["vb"],
                    edge_balance=meta["eb"],
                )
                return plan, z["perm"]
        except (
            OSError,
            EOFError,
            KeyError,
            ValueError,
            zipfile.BadZipFile,
            json.JSONDecodeError,
        ):
            return None  # unreadable/corrupt artifact: recompute

    def _save(self, path: str, plan: PartitionPlan, perm: np.ndarray) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        meta = {
            "num_parts": plan.num_parts,
            "partitioner": plan.partitioner,
            "seed": plan.seed,
            "rf": plan.replication_factor,
            "vb": plan.vertex_balance,
            "eb": plan.edge_balance,
        }
        arrays = {
            "edge_parts": plan.edge_parts,
            "perm": perm,
            "edge_counts": plan.edge_counts,
            "vertex_counts": plan.vertex_counts,
            "meta": np.array(json.dumps(meta)),
        }
        if plan.vertex_owner is not None:
            arrays["vertex_owner"] = plan.vertex_owner
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)  # atomic publish: concurrent runs never torn

    # ------------------------------------------------------------------
    def _reorder_perm(self, g: HeteroGraph, plan: PartitionPlan) -> np.ndarray:
        owner = derive_vertex_partition(g, plan)
        deg = g.out_degrees() + g.in_degrees()
        indptr = indices = None
        if self.reorder == "BFS":
            indptr, order = g.out_csr()
            indices = g.dst[order]
        return reorder_permutation(
            self.reorder,
            global_ids=np.arange(g.num_vertices, dtype=np.int64),
            degrees=deg,
            partition_ids=owner,
            indptr=indptr,
            indices=indices,
            seed=self.seed,
        )

    def run(self, g: HeteroGraph) -> PipelineResult:
        seconds: dict = {}
        key = path = None
        plan = perm = None
        cache_hit = False
        if self.cache_dir is not None:
            key = self.cache_key(g)
            path = self._cache_path(key)
            t0 = time.perf_counter()
            loaded = self._load(path)
            if loaded is not None:
                plan, perm = loaded
                cache_hit = True
                seconds["partition"] = time.perf_counter() - t0
                seconds["reorder"] = 0.0
        if plan is None:
            t0 = time.perf_counter()
            plan = self.partitioner.partition(
                g, self.num_parts, seed=self.seed, direction=self.direction
            )
            seconds["partition"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            perm = self._reorder_perm(g, plan)
            seconds["reorder"] = time.perf_counter() - t0
            if path is not None:
                self._save(path, plan, perm)
        t0 = time.perf_counter()
        parts = build_partitions(g, plan.edge_parts, self.num_parts)
        seconds["materialize"] = time.perf_counter() - t0
        return PipelineResult(
            plan=plan,
            perm=perm,
            partitions=parts,
            seconds=seconds,
            cache_hit=cache_hit,
            cache_key=key,
        )
