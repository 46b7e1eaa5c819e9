"""``GLISPConfig`` — one plain-data description of a full GLISP deployment.

Counterpart of ``repro/api/config.py`` with the same fields, defaults and
validation, less the JAX engine's ``infer_use_kernel`` and ``infer_jit``,
which have no meaning here: the tensors' device picks the kernel, and
PyTorch runs eagerly. ``kernel_autotune`` therefore needs no
``infer_use_kernel=True``; on a CPU device the tuner raises at the first
bucket instead.

Every component is named by a registry string (see ``repro_torch.api.backends``),
so a config serializes to JSON and a whole pipeline is reproducible from it:

    cfg = GLISPConfig(num_parts=4, partitioner="adadne", fanouts=(15, 10, 5))
    system = GLISPSystem.build(g, cfg)

The sampling-plan fields (``fanouts``/``weighted``/``direction``/``replace``)
are one ``SamplingSpec``: ``cfg.sampling_spec()`` materializes the typed,
validated object every sampling surface consumes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.faults import FaultPlan, RetryPolicy
from repro_torch.core.sampling.service import (
    DEFAULT_DIRECTION,
    MAX_PARTS,
    SamplingSpec,
)

__all__ = ["GLISPConfig"]


@dataclass(frozen=True)
class GLISPConfig:
    # -- partitioning --------------------------------------------------------
    num_parts: int = 4
    # adadne | dne (lockstep-vectorized) | adadne_loop | dne_loop (sequential
    # reference) | ldg | hash2d | random
    partitioner: str = "adadne"
    # content-addressed on-disk cache for the partition->reorder pipeline
    # artifacts (plan + permutation); None disables.  A second build over the
    # same graph+config loads the plan instead of repartitioning.
    partition_cache_dir: str | None = None

    # -- sampling service ----------------------------------------------------
    sampler: str = "gather_apply"  # gather_apply | edge_cut
    fanouts: tuple = (10, 5)
    direction: str = DEFAULT_DIRECTION  # shared by trainer/engine/loader
    weighted: bool = False
    # with-replacement uniform draws (uniform-only); named sample_replace
    # because `replace()` is the config-evolution method
    sample_replace: bool = False
    # server cost model; None picks the backend's native one
    # (gather_apply -> "algd", edge_cut -> "scan")
    cost_model: str | None = None
    # request-level scheduling: dedupe duplicate frontier seeds across
    # in-flight requests (accounting only — results are bit-identical)
    coalesce: bool = True
    # split per-server dispatches larger than this many seeds; 0 = unsplit
    max_server_batch: int = 0
    # loader/trainer submission window: how many sample requests ride
    # in-flight on the service at once (1 = the old blocking behavior)
    inflight: int = 2
    # where the sampling servers live: "inproc" (the default in-process
    # simulation) or "mp"/"socket" — one forked worker process per
    # partition behind a repro.dist transport (pipes / socketpair).
    # Results are bit-identical across all three (keyed per-dispatch RNG)
    dist_transport: str = "inproc"
    # client-side deadline for one remote dispatch answer; also the
    # window in which a dead worker must be respawned
    dist_dispatch_timeout: float = 60.0

    # -- batch pipeline ------------------------------------------------------
    batch_size: int = 256
    prefetch: int = 2  # queue depth for background sampling; 0 = serial
    balance_partitions: bool = False  # DistDGL-style balanced seeds
    vertex_quantum: int = 256  # padding buckets for XLA static shapes
    edge_quantum: int = 1024

    # -- tiered storage ------------------------------------------------------
    reorder: str = "pds"  # ns | ds | ps | pds | bfs
    cache_policy: str = "fifo"  # fifo | lru | locality (CACHE_POLICIES)
    # cache tier stack fast→slow above the authoritative DFS store; names
    # resolve in STORAGE_TIERS (memory | disk)
    storage_tiers: tuple = ("memory", "disk")
    # per-tier chunk budgets aligned with storage_tiers; missing/0 = auto
    # (memory: dynamic_frac of the tier below; disk: unbounded)
    tier_capacities: tuple = ()
    dynamic_frac: float = 0.10
    chunk_rows: int = 4096
    infer_batch_size: int = 4096
    infer_mode: str = "bucketed"  # bucketed (padded device slices) | reference
    # explicit edge-padding buckets (ascending); () = powers of two.  A
    # batch with more edges than the last bucket falls back to
    # power-of-two padding rather than failing
    infer_edge_buckets: tuple = ()
    # sweep the GNN kernels' launch shapes per (op, shape-bucket, dtype)
    # before each bucket's first slice (repro_torch.kernels.autotune); the
    # outputs keep their bits
    kernel_autotune: bool = False
    # directory for the tuner's content-addressed JSON artifact; None keeps
    # tuned configs in-process only (re-measured per process)
    kernel_cache_dir: str | None = None

    # -- fault tolerance -----------------------------------------------------
    # chaos schedule injected into the sampling servers + storage tiers;
    # None = no injection (and no injection overhead on the hot paths)
    fault_plan: FaultPlan | None = None
    # retry/backoff shared by the sampling dispatch and tier-read paths;
    # None = the RetryPolicy defaults (3 attempts, no delay)
    retry_policy: RetryPolicy | None = None
    # bound on every blocking ticket.result() wait; None = wait forever
    ticket_timeout: float | None = None
    # sampling-server replicas per partition (replica 0 is the primary);
    # >1 enables failover when a dispatch exhausts its retries
    server_replicas: int = 1
    # crash budget for the forked batch producers (see BatchPipeline)
    worker_respawns: int = 1
    # auto-checkpoint every N training steps into checkpoint_dir; 0 = off
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None

    # -- online serving ------------------------------------------------------
    # admission-queue bound for GLISPSystem.server(); a full queue REJECTS
    # (explicit status="rejected" response) rather than buffering unboundedly
    serve_queue_depth: int = 64
    # a partial batch flushes once its oldest request has waited this long
    # (0 = flush every step); full batches flush immediately
    serve_max_batch_delay_ms: float = 2.0
    # default per-request deadline; a request whose sample has not landed by
    # then completes with status="timeout".  None = no deadline
    serve_deadline_ms: float | None = 100.0

    seed: int = 0

    # -----------------------------------------------------------------------
    def sampling_spec(
        self,
        *,
        fanouts=None,
        weighted: bool | None = None,
        direction: str | None = None,
        replace: bool | None = None,
    ) -> SamplingSpec:
        """The config's sampling plan as one typed object (with per-call
        overrides) — what ``system.sample/submit/loader/trainer`` consume."""
        return SamplingSpec(
            fanouts=tuple(fanouts if fanouts is not None else self.fanouts),
            weighted=self.weighted if weighted is None else weighted,
            direction=direction or self.direction,
            replace=self.sample_replace if replace is None else replace,
        )

    def validate(self) -> "GLISPConfig":
        """Check every registry name and numeric range; returns self."""
        from repro_torch.api.backends import (
            CACHE_POLICIES,
            PARTITIONERS,
            REORDERS,
            SAMPLERS,
        )

        from repro_torch.core.storage import STORAGE_TIERS

        if not 1 <= self.num_parts <= MAX_PARTS:
            raise ValueError(
                f"num_parts must be in [1, {MAX_PARTS}], got {self.num_parts}"
            )
        PARTITIONERS.get(self.partitioner)
        if self.partition_cache_dir is not None and (
            not isinstance(self.partition_cache_dir, str)
            or not self.partition_cache_dir
        ):
            raise ValueError(
                "partition_cache_dir must be None or a non-empty path, got "
                f"{self.partition_cache_dir!r}"
            )
        SAMPLERS.get(self.sampler)
        if self.reorder not in REORDERS:
            raise ValueError(
                f"reorder must be one of {REORDERS.names()}, "
                f"got {self.reorder!r}"
            )
        if self.cache_policy not in CACHE_POLICIES:
            raise ValueError(
                f"cache_policy must be one of {CACHE_POLICIES.names()}, "
                f"got {self.cache_policy!r}"
            )
        if not self.storage_tiers:
            raise ValueError("storage_tiers must name at least one cache tier")
        for name in self.storage_tiers:
            if name not in STORAGE_TIERS:
                raise ValueError(
                    f"storage_tiers entries must be one of "
                    f"{STORAGE_TIERS.names()}, got {name!r}"
                )
        if len(self.tier_capacities) > len(self.storage_tiers):
            raise ValueError(
                f"tier_capacities has {len(self.tier_capacities)} entries for "
                f"{len(self.storage_tiers)} storage_tiers"
            )
        for cap in self.tier_capacities:
            if cap < 0:
                raise ValueError(
                    f"tier_capacities entries must be >= 0 (0 = auto), got {cap}"
                )
        self.sampling_spec().validate()
        if self.cost_model not in (None, "algd", "scan"):
            raise ValueError(
                f"cost_model must be None, 'algd' or 'scan', got {self.cost_model!r}"
            )
        for name in (
            "batch_size",
            "vertex_quantum",
            "edge_quantum",
            "chunk_rows",
            "infer_batch_size",
            "inflight",
        ):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        for name in ("prefetch", "max_server_batch"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if not 0.0 < self.dynamic_frac <= 1.0:
            raise ValueError(
                f"dynamic_frac must be in (0, 1], got {self.dynamic_frac}"
            )
        if self.fault_plan is not None and not isinstance(
            self.fault_plan, FaultPlan
        ):
            raise TypeError(
                f"fault_plan must be a FaultPlan or None, got {self.fault_plan!r}"
            )
        if self.retry_policy is not None:
            if not isinstance(self.retry_policy, RetryPolicy):
                raise TypeError(
                    "retry_policy must be a RetryPolicy or None, got "
                    f"{self.retry_policy!r}"
                )
            self.retry_policy.validate()
        if self.ticket_timeout is not None and self.ticket_timeout <= 0:
            raise ValueError(
                f"ticket_timeout must be positive or None, got {self.ticket_timeout}"
            )
        if self.dist_transport not in ("inproc", "mp", "socket"):
            raise ValueError(
                "dist_transport must be 'inproc', 'mp' or 'socket', got "
                f"{self.dist_transport!r}"
            )
        if self.dist_dispatch_timeout <= 0:
            raise ValueError(
                "dist_dispatch_timeout must be positive, got "
                f"{self.dist_dispatch_timeout}"
            )
        if self.server_replicas < 1:
            raise ValueError(
                f"server_replicas must be >= 1, got {self.server_replicas}"
            )
        if self.worker_respawns < 0:
            raise ValueError(
                f"worker_respawns must be >= 0, got {self.worker_respawns}"
            )
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}"
            )
        if self.checkpoint_every > 0 and self.checkpoint_dir is None:
            raise ValueError("checkpoint_every > 0 requires a checkpoint_dir")
        if self.serve_queue_depth <= 0:
            raise ValueError(
                f"serve_queue_depth must be positive, got {self.serve_queue_depth}"
            )
        if self.serve_max_batch_delay_ms < 0:
            raise ValueError(
                "serve_max_batch_delay_ms must be >= 0, got "
                f"{self.serve_max_batch_delay_ms}"
            )
        if self.serve_deadline_ms is not None and self.serve_deadline_ms <= 0:
            raise ValueError(
                "serve_deadline_ms must be positive or None, got "
                f"{self.serve_deadline_ms}"
            )
        if self.kernel_cache_dir is not None and (
            not isinstance(self.kernel_cache_dir, str) or not self.kernel_cache_dir
        ):
            raise ValueError(
                "kernel_cache_dir must be None or a non-empty path, got "
                f"{self.kernel_cache_dir!r}"
            )
        if self.infer_mode not in ("bucketed", "reference"):
            raise ValueError(
                f"infer_mode must be 'bucketed' or 'reference', got {self.infer_mode!r}"
            )
        if any(b <= 0 for b in self.infer_edge_buckets) or list(
            self.infer_edge_buckets
        ) != sorted(self.infer_edge_buckets):
            raise ValueError(
                "infer_edge_buckets must be positive and ascending, got "
                f"{self.infer_edge_buckets!r}"
            )
        return self

    def replace(self, **kw) -> "GLISPConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fanouts"] = list(self.fanouts)
        d["infer_edge_buckets"] = list(self.infer_edge_buckets)
        d["storage_tiers"] = list(self.storage_tiers)
        d["tier_capacities"] = list(self.tier_capacities)
        # typed fault-tolerance objects serialize via their own to_dict
        d["fault_plan"] = self.fault_plan.to_dict() if self.fault_plan else None
        d["retry_policy"] = (
            self.retry_policy.to_dict() if self.retry_policy else None
        )
        return d
