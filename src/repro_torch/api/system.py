"""``GLISPSystem`` — the front door to the port's GLISP stack.

    from repro_torch.api import GLISPConfig, GLISPSystem

    system = GLISPSystem.build(g, GLISPConfig(num_parts=4, fanouts=(15, 10, 5)))
    sub = system.sample(seeds)                          # Gather-Apply K-hop
    for seeds, batch in system.loader(train_ids):       # prefetching pipeline
        ...
    trainer = system.train(model, train_ids, epochs=2)  # on the model's device
    dp = system.dp_trainer(model, train_ids, num_shards=4)  # S shards, one card
    result = system.infer_layerwise(layer_fns, workdir)  # on the card
    server = system.server()                            # online serving
    system.close()                                      # idempotent; or use `with`

Counterpart of ``repro/api/system.py``: build, sampling (in process, or
through forked sampling workers with ``dist_transport="mp"|"socket"``),
the batch pipeline, training, data-parallel training, layerwise inference
and serving.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.api.backends import (
    CACHE_POLICIES,
    REORDERS,
    SAMPLERS,
    GatherApplyBackend,
    PartitionPipeline,
    PartitionPlan,
    SamplerBackend,
)
from repro_torch.api.config import GLISPConfig
from repro_torch.api.pipeline import BatchPipeline
from repro_torch.graph.graph import GraphPartition, HeteroGraph
from repro_torch.graph.metrics import partition_metrics

__all__ = ["GLISPSystem"]


@dataclass
class GLISPSystem:
    graph: HeteroGraph
    config: GLISPConfig
    plan: PartitionPlan
    partitions: list[GraphPartition]
    backend: SamplerBackend
    partition_seconds: float = 0.0
    # True when the partition/reorder artifacts were loaded from the
    # content-addressed pipeline cache instead of computed
    partition_cache_hit: bool = False
    # reorder permutation from the pipeline (perm[new_id] = old vertex id)
    reorder_perm: np.ndarray | None = field(default=None, repr=False)
    pipeline_seconds: dict = field(default_factory=dict, repr=False)
    _metrics: dict | None = field(default=None, repr=False)
    # (signature, engine, pinned refs) for infer_layerwise reuse: repeat
    # calls with the same resolved parameters hit the same engine
    _infer_cache: tuple | None = field(default=None, repr=False)

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        graph: HeteroGraph,
        config: GLISPConfig | None = None,
        *,
        cache_dir: str | None = None,
        **overrides,
    ):
        """Compose the full system from a config (plus keyword overrides):
        partitioner -> partition materialization -> sampling service, each
        resolved by name. ``cache_dir`` (or ``config.partition_cache_dir``)
        names an on-disk artifact cache keyed by graph content + partition
        config."""
        config = (config or GLISPConfig()).replace(**overrides).validate()
        pipeline = PartitionPipeline(
            config.partitioner,
            config.num_parts,
            reorder=config.reorder,
            seed=config.seed,
            direction=config.direction,
            cache_dir=(
                cache_dir if cache_dir is not None else config.partition_cache_dir
            ),
        )
        res = pipeline.run(graph)
        plan = res.plan
        if config.balance_partitions and plan.vertex_owner is None:
            raise ValueError(
                "balance_partitions needs per-vertex owners, which only "
                "vertex partitioners produce (e.g. partitioner='ldg'); "
                f"{config.partitioner!r} yields a vertex-cut edge assignment"
            )
        backend = SAMPLERS.get(config.sampler)(graph, plan, res.partitions, config)
        return cls(
            graph=graph,
            config=config,
            plan=plan,
            partitions=res.partitions,
            backend=backend,
            partition_seconds=res.partition_seconds,
            partition_cache_hit=res.cache_hit,
            reorder_perm=res.perm,
            pipeline_seconds=res.seconds,
        )

    # -- sampling ------------------------------------------------------
    @property
    def service(self):
        """The shared ``SamplingService`` (servers, scheduler, counters)."""
        return self.backend.service

    @property
    def client(self):
        """Alias for :attr:`service` (the engine's sampling client)."""
        return self.backend.service

    def submit(
        self,
        seeds: np.ndarray,
        spec=None,
        *,
        key=None,
        fanouts=None,
        weighted: bool | None = None,
        direction: str | None = None,
        replace: bool | None = None,
    ):
        """Submit an asynchronous sample request; returns a ``SampleTicket``.

        The plan is ``spec`` (a ``SamplingSpec``) or the config's spec with
        per-call overrides; ``ticket.result()`` is bit-identical to the JAX
        package's for the same key."""
        if spec is None:
            spec = self.config.sampling_spec(
                fanouts=fanouts,
                weighted=weighted,
                direction=direction,
                replace=replace,
            )
        elif any(
            x is not None for x in (fanouts, weighted, direction, replace)
        ):
            raise ValueError(
                "pass either a SamplingSpec or individual "
                "fanouts/weighted/direction/replace overrides, not both"
            )
        return self.backend.submit(seeds, spec, key=key)

    def sample(
        self,
        seeds: np.ndarray,
        fanouts=None,
        *,
        spec=None,
        weighted: bool | None = None,
        direction: str | None = None,
        replace: bool | None = None,
        key=None,
    ):
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(
            seeds,
            spec,
            fanouts=fanouts,
            weighted=weighted,
            direction=direction,
            replace=replace,
            key=key,
        ).result(timeout=None)

    def partition_metrics(self) -> dict:
        if self._metrics is None:
            self._metrics = partition_metrics(
                self.partitions, self.graph.num_vertices
            )
        return self._metrics

    def server_workloads(self) -> np.ndarray:
        return self.backend.server_workloads()

    def server_health(self) -> dict:
        """Health of every sampling server replica (circuit-breaker view):
        ``{"server.<part>.<replica>": "up" | "quarantined"}``."""
        return self.service.server_health()

    def reset_stats(self) -> None:
        self.backend.reset_stats()

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 2.0) -> None:
        """Release owned OS resources — today that is the remote sampling
        worker pool when ``dist_transport != "inproc"`` (shutdown frame,
        then join / terminate / kill, ``timeout`` seconds a rung).
        Idempotent; the in-process system is a no-op, so unconditional
        cleanup is cheap."""
        close = getattr(self.backend, "close", None)
        if close is not None:
            close(timeout=timeout)

    def __enter__(self) -> "GLISPSystem":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- batch pipeline ------------------------------------------------
    def loader(
        self,
        seeds: np.ndarray,
        num_layers: int | None = None,
        *,
        batch_size: int | None = None,
        prefetch: int | None = None,
        seed: int | None = None,
        fanouts=None,
        spec=None,
        inflight: int | None = None,
        feature_source=None,
        device="cuda",
    ) -> BatchPipeline:
        """A prefetching seed->batch pipeline over this system's service,
        yielding batches on ``device``.

        ``feature_source`` (a ``repro_torch.core.storage.FeatureSource``)
        swaps the in-memory feature matrix for e.g. a disk-backed tiered
        store; batches are bit-identical either way."""
        cfg = self.config
        partition_of = (
            self.plan.vertex_owner if cfg.balance_partitions else None
        )
        if spec is None:
            spec = cfg.sampling_spec(fanouts=fanouts)
        elif fanouts is not None:
            raise ValueError("pass either a SamplingSpec or fanouts, not both")
        return BatchPipeline(
            self.backend,
            self.graph,
            seeds,
            list(spec.fanouts),
            num_layers if num_layers is not None else len(spec.fanouts),
            batch_size=batch_size if batch_size is not None else cfg.batch_size,
            spec=spec,
            prefetch=prefetch if prefetch is not None else cfg.prefetch,
            inflight=inflight if inflight is not None else cfg.inflight,
            seed=cfg.seed if seed is None else seed,
            partition_of=partition_of,
            balance_partitions=cfg.balance_partitions,
            vertex_quantum=cfg.vertex_quantum,
            edge_quantum=cfg.edge_quantum,
            feature_source=feature_source,
            ticket_timeout=cfg.ticket_timeout,
            worker_respawns=cfg.worker_respawns,
            device=device,
        )

    # -- training ------------------------------------------------------
    def trainer(
        self,
        model,
        train_ids: np.ndarray,
        *,
        opt=None,
        batch_size: int | None = None,
        prefetch: int | None = None,
        worker_cores: tuple | None = None,
        spec=None,
        inflight: int | None = None,
        feature_source=None,
    ):
        """A ``GNNTrainer`` wired to this system's backend and config; it
        trains ``model``'s parameters in place, on the model's device."""
        from repro_torch.train.loop import GNNTrainer  # lazy: avoids import cycle

        cfg = self.config
        spec = spec if spec is not None else cfg.sampling_spec()
        return GNNTrainer(
            model,
            self.backend,
            self.graph,
            list(spec.fanouts),
            train_ids,
            batch_size=batch_size if batch_size is not None else cfg.batch_size,
            opt=opt,
            spec=spec,
            seed=cfg.seed,
            prefetch=prefetch if prefetch is not None else cfg.prefetch,
            inflight=inflight if inflight is not None else cfg.inflight,
            worker_cores=worker_cores,
            partition_of=(
                self.plan.vertex_owner if cfg.balance_partitions else None
            ),
            balance_partitions=cfg.balance_partitions,
            feature_source=feature_source,
            checkpoint_dir=cfg.checkpoint_dir,
            checkpoint_every=cfg.checkpoint_every,
            ticket_timeout=cfg.ticket_timeout,
            worker_respawns=cfg.worker_respawns,
        )

    def train(
        self,
        model,
        train_ids: np.ndarray,
        *,
        epochs: int = 1,
        opt=None,
        log_every: int = 10,
        batch_size: int | None = None,
        prefetch: int | None = None,
        worker_cores: tuple | None = None,
    ):
        """Build a trainer, run ``epochs``, return the (trained) trainer."""
        tr = self.trainer(
            model,
            train_ids,
            opt=opt,
            batch_size=batch_size,
            prefetch=prefetch,
            worker_cores=worker_cores,
        )
        tr.train(epochs=epochs, log_every=log_every)
        return tr

    def dp_trainer(
        self,
        model,
        train_ids: np.ndarray,
        *,
        num_shards: int = 1,
        opt=None,
        batch_size: int | None = None,
        prefetch: int | None = None,
        reference: bool = False,
        device="cuda",
    ):
        """A ``DataParallelGNNTrainer``: ``num_shards`` sampling clients
        over this system's backend, their batches laid out block-diagonally
        as one batch, one step on ``device`` with the loss the mean of the
        shards' means (the reference shards over a mesh's data axis; one
        card has only the shard axis). ``reference=True`` also runs the
        per-shard loop on a copy of the parameters and logs its losses."""
        from repro_torch.train.data_parallel import (  # lazy: avoids import cycle
            DataParallelGNNTrainer,
        )

        cfg = self.config
        return DataParallelGNNTrainer(
            model,
            self.backend,
            self.graph,
            train_ids,
            num_shards=num_shards,
            spec=cfg.sampling_spec(),
            batch_size=batch_size if batch_size is not None else cfg.batch_size,
            opt=opt,
            seed=cfg.seed,
            prefetch=prefetch if prefetch is not None else cfg.prefetch,
            inflight=cfg.inflight,
            vertex_quantum=cfg.vertex_quantum,
            edge_quantum=cfg.edge_quantum,
            ticket_timeout=cfg.ticket_timeout,
            reference=reference,
            device=device,
        )

    # -- layerwise inference -------------------------------------------
    def infer_layerwise(
        self,
        layer_fns: list,
        workdir: str,
        *,
        feats: np.ndarray | None = None,
        fanouts=None,
        out_dims: list[int] | None = None,
        reorder: str | None = None,
        cache_policy: str | None = None,
        storage_tiers: tuple | None = None,
        tier_capacities: tuple | None = None,
        chunk_rows: int | None = None,
        dynamic_frac: float | None = None,
        batch_size: int | None = None,
        mode: str | None = None,
        kernel_autotune: bool | None = None,
        kernel_cache_dir: str | None = None,
        edge_buckets: tuple | None = None,
        device="cuda",
    ):
        """Run the redundancy-free layerwise engine over the whole graph,
        with the layer slices on ``device``. ``kernel_autotune`` /
        ``kernel_cache_dir`` (default: the config's) sweep the kernels'
        launch shapes per shape bucket before its first slice
        (``repro_torch.kernels.autotune``).

        Repeat calls with the same resolved parameters (and the *same*
        ``layer_fns``/``feats`` objects) reuse one engine."""
        from repro_torch.core.inference.engine import LayerwiseInferenceEngine

        if not isinstance(self.backend, GatherApplyBackend):
            raise ValueError(
                "layerwise inference needs the 'gather_apply' sampler backend "
                f"(vertex-cut hosting sets drive owner assignment); this "
                f"system uses {self.config.sampler!r}"
            )
        cfg = self.config
        if fanouts is None and len(cfg.fanouts) >= len(layer_fns):
            # follow the config like every other facade method; a config
            # with fewer fanouts than layers falls back to the engine default
            fanouts = cfg.fanouts[: len(layer_fns)]
        feats_arr = self.graph.vertex_feats if feats is None else feats
        resolved = dict(
            workdir=workdir,
            fanouts=tuple(fanouts) if fanouts is not None else None,
            reorder=reorder or cfg.reorder,
            chunk_rows=chunk_rows if chunk_rows is not None else cfg.chunk_rows,
            cache_policy=cache_policy or cfg.cache_policy,
            storage_tiers=(
                tuple(storage_tiers)
                if storage_tiers is not None
                else cfg.storage_tiers
            ),
            tier_capacities=(
                tuple(tier_capacities)
                if tier_capacities is not None
                else cfg.tier_capacities
            ),
            dynamic_frac=(
                dynamic_frac if dynamic_frac is not None else cfg.dynamic_frac
            ),
            batch_size=(
                batch_size if batch_size is not None else cfg.infer_batch_size
            ),
            direction=cfg.direction,
            out_dims=tuple(out_dims) if out_dims is not None else None,
            seed=cfg.seed,
            mode=mode if mode is not None else cfg.infer_mode,
            kernel_autotune=(
                kernel_autotune
                if kernel_autotune is not None
                else cfg.kernel_autotune
            ),
            kernel_cache_dir=(
                kernel_cache_dir
                if kernel_cache_dir is not None
                else cfg.kernel_cache_dir
            ),
            edge_buckets=(
                tuple(edge_buckets)
                if edge_buckets is not None
                else cfg.infer_edge_buckets
            ),
            device=str(device),
        )
        # identity (not value) for the unhashables: reuse is only sound for
        # the very same layer callables/features
        sig = (
            tuple(resolved.items()),
            tuple(id(fn) for fn in layer_fns),
            id(feats_arr),
        )
        if self._infer_cache is not None and self._infer_cache[0] == sig:
            return self._infer_cache[1].run()
        engine = LayerwiseInferenceEngine(
            self.graph,
            self.client,
            layer_fns,
            feats_arr,
            workdir,
            fanouts=list(fanouts) if fanouts is not None else None,
            reorder_alg=REORDERS.get(resolved["reorder"]),
            chunk_rows=resolved["chunk_rows"],
            policy=CACHE_POLICIES.get(resolved["cache_policy"]),
            storage_tiers=resolved["storage_tiers"],
            tier_capacities=resolved["tier_capacities"],
            dynamic_frac=resolved["dynamic_frac"],
            batch_size=resolved["batch_size"],
            direction=resolved["direction"],
            out_dims=out_dims,
            seed=resolved["seed"],
            mode=resolved["mode"],
            edge_buckets=resolved["edge_buckets"],
            ticket_timeout=cfg.ticket_timeout,
            retry_policy=cfg.retry_policy,
            faults=cfg.fault_plan,
            device=device,
            kernel_autotune=resolved["kernel_autotune"],
            kernel_cache_dir=resolved["kernel_cache_dir"],
        )
        # pin layer_fns/feats so the id()s in the signature stay valid
        self._infer_cache = (sig, engine, (list(layer_fns), feats_arr))
        return engine.run()

    @property
    def infer_engine(self):
        """The engine behind the last ``infer_layerwise`` call (None before
        the first)."""
        return self._infer_cache[1] if self._infer_cache is not None else None

    # -- online serving ------------------------------------------------
    def server(
        self,
        *,
        queue_depth: int | None = None,
        max_batch_delay_ms: float | None = None,
        deadline_ms: float | None | str = "config",
    ):
        """An online :class:`repro_torch.serve.GNNServer` over the last
        ``infer_layerwise`` run (call that first — serving recomputes only
        the final layer, on the engine's device). Knobs default to the
        config's ``serve_*`` fields; ``deadline_ms=None`` disables the
        request deadline."""
        from repro_torch.serve.server import GNNServer  # lazy: avoids import cycle

        cfg = self.config
        return GNNServer(
            self,
            queue_depth=(
                queue_depth if queue_depth is not None else cfg.serve_queue_depth
            ),
            max_batch_delay_ms=(
                max_batch_delay_ms
                if max_batch_delay_ms is not None
                else cfg.serve_max_batch_delay_ms
            ),
            deadline_ms=(
                cfg.serve_deadline_ms if deadline_ms == "config" else deadline_ms
            ),
        )
