"""The fused batch pipeline: seed loading -> K-hop sampling -> padded batch.

Counterpart of ``repro/api/pipeline.py``: the same host code (numpy),
with batches copied to the model's device in the consumer
(:meth:`GNNBatch.to`, pinned non-blocking copies). The forked prefetch
worker stays numpy-only and never touches ``torch.cuda``, which is what
makes forking a process that has initialised CUDA safe.

``BatchPipeline`` composes ``SeedBatchLoader`` + the sampling service +
``subgraph_to_batch`` behind one iterator, with two *independent* overlap
axes:

``prefetch >= 1`` — the host-side producer (sampling + padding) runs ahead
    of the device step in a forked worker or thread, so the two
    overlap: ``sample_time + compute_time`` per step becomes roughly
    ``max(sample_time, compute_time)``.
``inflight >= 2`` — the producer keeps that many sample *requests* in
    flight on the ``SamplingService`` at once (a submission window), so the
    service's scheduler advances batch k's hop-2 beside batch k+1's hop-1,
    coalescing shared frontier seeds across the window.  Requests carry
    pipeline-owned keys ``(seed, batch_index)``, so the batch stream is
    bit-identical for ANY window depth and even when several pipelines
    share one service.

Two worker modes:

``process`` (default on POSIX) — a persistent forked worker owns the
    sampling state and streams batches through a bounded queue.  CPython's
    GIL makes a *thread* producer serialize against the consumer's Python
    sections (numpy only releases the GIL for a handful of ops), so a
    separate process is the only way host sampling truly runs beside the
    training step — the same reason DGL/PyTorch dataloaders use worker
    processes.
``thread`` — in-process double buffering via a daemon thread.  Zero-copy
    hand-off, but overlap is limited to the consumer's GIL-released windows.

Determinism: one persistent producer (process or thread) runs exactly the
serial code path on the same initial state, and sampling randomness is keyed
per request, so the batch stream is bit-identical to ``prefetch=0`` AND to
any ``inflight`` depth (tested for the reference in tests/test_api.py and
tests/test_service.py).
Note that in process mode the sampling-server stats live in the worker, so
read workload counters with ``prefetch=0`` pipelines.

Spans (``repro_torch.tracing``): the producer makes each batch inside one
``pipeline.produce`` root (``sampling.submit``, ``sampling.wait``,
``batch.assemble``, and in process mode ``pipeline.put``); the consumer
takes each inside one ``pipeline.next`` root (``pipeline.receive``,
``batch.to_device``). A forked worker's root summaries ride to the
consumer with the batches; ``sample_time`` sums the producer's roots.
"""
from __future__ import annotations

import collections
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import traceback
import warnings

import numpy as np

from repro_torch import tracing
from repro_torch.core.sampling.service import DEFAULT_DIRECTION, SamplingSpec
from repro_torch.core.storage import as_feature_source
from repro_torch.data.graph_loader import SeedBatchLoader
from repro_torch.device import resolve_device
from repro_torch.models.gnn.batching import GNNBatch, subgraph_to_batch
from repro_torch.utils import prefetch_iterator

__all__ = ["BatchPipeline"]

_log = logging.getLogger(__name__)

_FORK_AVAILABLE = os.name == "posix" and "fork" in mp.get_all_start_methods()

_KEY_MASK = (1 << 64) - 1


class BatchPipeline:
    def __init__(
        self,
        backend,
        graph,
        seeds: np.ndarray,
        fanouts,
        num_layers: int,
        *,
        batch_size: int = 256,
        spec: SamplingSpec | None = None,
        weighted: bool = False,
        direction: str = DEFAULT_DIRECTION,
        prefetch: int = 2,
        inflight: int = 1,
        workers: str = "auto",  # auto | process | thread
        worker_cores: tuple | None = None,  # CPU affinity for process workers
        seed: int = 0,
        partition_of: np.ndarray | None = None,
        balance_partitions: bool = False,
        vertex_quantum: int = 256,
        edge_quantum: int = 1024,
        feature_source=None,  # FeatureSource; None = graph.vertex_feats
        ticket_timeout: float | None = None,
        worker_respawns: int = 1,
        device="cuda",
    ):
        """Batches come out as tensors on ``device``.  ``ticket_timeout`` bounds every blocking ``ticket.result()``
        wait (None = wait forever, explicitly).  ``worker_respawns`` is the
        crash budget for the forked prefetch worker: a worker found dead
        mid-run is respawned up to this many times, replaying the keyed
        seed stream past the batches already delivered — the resumed
        stream is bit-identical by construction (see ``_respawn_worker``).
        ``worker_respawns=0`` restores the old fail-fast behavior."""
        if workers not in ("auto", "process", "thread"):
            raise ValueError(
                f"workers must be 'auto', 'process' or 'thread', got {workers!r}"
            )
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        if worker_respawns < 0:
            raise ValueError(
                f"worker_respawns must be >= 0, got {worker_respawns}"
            )
        self.device = resolve_device(device)
        self.backend = backend
        # accept a SamplerBackend or a raw GatherApply/EdgeCut client; the
        # async submission window needs `submit` (the service surface)
        self._sample = getattr(backend, "sample", None) or backend.sample_khop
        self._submit = getattr(backend, "submit", None)
        self.graph = graph
        self.spec = (
            spec
            if spec is not None
            else SamplingSpec(
                fanouts=tuple(fanouts), weighted=weighted, direction=direction
            )
        ).validate()
        self.fanouts = list(self.spec.fanouts)
        self.num_layers = num_layers
        self.weighted = self.spec.weighted
        self.direction = self.spec.direction
        if self.spec.replace and self._submit is None:
            raise ValueError(
                "replace-policy sampling needs a SamplingService backend "
                "(raw clients only support without-replacement draws)"
            )
        self.prefetch = prefetch
        self.inflight = inflight
        # a remote-dispatching service (dist_transport != "inproc") cannot
        # sit behind a forked prefetch producer: the fork would duplicate
        # the worker-pool channel fds, and parent + child reading the same
        # pipes interleaves partial frames.  Thread-mode prefetch keeps the
        # pool's fds in one process (the remote workers provide the real
        # parallelism anyway).
        service = getattr(backend, "service", None)
        remote = service is not None and getattr(service, "dispatcher", None) is not None
        if remote and workers == "process":
            raise ValueError(
                "workers='process' cannot wrap a remote-dispatch sampling "
                "service (forked producer would share the worker-pool "
                "channels); use workers='thread' or dist_transport='inproc'"
            )
        self.workers = (
            (("thread" if remote else "process") if _FORK_AVAILABLE else "thread")
            if workers == "auto"
            else workers
        )
        self.worker_cores = worker_cores
        self.vertex_quantum = vertex_quantum
        self.edge_quantum = edge_quantum
        # the training-side feature path: any FeatureSource (e.g. a
        # disk-backed HybridCache) — batches are bit-identical to the
        # in-memory matrix because the cache only changes where rows live
        self.feature_source = as_feature_source(
            graph.vertex_feats if feature_source is None else feature_source
        )
        self.loader = SeedBatchLoader(
            seeds,
            batch_size,
            seed=seed,
            partition_of=partition_of,
            balance_partitions=balance_partitions,
        )
        # producer-side host seconds (sampling + padding): the
        # ``pipeline.produce`` roots less their hand-off to the queue
        self.sample_time = 0.0
        self.ticket_timeout = ticket_timeout
        self.worker_respawns = int(worker_respawns)
        self.respawn_count = 0  # workers respawned over this pipeline's life
        self._respawns_left = self.worker_respawns
        # request keys are pipeline-owned: (loader seed, running index), so
        # the stream is independent of the service's other consumers
        self._key_base = int(seed) & _KEY_MASK
        self._req_counter = 0
        self._pending = collections.deque()  # (seeds, SampleTicket) in order
        self._proc = None
        self._cmd_q = None
        self._data_q = None
        self._cancel = None  # mp.Event: stop the worker's current run early
        self._run_history: list[int] = []  # epochs of fully produced runs

    # ------------------------------------------------------------------
    def _next_key(self) -> tuple:
        key = (self._key_base, self._req_counter)
        self._req_counter += 1
        return key

    def _submit_ahead(self, seeds: np.ndarray) -> None:
        with tracing.span("sampling.submit"):
            ticket = self._submit(seeds, self.spec, key=self._next_key())
        self._pending.append((seeds, ticket))

    def _take_sample(self, seeds: np.ndarray):
        """The subgraph for one seed batch: the pre-submitted in-flight
        ticket when the look-ahead window holds one, else a fresh request.
        Keys are assigned in batch order either way, so windowed and
        unwindowed streams are bit-identical."""
        if self._pending and np.array_equal(self._pending[0][0], seeds):
            _, ticket = self._pending.popleft()
        elif self._submit is not None:
            with tracing.span("sampling.submit"):
                ticket = self._submit(seeds, self.spec, key=self._next_key())
        else:
            with tracing.span("sampling.wait"):
                return self._sample(
                    seeds, self.fanouts, weighted=self.weighted, direction=self.direction
                )
        with tracing.span("sampling.wait"):
            return ticket.result(timeout=self.ticket_timeout)

    def make_batch(self, seeds: np.ndarray) -> GNNBatch:
        """One seed batch through sampling + padding (numpy, no prefetch)."""
        sub = self._take_sample(seeds)
        with tracing.span("batch.assemble"):
            return subgraph_to_batch(
                sub,
                self.feature_source,
                self.graph.labels,
                self.num_layers,
                edge_types=self.graph.edge_types,
                vertex_quantum=self.vertex_quantum,
                edge_quantum=self.edge_quantum,
            )

    def _seed_stream(self, epochs: int):
        for _ in range(epochs):
            for seeds in self.loader.epoch():
                if self._cancel is not None and self._cancel.is_set():
                    return
                yield seeds

    def _drop_pending(self) -> None:
        """Cancel in-flight window tickets so abandoned requests stop
        consuming scheduler rounds and skewing workload counters."""
        while self._pending:
            _, ticket = self._pending.popleft()
            ticket.cancel()

    def _forward_run(self, epochs: int) -> None:
        """Replay one completed run WITHOUT sampling: consume the seed
        stream (advancing the loader's per-epoch permutation RNG) and burn
        one request key per batch, leaving the producer state exactly
        where a real run would have left it.  Used by a respawned worker
        to fast-forward to the crashed run."""
        for _ in self._seed_stream(epochs):
            if self._submit is not None:
                self._next_key()

    def _produce_np(self, epochs: int, skip: int = 0):
        """The serial producer: pure numpy, safe inside the forked worker.
        With ``inflight >= 2`` and a service backend it keeps a window of
        sample requests in flight ahead of the batch being padded.
        ``skip`` fast-forwards past the first ``skip`` batches (already
        delivered before a worker crash) without sampling them — stream
        positions and request keys are consumed so batch ``i`` keeps key
        ``(seed, i)`` and the remainder is bit-identical.

        The bit-identity contract (any prefetch/inflight depth, shared or
        private service) applies to runs driven to completion: abandoning a
        run mid-epoch leaves the seed loader — and, pre-dating this PR, any
        prefetch look-ahead — at an implementation-defined position, so a
        SUBSEQUENT run on the same pipeline resumes from wherever the
        producer stopped."""
        self._drop_pending()  # stale tickets from an abandoned run
        stream = self._seed_stream(epochs)
        for _ in range(skip):
            if next(stream, None) is None:
                break
            if self._submit is not None:
                self._next_key()
        windowed = self.inflight > 1 and self._submit is not None
        # bounded by construction: the refill loop below never grows it past
        # self.inflight (validated positive), so no maxlen is needed
        queue: collections.deque = collections.deque()  # glint: disable=PRJ005 -- see above
        try:
            while True:
                if windowed:
                    while len(queue) < self.inflight:
                        nxt = next(stream, None)
                        if nxt is None:
                            break
                        self._submit_ahead(nxt)
                        queue.append(nxt)
                    if not queue:
                        return
                    seeds = queue.popleft()
                else:
                    seeds = next(stream, None)
                    if seeds is None:
                        return
                yield seeds, self.make_batch(seeds)
        finally:
            self._drop_pending()

    def _count(self, root: tracing.Root) -> None:
        """Add one ``pipeline.produce`` root to ``sample_time``."""
        self.sample_time += (root.dur_ns - root.self_ns.get("pipeline.put", 0)) / 1e9

    def _produce_roots(self, epochs: int):
        """``_produce_np`` with each batch made inside its own
        ``pipeline.produce`` root, closed before the batch is handed on."""
        items = self._produce_np(epochs)
        try:
            while True:
                with tracing.span("pipeline.produce", root=True) as root:
                    item = next(items, None)
                    if item is None:
                        root.drop()
                        return
                self._count(root.summary)
                yield item
        finally:
            items.close()

    def host_batches(self, epochs: int):
        """Yield ``(seeds, GNNBatch)`` with numpy fields, before any copy
        to a device (the data-parallel trainer merges shards on the host);
        closing the generator stops the producer."""
        if self.prefetch <= 0:
            return self._produce_roots(epochs)
        if self.workers == "process" and _FORK_AVAILABLE:
            return self._process_batches(epochs)
        # thread mode: prefetch_iterator stops and joins its producer when
        # the generator is closed/abandoned, so the shared loader/backend
        # state is never mutated concurrently with a later epoch
        return prefetch_iterator(self._produce_roots(epochs), self.prefetch)

    def batches(self, epochs: int = 1):
        """Yield ``(seeds, GNNBatch)`` with tensors on the pipeline's
        device; sampling runs ahead of the consumer when ``prefetch >= 1``.
        The copies to the device are made here, in the consumer."""
        stream = self.host_batches(epochs)
        try:
            while True:
                with tracing.span("pipeline.next") as root:
                    with tracing.span("pipeline.receive"):
                        item = next(stream, None)
                    if item is None:
                        root.drop()
                        return
                    seeds, batch = item
                    with tracing.span("batch.to_device"):
                        batch = batch.to(self.device)
                yield seeds, batch
        finally:
            stream.close()

    def __iter__(self):
        return self.batches(1)

    # -- process-mode plumbing -----------------------------------------
    def _worker_loop(self):  # runs in the forked child: numpy only, no CUDA
        tracing.forked()
        if self.worker_cores and hasattr(os, "sched_setaffinity"):
            try:
                # dedicate host cores to sampling (the consumer keeps the
                # device cores), like dataloader-worker pinning in DGL
                os.sched_setaffinity(0, set(self.worker_cores))
            except OSError:
                pass
        while True:
            # glint: disable=PRJ004 -- SimpleQueue has no timeout kwarg; an
            # idle worker is stopped via close(), which escalates to kill()
            cmd = self._cmd_q.get()
            if cmd[0] == "stop":
                return
            if cmd[0] == "forward":
                # replay a prior completed run without sampling (respawn
                # fast-forward); ack so the parent can sequence commands
                self._forward_run(cmd[1])
                self._data_q.put(("fwd",))
                continue
            try:
                # a batch's root closes after its put, so its summary rides
                # with the next message
                items = self._produce_np(cmd[1], skip=cmd[2])
                while True:
                    with tracing.span("pipeline.produce") as root:
                        item = next(items, None)
                        if item is None:
                            root.drop()
                            break
                        with tracing.span("pipeline.put"):
                            self._data_q.put(("item", *item, tracing.take()))
                self._data_q.put(("done", tracing.take()))
            except BaseException as exc:  # noqa: BLE001 - re-raised in parent
                self._data_q.put(
                    ("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}")
                )

    def _ensure_worker(self):
        if self._proc is not None and self._proc.is_alive():
            return
        ctx = mp.get_context("fork")
        self._cmd_q = ctx.SimpleQueue()
        self._data_q = ctx.Queue(maxsize=max(1, self.prefetch))
        self._cancel = ctx.Event()
        with warnings.catch_warnings():
            # fork + threads can deadlock; the child touches only numpy
            # state, never CUDA, which is the supported pattern
            warnings.simplefilter("ignore", RuntimeWarning)
            warnings.simplefilter("ignore", DeprecationWarning)
            self._proc = ctx.Process(target=self._worker_loop, daemon=True)
            self._proc.start()

    def _next_msg(self):
        """Queue read that notices a dead worker instead of hanging."""
        while True:
            try:
                return self._data_q.get(timeout=1.0)
            except queue_mod.Empty:
                if self._proc is None or not self._proc.is_alive():
                    code = self._proc.exitcode if self._proc is not None else None
                    self.close()
                    raise RuntimeError(
                        f"prefetch worker died (exit code {code}) without "
                        "reporting an error — likely killed (OOM?) or crashed "
                        "in native code"
                    )

    def _respawn_worker(self, code, epochs: int, delivered: int) -> None:
        """Fork a fresh worker and fast-forward it to the crashed run.

        The fresh child forks from THIS process's pristine producer state
        (the parent never advances the loader/key state in process mode),
        so it replays every previously completed run via cheap ``forward``
        commands, then re-enters the crashed run skipping the ``delivered``
        batches already yielded.  Because sampling randomness is keyed
        ``(seed, batch_index)`` and the skip path consumes exactly the
        stream positions and keys a real run would, the resumed stream is
        bit-identical to an uncrashed one by construction."""
        self._respawns_left -= 1
        self.respawn_count += 1
        _log.warning(
            "prefetch worker died (exit code %s); respawning (%d left in "
            "crash budget) and replaying %d delivered batch(es)",
            code,
            self._respawns_left,
            delivered,
        )
        self._proc = None  # force a fresh fork (with fresh, empty queues)
        self._ensure_worker()
        self._cancel.clear()
        for past_epochs in self._run_history:
            self._cmd_q.put(("forward", past_epochs))
            try:
                msg = self._data_q.get(timeout=60.0)
            except queue_mod.Empty:
                msg = None
            if msg is None or msg[0] != "fwd":
                self.close()
                raise RuntimeError(
                    "respawned prefetch worker failed to replay run history"
                )
        self._cmd_q.put(("produce", epochs, delivered))

    def _read_or_respawn(self, epochs: int, delivered: int):
        """Queue read; a dead worker is respawned (crash budget permitting)
        and told to resume past the batches already delivered."""
        while True:
            try:
                return self._data_q.get(timeout=1.0)
            except queue_mod.Empty:
                if self._proc is not None and self._proc.is_alive():
                    continue
                code = self._proc.exitcode if self._proc is not None else None
                if self._respawns_left <= 0:
                    self.close()
                    raise RuntimeError(
                        f"prefetch worker died (exit code {code}) without "
                        "reporting an error — likely killed (OOM?) or crashed "
                        "in native code"
                        + (
                            f" — crash budget of {self.worker_respawns} "
                            "respawn(s) exhausted"
                            if self.worker_respawns
                            else ""
                        )
                    )
                self._respawn_worker(code, epochs, delivered)

    def _absorb(self, roots: list) -> None:
        """Keep a forked worker's root summaries; count its batches'."""
        tracing.absorb(roots)
        for root in roots:
            if root.name == "pipeline.produce":
                self._count(root)

    def _process_batches(self, epochs: int):
        self._ensure_worker()
        self._cancel.clear()
        self._cmd_q.put(("produce", epochs, 0))
        delivered = 0
        finished = False
        try:
            while True:
                msg = self._read_or_respawn(epochs, delivered)
                if msg[0] == "done":
                    finished = True
                    self._absorb(msg[1])
                    self._run_history.append(epochs)
                    return
                if msg[0] == "error":
                    finished = True
                    self.close()
                    raise RuntimeError(f"prefetch worker failed:\n{msg[1]}")
                _, seeds, batch, roots = msg
                self._absorb(roots)
                delivered += 1
                yield seeds, batch
        finally:
            if not finished and self._proc is not None:
                # consumer stopped early (e.g. max_steps): cancel the run
                # and drain the few in-flight items so the worker is idle
                # (not sampling concurrently) before the next command
                self._cancel.set()
                while True:
                    try:
                        msg = self._next_msg()
                    except RuntimeError:
                        # worker died mid-drain: the run was already being
                        # abandoned, nothing left to recover
                        break
                    if msg[0] == "item":
                        self._absorb(msg[3])
                    if msg[0] == "done":
                        self._absorb(msg[1])
                        # an abandoned run still advanced the worker's
                        # loader/key state; record it so a later respawn
                        # replays it (bit-identity is only contracted for
                        # runs driven to completion — see _produce_np)
                        self._run_history.append(epochs)
                        break
                    if msg[0] == "error":
                        self.close()
                        raise RuntimeError(
                            f"prefetch worker failed:\n{msg[1]}"
                        )

    def close(self, timeout: float = 2.0) -> None:
        """Stop the worker process (no-op for thread/serial modes).

        Bounded: a graceful ``stop`` + join escalates to ``terminate()``
        (SIGTERM) and finally ``kill()`` (SIGKILL), so close() returns even
        when the worker is wedged in native code or ignoring SIGTERM."""
        proc, self._proc = self._proc, None
        if proc is not None and proc.is_alive():
            try:
                self._cmd_q.put(("stop",))
                proc.join(timeout=timeout)
            except (OSError, ValueError) as exc:
                # command queue already torn down (closed pipe / released
                # semaphore); fall through to terminate() below
                _log.debug("graceful worker stop failed: %s", exc)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=timeout)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=timeout)

    def __del__(self):  # best effort; daemon children die with the parent
        try:
            self.close()
        except Exception:
            pass
