"""The fused batch pipeline: seed loading -> K-hop sampling -> padded batch.

Counterpart of ``repro/api/pipeline.py``: the same host code (numpy),
with batches copied to the model's device in the consumer
(:meth:`GNNBatch.to`, pinned non-blocking copies). The forked producers
stay numpy-only and never touch ``torch.cuda``, which is what makes
forking a process that has initialised CUDA safe.

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

``process`` (default on POSIX) — ``W`` persistent forked producers own
    copies of the sampling state and split the one keyed stream between
    them: producer ``j`` makes the batches ``j, j + W, j + 2W, ...`` and
    passes over the others' seed positions and request keys without
    sampling them; the consumer takes batch ``i`` from producer ``i mod
    W``'s bounded queue.  CPython's GIL makes a *thread* producer
    serialize against the consumer's Python sections (numpy only
    releases the GIL for a handful of ops), so separate processes are
    the only way host sampling truly runs beside the training step — the
    same reason DGL/PyTorch dataloaders use worker processes.  ``W``
    (:attr:`BatchPipeline.producers`) follows the usable cores: the
    ``worker_cores`` when given, else the process's CPU affinity less one
    core for the consumer, at most ``MAX_PRODUCERS``; one over a raw
    client, whose draws are not keyed.
``thread`` — in-process double buffering via one daemon thread.
    Zero-copy hand-off, but overlap is limited to the consumer's
    GIL-released windows.

Determinism: every producer (process or thread) runs the serial code path
from the same initial state, and sampling randomness is keyed per request
``(seed, batch_index)``, so the batch stream is bit-identical to
``prefetch=0`` for ANY number of producers and ANY ``inflight`` depth
(tested for the reference in tests/test_api.py and tests/test_service.py,
for the port in tests/test_torch_train.py). A process-mode run stopped
early stops its producers and leaves the pipeline where the serial one
stops after the batches delivered, so the next run is bit-identical too.
Note that in process mode the sampling-server stats live in the workers, so
read workload counters with ``prefetch=0`` pipelines.

Spans (``repro_torch.tracing``): the producer makes each batch inside one
``pipeline.produce`` root (``sampling.submit``, ``sampling.wait``,
``batch.assemble``, and in process mode ``pipeline.put``); the consumer
takes each inside one ``pipeline.next`` root (``pipeline.receive``,
``batch.to_device``). A forked worker's root summaries ride to the
consumer with the batches; ``sample_time`` sums every producer's roots.
"""
from __future__ import annotations

import collections
import itertools
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
import warnings
from typing import NamedTuple

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

# Producers beyond this many wait on the consumer: on an 8-core H100 host at
# the benchmark's papers100M size one producer makes 6.6 batches/s and four
# make 31.5, while the consumer's own share of a batch (reading and
# unpickling 19 MB, to_device, a step's issue: 40-80 ms) holds training to
# 10-25 batches/s; six producers trained no faster than four.
MAX_PRODUCERS = 4


class _Producer(NamedTuple):
    """One forked producer: its process and its two queues."""

    proc: mp.Process
    cmd_q: object  # SimpleQueue: commands to the producer
    data_q: object  # Queue: its batches, in its order


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
        crash budget for the forked producers: a producer found dead
        mid-run is respawned up to this many times (all producers
        together), replaying the keyed seed stream past the batches
        already delivered — the resumed stream is bit-identical by
        construction (see ``_read``). ``worker_respawns=0`` fails fast."""
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
        self._producers: list = []  # _Producer, in process mode
        self._cancel = None  # mp.Event: stop the producers' current run early

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
            yield from self.loader.epoch()

    def _drop_pending(self) -> None:
        """Cancel in-flight window tickets so abandoned requests stop
        consuming scheduler rounds and skewing workload counters."""
        while self._pending:
            _, ticket = self._pending.popleft()
            ticket.cancel()

    def _forward(self, epochs: int, positions: int | None = None) -> None:
        """Consume the first ``positions`` batch positions of a run of
        ``epochs`` (all of them when None) WITHOUT sampling: the seed
        stream (advancing the loader's per-epoch permutation RNG) and one
        request key a position, where a serial run over them leaves the
        producer state."""
        for _ in itertools.islice(self._seed_stream(epochs), positions):
            if self._submit is not None:
                self._next_key()

    def _produce_np(self, epochs: int, skip: int = 0, index: int = 0, count: int = 1):
        """The serial producer: pure numpy, safe inside a forked worker.
        With ``inflight >= 2`` and a service backend it keeps a window of
        sample requests in flight ahead of the batch being padded.

        It makes the batches ``i`` with ``i >= skip`` and ``i % count ==
        index`` (producer ``index`` of ``count``); every other position only
        consumes its seeds and its request key, without sampling, so batch
        ``i`` keeps key ``(seed, i)`` and each batch made is bit-identical
        to the serial stream's.

        The bit-identity contract (any prefetch/inflight depth, any number
        of producers, shared or private service) covers runs driven to
        completion, and in process mode also a run stopped early: the next
        run starts where the serial pipeline stopped after the batches
        delivered (``_abandon``). A thread producer stopped early leaves
        the loader wherever it had run ahead to."""
        self._drop_pending()  # stale tickets from an abandoned run
        keyed = self._submit is not None
        windowed = self.inflight > 1 and keyed

        def mine():
            for pos, seeds in enumerate(self._seed_stream(epochs)):
                if self._cancel is not None and self._cancel.is_set():
                    return
                if pos >= skip and pos % count == index:
                    if windowed:
                        self._submit_ahead(seeds)
                    yield seeds
                elif keyed:
                    self._next_key()

        stream = mine()
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
    @property
    def producers(self) -> int:
        """How many forked producers a process-mode run splits the stream
        over: the usable cores (``worker_cores`` when given, else the
        process's CPU affinity less one core for the consumer), at most
        ``MAX_PRODUCERS``, at least one. One in thread and serial mode, and
        over a raw client, whose draws follow the call order, not keys."""
        if not (self.workers == "process" and _FORK_AVAILABLE and self.prefetch > 0
                and self._submit is not None):
            return 1
        if self.worker_cores:
            usable = len(set(self.worker_cores))
        elif hasattr(os, "sched_getaffinity"):
            usable = len(os.sched_getaffinity(0)) - 1
        else:
            usable = (os.cpu_count() or 1) - 1
        return max(1, min(usable, MAX_PRODUCERS))

    def _worker_loop(self, index: int, count: int, cmd_q, data_q):
        """Producer ``index`` of ``count``, in the forked child: numpy
        only, no CUDA."""
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
            cmd = cmd_q.get()
            if cmd[0] == "stop":
                return
            try:
                # a batch's root closes after its put, so its summary rides
                # with the next message
                items = self._produce_np(cmd[1], skip=cmd[2], index=index, count=count)
                while True:
                    with tracing.span("pipeline.produce") as root:
                        item = next(items, None)
                        if item is None:
                            root.drop()
                            break
                        with tracing.span("pipeline.put"):
                            data_q.put(("item", *item, tracing.take()))
                data_q.put(("done", tracing.take()))
            except BaseException as exc:  # noqa: BLE001 - re-raised in parent
                data_q.put(
                    ("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}")
                )

    def _fork(self, index: int) -> None:
        """Fork producer ``index`` from this process's state, with fresh
        queues; its finished batches wait in ``prefetch // W`` slots (one
        at least), so about ``max(prefetch, W)`` in all."""
        ctx = mp.get_context("fork")
        count = len(self._producers)
        cmd_q = ctx.SimpleQueue()
        data_q = ctx.Queue(maxsize=max(1, self.prefetch // count))
        with warnings.catch_warnings():
            # fork + threads can deadlock; the child touches only numpy
            # state, never CUDA, which is the supported pattern
            warnings.simplefilter("ignore", RuntimeWarning)
            warnings.simplefilter("ignore", DeprecationWarning)
            proc = ctx.Process(target=self._worker_loop, args=(index, count, cmd_q, data_q),
                               daemon=True)
            proc.start()
        self._producers[index] = _Producer(proc, cmd_q, data_q)

    def _ensure_producers(self) -> None:
        """Fork ``producers`` producers unless every one is alive."""
        if self._producers and all(p.proc.is_alive() for p in self._producers):
            return
        self.close()
        self._cancel = mp.get_context("fork").Event()
        self._producers = [None] * self.producers
        for index in range(len(self._producers)):
            self._fork(index)

    def _read(self, index: int, epochs: int, delivered: int):
        """The next message of producer ``index``. A dead producer is
        respawned (crash budget permitting) and resumes the run at the
        ``delivered``-th batch: the parent still holds the state the run
        started from, and every batch before that one has reached the
        consumer, so the resumed stream is bit-identical to an uncrashed
        one by construction (keys ``(seed, batch_index)``)."""
        while True:
            producer = self._producers[index]
            try:
                return producer.data_q.get(timeout=1.0)
            except queue_mod.Empty:
                if producer.proc.is_alive():
                    continue
            code = producer.proc.exitcode
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
            self._respawns_left -= 1
            self.respawn_count += 1
            _log.warning(
                "prefetch worker %d died (exit code %s); respawning (%d left in "
                "crash budget) past %d delivered batch(es)",
                index,
                code,
                self._respawns_left,
                delivered,
            )
            self._fork(index)
            self._producers[index].cmd_q.put(("produce", epochs, delivered))

    def _absorb(self, roots: list) -> None:
        """Keep a forked worker's root summaries; count its batches'."""
        tracing.absorb(roots)
        for root in roots:
            if root.name == "pipeline.produce":
                self._count(root)

    def _process_batches(self, epochs: int):
        """Batch ``i`` of the run from producer ``i mod W``. After the run
        the parent moves its own state to where the run left the stream
        (``_forward``), so later forks start from there."""
        self._ensure_producers()
        self._cancel.clear()
        for producer in self._producers:
            producer.cmd_q.put(("produce", epochs, 0))
        count = len(self._producers)
        running = set(range(count))  # producers that have not ended the run
        delivered = 0
        finished = False
        try:
            while True:
                index = delivered % count
                kind, *rest = self._read(index, epochs, delivered)
                if kind != "item":
                    break
                seeds, batch, roots = rest
                self._absorb(roots)
                delivered += 1
                yield seeds, batch
            # the stream ended at its `delivered`-th batch: so does every
            # producer's share of it
            for other in [index] + sorted(running - {index}):
                if other != index:
                    kind, *rest = self._read(other, epochs, delivered)
                running.discard(other)
                if kind != "done":
                    raise RuntimeError(f"prefetch worker failed:\n{rest[0]}")
                self._absorb(rest[0])
            finished = True
        finally:
            if finished:
                self._forward(epochs)
            else:
                self._abandon(epochs, delivered, running)

    def _abandon(self, epochs: int, delivered: int, running: set) -> None:
        """End a run that stopped early (e.g. max_steps) or failed: cancel
        it, drain the producers still making batches (their roots kept),
        stop them all, and leave the parent where a serial pipeline stops
        after ``delivered`` batches, so the next run's stream does not
        depend on how far the producers had run ahead."""
        if self._cancel is not None:
            self._cancel.set()
        error = None
        for index in sorted(running):
            if index >= len(self._producers):
                break  # closed: a producer died past the crash budget
            producer = self._producers[index]
            while True:
                try:
                    kind, *rest = producer.data_q.get(timeout=1.0)
                except queue_mod.Empty:
                    if producer.proc.is_alive():
                        continue
                    break  # died mid-drain: nothing left to recover
                if kind == "item":
                    self._absorb(rest[2])
                    continue
                if kind == "done":
                    self._absorb(rest[0])
                elif error is None:
                    error = rest[0]
                break
        self.close()
        # a serial windowed producer has pulled inflight - 1 batches ahead
        windowed = self.inflight > 1 and self._submit is not None and delivered > 0
        self._forward(epochs, delivered + self.inflight - 1 if windowed else delivered)
        if error is not None:
            raise RuntimeError(f"prefetch worker failed:\n{error}")

    def close(self, timeout: float = 2.0) -> None:
        """Stop every producer process (no-op for thread/serial modes).

        Bounded: a graceful ``stop`` + join escalates to ``terminate()``
        (SIGTERM) and finally ``kill()`` (SIGKILL), each step within one
        ``timeout`` for all the producers, so close() returns even when a
        producer is wedged in native code or ignoring SIGTERM."""
        producers = [p for p in self._producers if p is not None and p.proc.is_alive()]
        self._producers = []
        for producer in producers:
            try:
                producer.cmd_q.put(("stop",))
            except (OSError, ValueError) as exc:
                # command queue already torn down (closed pipe / released
                # semaphore); terminate() below stops it
                _log.debug("graceful worker stop failed: %s", exc)
        for escalate in (None, "terminate", "kill"):
            left = [p.proc for p in producers if p.proc.is_alive()]
            if not left:
                return
            for proc in left:
                if escalate is not None:
                    getattr(proc, escalate)()
            deadline = time.monotonic() + timeout
            for proc in left:
                proc.join(timeout=max(0.0, deadline - time.monotonic()))

    def __del__(self):  # best effort; daemon children die with the parent
        try:
            self.close()
        except Exception:
            pass
