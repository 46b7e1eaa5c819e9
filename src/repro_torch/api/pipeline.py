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
    W``.  CPython's GIL makes a *thread* producer serialize against the
    consumer's Python sections (numpy only releases the GIL for a handful
    of ops), so separate processes are the only way host sampling truly
    runs beside the training step — the same reason DGL/PyTorch
    dataloaders use worker processes.  ``W``
    (:attr:`BatchPipeline.producers`) follows the usable cores: the
    ``worker_cores`` when given, else the process's CPU affinity less one
    core for the consumer, at most ``MAX_PRODUCERS``; one over a raw
    client, whose draws are not keyed.

    A batch crosses in shared memory, not through a pipe: each producer
    owns a ring of ``max(2, prefetch // W)`` slots in an anonymous shared
    mapping made before its fork (not ``/dev/shm``, which containers often
    cap), each slot as large as the largest batch the pipeline can make
    (:attr:`BatchPipeline.slot_bytes`, from :func:`largest_batch`). The
    producer waits for a free slot, writes the batch's arrays into it and
    sends only the seeds, the slot and each array's offset, shape and
    dtype through its queue; a batch larger than a slot raises there. The
    consumer copies the batch out once and frees the slot at once: into
    fresh arrays in :meth:`host_batches`, into one of two reused pinned
    buffers in :meth:`batches` to a CUDA device, which
    :meth:`GNNBatch.to` then copies to the card without pinning again. No
    yielded batch shares memory with a slot or with a later batch: a
    pinned buffer is written again only after the event recorded behind
    its last batch's copies to the card has passed.
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
``batch.assemble``, and in process mode ``pipeline.put``, the wait for a
free slot, then ``pipeline.write``, the copy into it); the consumer takes
each inside one ``pipeline.next`` root (``pipeline.receive``: the message
and the copy out of the slot; ``batch.to_device``). A forked worker's root
summaries ride to the consumer with the batches; ``sample_time`` sums
every producer's roots less their waits for a slot.
"""
from __future__ import annotations

import collections
import itertools
import logging
import math
import mmap
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
import warnings
from dataclasses import fields
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.sampling.service import DEFAULT_DIRECTION, SamplingSpec
from repro_torch.core.storage import as_feature_source
from repro_torch.data.graph_loader import SeedBatchLoader
from repro_torch.device import resolve_device
from repro_torch.models.gnn.batching import GNNBatch, largest_batch, subgraph_to_batch
from repro_torch.utils import prefetch_iterator, round_up

__all__ = ["BatchPipeline"]

_log = logging.getLogger(__name__)

_FORK_AVAILABLE = os.name == "posix" and "fork" in mp.get_all_start_methods()

_KEY_MASK = (1 << 64) - 1

# At most this many producers. On an 8-core H100 host at the benchmark's
# papers100M size the consumer's share of a batch is 6-8 ms to take it out
# of its slot and 1 ms to issue its copies, beside the step's 8-13 ms, so
# the producers (120-220 ms a batch each) set the pace. W = 4 / 5 / 6 in
# turns (30 s, 3 seeds a cell): SAGE 5971-6304 / 7523-7940 / 9262-9487
# seeds/s, GAT 6063-7093 / 7432-7908 / 8613-10834. Five won every pair
# against four in both cells and spread no wider (IQR over median 0.053
# against 0.054 SAGE, 0.061 against 0.169 GAT); six won too, but spread
# 0.229 in GAT, and leaves the consumer one core of the eight.
MAX_PRODUCERS = 5

_ALIGN = 64  # bytes: where each of a slot's arrays may start


def _held(value) -> tuple:
    """The arrays a batch field holds: a list's, one, or none."""
    return tuple(value) if isinstance(value, list) else () if value is None else (value,)


def _arrays(batch: GNNBatch):
    """``batch``'s arrays, field by field, each list in order."""
    for f in fields(batch):
        yield from _held(getattr(batch, f.name))


def _plan(batch: GNNBatch):
    """Where ``batch``'s arrays lie in a slot, one after another at
    ``_ALIGN``-byte steps: ``[(field, listed, [(offset, shape, dtype),
    ...]), ...]``; and the bytes they span."""
    plan, end = [], 0
    for f in fields(batch):
        value = getattr(batch, f.name)
        places = []
        for a in _held(value):
            offset = round_up(end, _ALIGN)
            end = offset + a.nbytes
            places.append((offset, a.shape, a.dtype.str))
        plan.append((f.name, isinstance(value, list), places))
    return plan, end


def _views(buf: np.ndarray, plan) -> GNNBatch:
    """The batch that ``plan`` lays out in the bytes ``buf``, as views."""

    def view(offset, shape, dtype):
        dtype = np.dtype(dtype)
        return buf[offset:offset + math.prod(shape) * dtype.itemsize].view(dtype).reshape(shape)

    return GNNBatch(**{
        name: [view(*p) for p in places] if listed else view(*places[0]) if places else None
        for name, listed, places in plan})


def write_batch(buf: np.ndarray, batch: GNNBatch) -> tuple:
    """Copy ``batch``'s arrays into the bytes ``buf`` as ``_plan`` lays
    them out; return the plan and the bytes used. A batch that does not
    fit raises ``ValueError`` before anything is written."""
    plan, used = _plan(batch)
    if used > buf.shape[0]:
        raise ValueError(f"a batch of {used} bytes does not fit a slot of {buf.shape[0]} bytes")
    for src, dst in zip(_arrays(batch), _arrays(_views(buf, plan))):
        np.copyto(dst, src)
    return plan, used


class _Ring:
    """One producer's slots for finished batches: an anonymous shared
    mapping, made before the fork so that the producer writes the pages
    the consumer reads, and a count of free slots, which the consumer
    raises as it copies each batch out. Slots are taken and freed in turn."""

    def __init__(self, ctx, slots: int, slot_bytes: int):
        self.slots, self.slot_bytes = slots, slot_bytes
        self._map = mmap.mmap(-1, slots * slot_bytes)
        self._buf = np.frombuffer(self._map, np.uint8)
        self.free = ctx.Semaphore(slots)
        self._next = 0  # the producer's next slot

    def _slot(self, index: int) -> np.ndarray:
        return self._buf[index * self.slot_bytes:(index + 1) * self.slot_bytes]

    def write(self, batch: GNNBatch) -> tuple:
        """In the producer, a free slot taken: write ``batch`` into the next
        slot; return where it lies, ``(slot, plan, used)``."""
        slot = self._next
        self._next = (slot + 1) % self.slots
        return (slot, *write_batch(self._slot(slot), batch))

    def read(self, where: tuple, out: np.ndarray) -> GNNBatch:
        """In the consumer: copy the batch at ``where`` into the bytes
        ``out`` and free its slot; the batch as views of ``out``."""
        slot, plan, used = where
        np.copyto(out[:used], self._slot(slot)[:used])
        self.free.release()
        return _views(out, plan)

    def close(self) -> None:
        """Unmap the slots (no view of them outlives ``write`` or ``read``)."""
        self._buf = None
        self._map.close()


class _Pinned:
    """Pinned host buffers that a CUDA consumer copies batches into out of
    the rings, in turn, so that ``GNNBatch.to`` copies them to the card
    without pinning afresh. A buffer is written again only once the event
    recorded after its last batch's copies has passed."""

    def __init__(self, nbytes: int, count: int = 2):
        self._tensors = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                         for _ in range(count)]
        self._events = [None] * count
        self._turn = 0

    def buffer(self, used: int) -> np.ndarray:
        """The next buffer, once the card has read its last batch."""
        if self._events[self._turn] is not None:
            self._events[self._turn].synchronize()
        return self._tensors[self._turn].numpy()

    def moved(self, device) -> None:
        """The copies of the batch in the last buffer given are issued."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._events[self._turn] = event
        self._turn = (self._turn + 1) % len(self._tensors)


class _Producer(NamedTuple):
    """One forked producer: its process, its two queues and its ring."""

    proc: mp.Process
    cmd_q: object  # SimpleQueue: commands to the producer
    data_q: object  # Queue: where its batches lie, in its order
    ring: _Ring


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
        self._pinned = None  # _Pinned: a CUDA consumer's staging buffers

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
        if self._forked:
            return self._process_batches(epochs, lambda used: np.empty(used, np.uint8))
        # thread mode: prefetch_iterator stops and joins its producer when
        # the generator is closed/abandoned, so the shared loader/backend
        # state is never mutated concurrently with a later epoch
        return prefetch_iterator(self._produce_roots(epochs), self.prefetch)

    def batches(self, epochs: int = 1):
        """Yield ``(seeds, GNNBatch)`` with tensors on the pipeline's
        device; sampling runs ahead of the consumer when ``prefetch >= 1``.
        The copies to the device are made here, in the consumer: from
        forked producers to a CUDA device, out of the slot into a reused
        pinned buffer, and from there to the card."""
        pinned = None
        if self._forked and self.device.type == "cuda":
            if self._pinned is None:
                self._pinned = _Pinned(self.slot_bytes)
            pinned = self._pinned
            stream = self._process_batches(epochs, pinned.buffer)
        else:
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
                        if pinned is not None:
                            pinned.moved(self.device)
                yield seeds, batch
        finally:
            stream.close()

    def __iter__(self):
        return self.batches(1)

    # -- process-mode plumbing -----------------------------------------
    @property
    def _forked(self) -> bool:
        """Whether a run's batches come from forked producers."""
        return self.prefetch > 0 and self.workers == "process" and _FORK_AVAILABLE

    @property
    def producers(self) -> int:
        """How many forked producers a process-mode run splits the stream
        over: the usable cores (``worker_cores`` when given, else the
        process's CPU affinity less one core for the consumer), at most
        ``MAX_PRODUCERS``, at least one. One in thread and serial mode, and
        over a raw client, whose draws follow the call order, not keys."""
        if not (self._forked and self._submit is not None):
            return 1
        if self.worker_cores:
            usable = len(set(self.worker_cores))
        elif hasattr(os, "sched_getaffinity"):
            usable = len(os.sched_getaffinity(0)) - 1
        else:
            usable = (os.cpu_count() or 1) - 1
        return max(1, min(usable, MAX_PRODUCERS))

    @property
    def slot_bytes(self) -> int:
        """Bytes of one ring slot: the span of the largest batch this
        pipeline can make (:func:`largest_batch`), in whole pages."""
        biggest = largest_batch(self.feature_source.num_rows, self.feature_source.dim,
                                self.loader.batch, self.fanouts, self.num_layers,
                                self.vertex_quantum, self.edge_quantum)
        return round_up(_plan(biggest)[1], mmap.PAGESIZE)

    def _worker_loop(self, index: int, count: int, ring: _Ring, cmd_q, data_q):
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
                        seeds, batch = item
                        with tracing.span("pipeline.put"):
                            ring.free.acquire()
                        with tracing.span("pipeline.write"):
                            where = ring.write(batch)
                        data_q.put(("item", seeds, where, tracing.take()))
                data_q.put(("done", tracing.take()))
            except BaseException as exc:  # noqa: BLE001 - re-raised in parent
                data_q.put(
                    ("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}")
                )

    def _fork(self, index: int) -> None:
        """Fork producer ``index`` from this process's state, with fresh
        queues and a fresh ring of ``prefetch // W`` slots (two at least:
        one filled while the consumer reads another); a producer holds at
        most one more finished batch, waiting for a slot."""
        ctx = mp.get_context("fork")
        count = len(self._producers)
        slots = max(2, self.prefetch // count)
        ring = _Ring(ctx, slots, self.slot_bytes)
        cmd_q = ctx.SimpleQueue()
        # the ring bounds the items queued; one more for the end of a run
        data_q = ctx.Queue(maxsize=slots + 1)
        with warnings.catch_warnings():
            # fork + threads can deadlock; the child touches only numpy
            # state, never CUDA, which is the supported pattern
            warnings.simplefilter("ignore", RuntimeWarning)
            warnings.simplefilter("ignore", DeprecationWarning)
            proc = ctx.Process(target=self._worker_loop,
                               args=(index, count, ring, cmd_q, data_q), daemon=True)
            proc.start()
        self._producers[index] = _Producer(proc, cmd_q, data_q, ring)

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
            producer.ring.close()
            self._fork(index)
            self._producers[index].cmd_q.put(("produce", epochs, delivered))

    def _absorb(self, roots: list) -> None:
        """Keep a forked worker's root summaries; count its batches'."""
        tracing.absorb(roots)
        for root in roots:
            if root.name == "pipeline.produce":
                self._count(root)

    def _process_batches(self, epochs: int, out):
        """Batch ``i`` of the run from producer ``i mod W``, copied out of
        its slot into ``out(used)``, bytes the consumer owns. After the run
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
                seeds, where, roots = rest
                batch = self._producers[index].ring.read(where, out(where[2]))
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
                    producer.ring.free.release()
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
        forked = [p for p in self._producers if p is not None]
        producers = [p for p in forked if p.proc.is_alive()]
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
                break
            for proc in left:
                if escalate is not None:
                    getattr(proc, escalate)()
            deadline = time.monotonic() + timeout
            for proc in left:
                proc.join(timeout=max(0.0, deadline - time.monotonic()))
        for producer in forked:
            producer.ring.close()

    def __del__(self):  # best effort; daemon children die with the parent
        try:
            self.close()
        except Exception:
            pass
