"""Data-parallel GNN training over a shard axis on one card.

Counterpart of ``repro/train/data_parallel.py``. The reference shards the
step over a ``jax.sharding`` mesh's data axis and ``vmap``s the per-shard
loss, so XLA runs the S shards as one program. One card has no mesh, only
the shard axis; this trainer keeps the reference's layout up to the step
and then runs the S shards as one batch:

- ``train_ids`` are dealt round-robin into ``S`` shard streams, each with
  its own sampling client (``BatchPipeline``, thread-mode prefetch) over
  the SAME shared backend, seeded ``seed + 7919 * i``: every shard's batch
  stream is deterministic however the service interleaves them, and a
  remote backend's channel fds stay in this process;
- each step takes one padded batch per shard (``host_batches``: rows, no
  counts or orders) and pads them to a common bucket
  (:func:`stack_batches`, bitwise the reference's arrays);
- :func:`merge_shards` lays the S padded batches out block-diagonally as
  one ``GNNBatch``: shard s's vertex rows at ``[s*V, (s+1)*V)``, its edge
  endpoints and seed positions offset by ``s*V`` (``-1`` padding stays
  ``-1``);
- the merged batch is moved to the device and completed there
  (``complete_batch``): its counts and its dst / src orders over the
  merged edge lists, so every shard's padding sorts to the global tail as
  ``GNNModel.layer`` requires;
- the step is one forward and one ``backward()`` over the merged batch, so
  each aggregation kernel launches once per layer whatever S is, and the
  loss is ``CE.view(S, B/S).mean(1).mean()``, the reference's
  ``vmap(loss).mean()`` (every shard has the same seed count); then one
  AdamW update.

A CSR row's sum depends only on that row's own edges (the kernels' order,
``kernels/ref.py::chunked_segment_sum_ref``), and the merged layout
gives every shard rows of its own, so the merged forward's aggregates
are, row for row, those of the shard alone on the same inputs.

``reference=True`` keeps a deep copy of the initial model and optimizer
state and runs the per-shard loop on the very same batches: each shard
moved and completed on its own, its own ``model.loss`` (S launches per
layer), the mean of the S losses, one ``backward()``, AdamW. It logs
those losses as ``ref_losses``: a program other than the merged step, as
the reference's unsharded jit is other than its sharded one.

The initial parameters are the model's own (as ``GNNTrainer``); the model
is trained in place, on ``device``. On a CUDA device the kernels run or
the step raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.api.pipeline import BatchPipeline
from repro_torch.device import resolve_device
from repro_torch.models.gnn.batching import GNNBatch, complete_batch
from repro_torch.train.loop import descend
from repro_torch.train.optim import AdamWConfig, adamw_init

__all__ = ["DataParallelGNNTrainer", "DPTrainLog", "merge_shards", "stack_batches"]

# per-shard pipeline seeds must differ (distinct seed permutations and
# request-key bases) but be derived from one trainer seed; a prime stride
# keeps them disjoint from the service's own replica seeding
_SHARD_SEED_STRIDE = 7919

_INT32_MAX = np.iinfo(np.int32).max


@dataclass
class DPTrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    # per-shard-loop losses (reference=True), same positions
    ref_losses: list = field(default_factory=list)
    # host seconds of each step: its shards' sampling and the merged step
    # (the reference twin's step excluded)
    wall: list = field(default_factory=list)
    # host seconds of the ``trainer.shards`` and ``trainer.compute`` spans
    sample_time: float = 0.0
    compute_time: float = 0.0


def stack_batches(batches: list[GNNBatch]) -> GNNBatch:
    """Stack per-shard numpy ``GNNBatch``es, with their rows, along a new
    leading shard axis.

    Shards sample independently, so their padded bucket shapes may
    differ; every array is first padded to the max bucket across shards
    using the batching pads (zero feature rows, ``valid=False``, edge
    positions ``-1``, edge type ``0``) — semantically inert by the same
    argument as the original padding. The fields the JAX package stacks
    are bitwise its arrays; no counts or orders are stacked
    (``complete_batch`` builds them on the device). Seed counts must match
    (the caller drops ragged tails); stacking never changes any shard's
    rows.
    """
    bs = {b.seed_pos.shape[0] for b in batches}
    if len(bs) != 1:
        raise ValueError(f"shards disagree on seeds per batch: {sorted(bs)}")
    vmax = max(b.feats.shape[0] for b in batches)
    num_layers = len(batches[0].layer_dst)
    emax = [max(b.layer_dst[k].shape[0] for b in batches) for k in range(num_layers)]

    def pad0(arr, n, fill):
        if arr.shape[0] == n:
            return arr
        out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def per_layer(name, fill):
        return [np.stack([pad0(getattr(b, name)[k], emax[k], fill) for b in batches])
                for k in range(num_layers)]

    return GNNBatch(
        feats=np.stack([pad0(b.feats, vmax, 0.0) for b in batches]),
        valid=np.stack([pad0(b.valid, vmax, False) for b in batches]),
        seed_pos=np.stack([b.seed_pos for b in batches]),
        labels=np.stack([b.labels for b in batches]),
        layer_dst=per_layer("layer_dst", -1),
        layer_src=per_layer("layer_src", -1),
        layer_etype=per_layer("layer_etype", 0),
    )


def shard(stacked: GNNBatch, s: int) -> GNNBatch:
    """Shard ``s`` of a stacked batch as a batch of its own (views)."""
    return GNNBatch(
        **{
            name: (
                None if v is None else [a[s] for a in v] if isinstance(v, list) else v[s]
            )
            for name, v in vars(stacked).items()
        }
    )


def merge_shards(stacked: GNNBatch) -> GNNBatch:
    """The S shards of a stacked batch as one block-diagonal ``GNNBatch``:
    shard s's vertex rows at ``[s*V, (s+1)*V)``, its edge endpoints and
    seed positions offset by ``s*V`` (``-1`` stays ``-1``), its edges at
    ``[s*E, (s+1)*E)`` of each layer's list. The seeds come out shard by
    shard, ``B/S`` each."""
    num_shards, rows = stacked.feats.shape[:2]
    edges = max(d.shape[1] for d in stacked.layer_dst)
    if num_shards * max(rows, edges) > _INT32_MAX:
        raise ValueError(
            f"{num_shards} shards of {rows} vertices and {edges} edges overflow "
            "the int32 positions"
        )
    off = (np.arange(num_shards, dtype=np.int32) * np.int32(rows))[:, None]

    def shift(pos):
        return np.where(pos >= 0, pos + off, -1).astype(np.int32).reshape(-1)

    return GNNBatch(
        feats=stacked.feats.reshape(num_shards * rows, -1),
        valid=stacked.valid.reshape(-1),
        seed_pos=(stacked.seed_pos + off).reshape(-1),
        labels=stacked.labels.reshape(-1),
        layer_dst=[shift(d) for d in stacked.layer_dst],
        layer_src=[shift(s) for s in stacked.layer_src],
        layer_etype=[e.reshape(-1) for e in stacked.layer_etype],
    )


class DataParallelGNNTrainer:
    def __init__(
        self,
        model,
        backend,
        graph,
        train_ids: np.ndarray,
        *,
        num_shards: int = 1,
        spec=None,
        fanouts=None,
        batch_size: int = 256,  # GLOBAL batch: split evenly across shards
        opt: AdamWConfig | None = None,
        seed: int = 0,
        prefetch: int = 0,
        inflight: int = 1,
        vertex_quantum: int = 256,
        edge_quantum: int = 1024,
        ticket_timeout: float | None = None,
        reference: bool = False,
        device="cuda",
    ):
        if spec is None and fanouts is None:
            raise ValueError("pass a SamplingSpec or fanouts")
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if batch_size % self.num_shards != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly over "
                f"{self.num_shards} data shard(s)"
            )
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"the model lives on {model.device}, the trainer runs on {self.device}"
            )
        self.model = model
        # one sampling client per shard over the SHARED backend; thread-mode
        # prefetch (the pool's channel fds must stay in this process, and
        # the shards' real parallelism is the remote workers anyway)
        self.pipelines = [
            BatchPipeline(
                backend,
                graph,
                np.asarray(train_ids)[i :: self.num_shards],
                list(spec.fanouts) if spec is not None else list(fanouts),
                model.num_layers,
                batch_size=batch_size // self.num_shards,
                spec=spec,
                prefetch=prefetch,
                inflight=inflight,
                workers="thread",
                seed=seed + _SHARD_SEED_STRIDE * i,
                vertex_quantum=vertex_quantum,
                edge_quantum=edge_quantum,
                ticket_timeout=ticket_timeout,
                device=self.device,
            )
            for i in range(self.num_shards)
        ]
        self.opt_cfg = opt or AdamWConfig(lr=1e-3, weight_decay=1e-4)
        self.opt_state = adamw_init(model.param_tree())
        self.log = DPTrainLog()
        self.reference = reference
        if reference:
            # the twin: its own replica of the same initial parameters and
            # optimizer state
            self.ref_model = copy.deepcopy(model)
            self.ref_opt_state = adamw_init(self.ref_model.param_tree())

    def merged_loss(self, batch: GNNBatch) -> torch.Tensor:
        """The mean over shards of each shard's mean cross-entropy, over a
        merged batch on the device (:func:`merge_shards`)."""
        logits = self.model.apply(batch)
        tgt = logits.gather(1, batch.labels.long()[:, None])[:, 0]
        ce = torch.logsumexp(logits, dim=-1) - tgt
        return ce.view(self.num_shards, -1).mean(1).mean()

    def merged_step(self, batch: GNNBatch) -> torch.Tensor:
        """One step of the model over a merged batch, completed on the
        device; returns the loss (0-d, not waited for)."""
        loss, self.opt_state = descend(
            self.model.param_tree(), lambda: self.merged_loss(batch), self.opt_state,
            self.opt_cfg,
        )
        return loss

    def reference_step(self, stacked: GNNBatch) -> torch.Tensor:
        """One step of the twin: each shard's own loss, their mean."""
        shards = [complete_batch(shard(stacked, s).to(self.device))
                  for s in range(self.num_shards)]
        loss, self.ref_opt_state = descend(
            self.ref_model.param_tree(),
            lambda: torch.stack([self.ref_model.loss(b) for b in shards]).mean(),
            self.ref_opt_state,
            self.opt_cfg,
        )
        return loss

    def train(
        self,
        epochs: int = 1,
        log_every: int = 10,
        max_steps: int | None = None,
    ) -> DPTrainLog:
        streams = [pl.host_batches(epochs) for pl in self.pipelines]
        step = 0
        try:
            while max_steps is None or step < max_steps:
                with tracing.span("trainer.shards") as shards:
                    items = [next(s, None) for s in streams]
                    if any(it is None for it in items):
                        break  # a shard ran dry: drop the ragged tail
                    shard_batches = [b for _, b in items]
                    if len({b.seed_pos.shape[0] for b in shard_batches}) != 1:
                        break  # unequal final partial batches: ragged tail
                    stacked = stack_batches(shard_batches)
                    merged = merge_shards(stacked)
                self.log.sample_time += shards.seconds
                with tracing.span("trainer.compute") as compute:
                    loss = float(self.merged_step(complete_batch(merged.to(self.device))))
                self.log.compute_time += compute.seconds
                self.log.wall.append(shards.seconds + compute.seconds)
                if step % log_every == 0:
                    self.log.steps.append(step)
                    self.log.losses.append(loss)
                    if self.reference:
                        self.log.ref_losses.append(float(self.reference_step(stacked)))
                step += 1
        finally:
            for s in streams:
                close = getattr(s, "close", None)
                if close is not None:
                    close()
        return self.log
