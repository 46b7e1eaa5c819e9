"""The GNN training loop.

Counterpart of ``repro/train/loop.py::GNNTrainer``: the GLISP batch
pipeline (``repro_torch.api.pipeline.BatchPipeline``) feeds padded
minibatches, on the model's device, into an eager step: forward,
``loss.backward()``, the hand-written AdamW update. With ``prefetch >= 1``
host-side sampling runs in a forked worker (or a thread) and overlaps the
device step. ``checkpoint_every > 0`` auto-saves an atomic checkpoint every
N steps; ``resume()`` restores it and ``train()`` fast-forwards the
(deterministic, keyed) batch stream to the saved step. Every operation of
the step gives the same bits on every run (the kernels' backwards use no
float atomics), so a crashed-and-resumed run ends with bit-identical
weights to an uninterrupted one.

The initial parameters are the model's own (``GNNModel`` draws them with
numpy, or :func:`~repro_torch.models.gnn.load_jax_params` loads them);
the JAX trainer draws its own from ``jax.random``, which the port cannot
repeat.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.api.pipeline import BatchPipeline
from repro_torch.core.sampling.service import DEFAULT_DIRECTION
from repro_torch.data.graph_loader import SeedBatchLoader
from repro_torch.models.gnn.models import GNNModel
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)

__all__ = ["GNNTrainer", "TrainLog"]


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    accs: list = field(default_factory=list)
    wall: list = field(default_factory=list)
    sample_time: float = 0.0
    compute_time: float = 0.0


def descend(params, loss_fn, opt_state, opt_cfg: AdamWConfig):
    """One optimizer step in place: clear the gradients of ``params`` (a
    tree of leaf tensors), ``loss_fn().backward()``, then AdamW into the
    same tensors. Returns the loss (0-d, detached, not waited for) and the
    new optimizer state."""
    for p in tree_leaves(params):
        p.grad = None
    loss = loss_fn()
    loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
    new, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg)
    with torch.no_grad():
        for p, q in zip(tree_leaves(params), tree_leaves(new)):
            p.copy_(q)
    return loss.detach(), opt_state


class GNNTrainer:
    def __init__(
        self,
        model: GNNModel,
        client,  # SamplerBackend, SamplingService, or a raw blocking client
        g,
        fanouts,
        train_ids: np.ndarray,
        batch_size: int = 256,
        opt: AdamWConfig | None = None,
        direction: str = DEFAULT_DIRECTION,
        seed: int = 0,
        weighted: bool = False,
        prefetch: int = 0,
        inflight: int = 1,  # in-flight sample requests on the service
        spec=None,  # SamplingSpec; overrides fanouts/weighted/direction
        worker_cores: tuple | None = None,
        partition_of: np.ndarray | None = None,
        balance_partitions: bool = False,
        feature_source=None,  # FeatureSource; None = g.vertex_feats
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,  # steps between auto-checkpoints; 0 = off
        ticket_timeout: float | None = None,
        worker_respawns: int = 1,
    ):
        self.model = model
        self.client = client
        self.g = g
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        if self.checkpoint_every > 0 and checkpoint_dir is None:
            raise ValueError("checkpoint_every > 0 requires a checkpoint_dir")
        self._resume_step = 0
        self.pipeline = BatchPipeline(
            client,
            g,
            train_ids,
            fanouts,
            model.num_layers,
            batch_size=batch_size,
            spec=spec,
            weighted=weighted,
            direction=direction,
            prefetch=prefetch,
            inflight=inflight,
            worker_cores=worker_cores,
            seed=seed,
            partition_of=partition_of,
            balance_partitions=balance_partitions,
            feature_source=feature_source,
            ticket_timeout=ticket_timeout,
            worker_respawns=worker_respawns,
            device=model.device,
        )
        self.fanouts = self.pipeline.fanouts
        self.direction = self.pipeline.direction
        self.loader = self.pipeline.loader
        self.opt_cfg = opt or AdamWConfig(lr=1e-3, weight_decay=1e-4)
        self.opt_state = adamw_init(self.params)
        self.log = TrainLog()

    @property
    def params(self) -> dict:
        """The model's parameters as the JAX tree (trained in place)."""
        return self.model.param_tree()

    def make_batch(self, seeds):
        return self.pipeline.make_batch(seeds)

    def train_step(self, batch) -> torch.Tensor:
        """One step on a batch on the model's device: forward,
        ``loss.backward()``, AdamW. Returns the loss (a 0-d tensor, not
        waited for)."""
        loss, self.opt_state = descend(
            self.params, lambda: self.model.loss(batch), self.opt_state, self.opt_cfg
        )
        return loss

    # -- checkpoint / resume -------------------------------------------------
    @property
    def checkpoint_path(self) -> str:
        if self.checkpoint_dir is None:
            raise ValueError("trainer has no checkpoint_dir")
        return os.path.join(self.checkpoint_dir, "gnn_checkpoint.npz")

    def save(self, path: str | None = None, step: int = 0) -> str:
        """Atomic checkpoint of params + optimizer state (+ step)."""
        return save_checkpoint(
            path or self.checkpoint_path,
            {"params": self.params, "opt": self.opt_state},
            step,
        )

    def resume(self, path: str | None = None) -> int:
        """Restore the latest checkpoint; returns the restored step count.

        The next ``train()`` call fast-forwards its (deterministic, keyed)
        batch stream past the restored steps, so resuming reproduces the
        uninterrupted run bit-for-bit: the skipped batches are never
        recomputed, only their stream positions are consumed."""
        tree, step = load_checkpoint(
            path or self.checkpoint_path,
            {"params": self.params, "opt": self.opt_state},
        )
        with torch.no_grad():
            for p, q in zip(tree_leaves(self.params), tree_leaves(tree["params"])):
                p.copy_(q)
        self.opt_state = tree["opt"]
        self._resume_step = int(step or 0)
        return self._resume_step

    def train(
        self,
        epochs: int = 1,
        log_every: int = 10,
        max_steps: int | None = None,
    ):
        step = 0
        skip = self._resume_step  # batches already trained before resume()
        for seeds, batch in self.pipeline.batches(epochs):
            if max_steps is not None and step >= max_steps:
                break
            if step < skip:
                # replay: consume the stream position without recomputing
                # (the batch itself is identical by keyed construction)
                step += 1
                continue
            t1 = time.perf_counter()
            loss = float(self.train_step(batch))
            t2 = time.perf_counter()
            self.log.compute_time += t2 - t1
            if step % log_every == 0:
                self.log.steps.append(step)
                self.log.losses.append(loss)
            step += 1
            if self.checkpoint_every and step % self.checkpoint_every == 0:
                self.save(step=step)
        self._resume_step = 0
        # producer-side host clock: equals the serial sample_time when
        # prefetch=0; with prefetch it is the OVERLAPPED sampling time
        self.log.sample_time = self.pipeline.sample_time
        return self.log

    @torch.no_grad()
    def evaluate(self, test_ids: np.ndarray, batches: int = 8) -> float:
        loader = SeedBatchLoader(test_ids, self.loader.batch, seed=123)
        accs = []
        for i, seeds in enumerate(loader.epoch()):
            if i >= batches:
                break
            batch = self.make_batch(seeds).to(self.model.device)
            logits = self.model.apply(batch)
            accs.append(float((logits.argmax(-1) == batch.labels.long()).float().mean()))
        return float(np.mean(accs)) if accs else 0.0
