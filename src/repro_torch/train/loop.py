"""The training loops: GNN and causal LM.

Counterpart of ``repro/train/loop.py::GNNTrainer``: the GLISP batch
pipeline (``repro_torch.api.pipeline.BatchPipeline``) feeds padded
minibatches, on the model's device, into an eager step: forward,
``loss.backward()``, the hand-written AdamW update. With ``prefetch >= 1``
host-side sampling runs in forked producers (or a thread) and overlaps the
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

``LMTrainer`` is the counterpart of ``repro/train/loop.py::LMTrainer``:
causal-LM training on the synthetic token stream (``repro_torch.data.
tokens``, the reference's batches bit for bit), each step ``lm_loss``
(per-layer remat by default) then the same :func:`descend`. On the card
attention and the SSD scan run forward and backward as the port's
kernels. Its parameters are float32 master weights, as the reference
trainer's are: the forward casts each to the config's dtype at use
(``mm``, ``rms_norm``, the embedding and the head), so a bf16 config
computes in bf16 while AdamW updates float32 weights with float32 moments.
They are drawn from an explicit ``torch.Generator`` (or given: parity
tests load the reference's through ``models.transformer.model.
load_jax_params`` of a float32 config).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.api.pipeline import BatchPipeline
from repro_torch.core.sampling.service import DEFAULT_DIRECTION
from repro_torch.data.graph_loader import SeedBatchLoader
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.device import resolve_device
from repro_torch.models.gnn.models import GNNModel
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import Params
from repro_torch.models.transformer.model import init_params, lm_loss
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)

__all__ = ["GNNTrainer", "LMTrainer", "TrainLog", "descend"]


@dataclass
class TrainLog:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    accs: list = field(default_factory=list)
    wall: list = field(default_factory=list)
    # host seconds: the producer's (``BatchPipeline.sample_time``) and the
    # ``trainer.compute`` spans (each step and the read of its loss)
    sample_time: float = 0.0
    compute_time: float = 0.0


def descend(params, loss_fn, opt_state, opt_cfg: AdamWConfig):
    """One optimizer step in place: clear the gradients of ``params`` (a
    tree of leaf tensors), ``loss_fn().backward()``, then AdamW into the
    same tensors and moments. Returns the loss (0-d, detached, not waited
    for) and the new optimizer state. The step is a ``trainer.step`` span
    with ``trainer.forward``, ``trainer.backward`` and ``trainer.update``
    inside: the host's time issuing each, since nothing here waits on the
    device."""
    with tracing.span("trainer.step"):
        for p in tree_leaves(params):
            p.grad = None
        with tracing.span("trainer.forward"):
            loss = loss_fn()
        with tracing.span("trainer.backward"):
            loss.backward()
        with tracing.span("trainer.update"):
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                             params)
            _, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg)
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
            with tracing.span("trainer.compute") as compute:
                loss = float(self.train_step(batch))
            self.log.compute_time += compute.seconds
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


class LMTrainer:
    def __init__(
        self,
        cfg: ArchConfig,
        batch: int,
        seq_len: int,
        opt: AdamWConfig | None = None,
        seed: int = 0,
        remat: bool = True,
        *,
        device="cuda",
        generator: torch.Generator | None = None,
        params: Params | None = None,
    ):
        """``generator`` draws the initial float32 parameters (default: one
        on ``device`` seeded with ``seed``); ``params`` replaces them (a
        tree from ``init_params`` or ``load_jax_params``, trained in
        place)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat
        self.stream = SyntheticTokenStream(cfg.vocab_size, batch, seq_len, seed)
        self.opt_cfg = opt or AdamWConfig(lr=3e-4)
        if params is None:
            gen = generator or torch.Generator(self.device).manual_seed(seed)
            params = init_params(dataclasses.replace(cfg, dtype="float32"), gen, self.device)
        self.params = params
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.opt_state = adamw_init(self.params)
        self.log = TrainLog()

    def train_step(self, inputs: torch.Tensor, targets: torch.Tensor):
        """One step on a batch on the trainer's device: ``lm_loss``, its
        backward, AdamW. Returns (loss, nll), 0-d tensors not waited for."""
        out = {}

        def loss_fn():
            loss, (nll, _) = lm_loss(self.params, self.cfg, inputs, targets, remat=self.remat)
            out["nll"] = nll.detach()
            return loss

        loss, self.opt_state = descend(self.params, loss_fn, self.opt_state, self.opt_cfg)
        return loss, out["nll"]

    def train(self, steps: int, log_every: int = 10):
        for s in range(steps):
            inp, tgt = self.stream.next_batch()
            with tracing.span("trainer.compute") as compute:
                _, nll = self.train_step(torch.as_tensor(inp, device=self.device).long(),
                                         torch.as_tensor(tgt, device=self.device).long())
                nll = float(nll)
            self.log.compute_time += compute.seconds
            if s % log_every == 0 or s == steps - 1:
                self.log.steps.append(s)
                self.log.losses.append(nll)
        return self.log

    def save(self, path: str, step: int = 0) -> str:
        return save_checkpoint(path, {"params": self.params, "opt": self.opt_state}, step)
