"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train gnn --config sage-products \
        [--epochs 1] [--scale 0.25] [--seed 0] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train lm --arch gemma-2b \
        [--steps 50] [--batch 8] [--seq 128] [--seed 0] [--ckpt PATH] [--device cpu]

Counterpart of ``repro/launch/train.py``. The GNN mode runs one of the
paper's workloads (``repro_torch.configs.gnn.GNN_CONFIGS``: gcn, sage and
gat on the ``ogbn-products`` stand-in, sage on ``ogbn-paper``, HGT on
``relnet``) on the port's ``GNNTrainer``, on the card unless ``--device
cpu`` asks for the CPU. Its host half (dataset, partition, sampling
client, train/test split) is the reference's, step for step, so both
packages train on the same batches; the parameters come from the model's
numpy draw (``GNNModel.init_numpy(seed)``), never from torch's RNG (the
JAX trainer draws its own from ``jax.random``, which the port cannot
repeat).

The LM mode trains an architecture of the pool at its reduced config
(the reference's ``--reduced`` is a ``store_true`` flag that defaults to
True, so it cannot be turned off; the port keeps that) on the port's
``LMTrainer`` over the synthetic token stream, on the card unless
``--device cpu``; configs fed embeddings exit as the reference's do. The
parameters are drawn from a ``torch.Generator`` seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

__all__ = ["GNNRun", "build_gnn", "run_gnn", "run_lm", "main"]


@dataclass
class GNNRun:
    """What :func:`build_gnn` sets up: the config, the graph, its edge
    partition, the sampling client, the model, the train/test split and
    the trainer over them."""

    cfg: object
    graph: object
    edge_parts: np.ndarray
    client: object
    model: object
    train_ids: np.ndarray
    test_ids: np.ndarray
    trainer: object


def build_gnn(args) -> GNNRun:
    """The reference's ``run_gnn`` up to training: the config's dataset at
    ``args.scale``, its partitioner, one sampling server per part behind a
    gather-apply client, the model on ``args.device`` with the numpy draw
    of ``args.seed``, an 80/20 split of a seeded shuffle, the trainer."""
    from repro_torch.configs.gnn import get_gnn_config
    from repro_torch.core.partition import (
        adadne,
        distributed_ne,
        hash2d_partition,
        random_edge_partition,
    )
    from repro_torch.core.sampling import GatherApplyClient, SamplingServer, VertexRouter
    from repro_torch.graph import build_partitions, named_dataset
    from repro_torch.models.gnn import GNNModel, load_jax_params
    from repro_torch.train import GNNTrainer

    cfg = get_gnn_config(args.config)
    g = named_dataset(
        cfg.dataset, feat_dim=cfg.feat_dim, num_classes=cfg.num_classes,
        seed=args.seed, scale=args.scale,
    )
    print(f"dataset {cfg.dataset}: {g.num_vertices} vertices, {g.num_edges} edges")
    part_fn = {
        "adadne": adadne,
        "dne": distributed_ne,
        "hash2d": hash2d_partition,
        "random": random_edge_partition,
    }[cfg.partitioner]
    ep = part_fn(g, cfg.num_parts, seed=args.seed)
    parts = build_partitions(g, ep, cfg.num_parts)
    client = GatherApplyClient(
        [SamplingServer(p, seed=args.seed) for p in parts],
        VertexRouter(g, ep, cfg.num_parts),
        seed=args.seed,
    )
    model = GNNModel(
        cfg.model,
        cfg.feat_dim,
        hidden=cfg.hidden,
        num_layers=cfg.num_layers,
        num_classes=cfg.num_classes,
        num_heads=cfg.num_heads,
        device=args.device,
    )
    load_jax_params(model, model.init_numpy(args.seed))
    ids = np.arange(g.num_vertices)
    rng = np.random.default_rng(args.seed)
    rng.shuffle(ids)
    n_train = int(0.8 * len(ids))
    trainer = GNNTrainer(
        model, client, g, list(cfg.fanouts), ids[:n_train],
        batch_size=cfg.batch_size, direction=cfg.direction, seed=args.seed,
    )
    return GNNRun(cfg, g, ep, client, model, ids[:n_train], ids[n_train:], trainer)


def run_gnn(args) -> dict:
    """Train ``args.epochs`` epochs of ``args.config`` and evaluate on the
    held-out vertices; prints the reference's summary line and returns
    ``{"losses", "test_acc", "sample_time_s", "compute_time_s"}`` (the
    losses logged every ``args.log_every`` steps)."""
    run = build_gnn(args)
    try:
        log = run.trainer.train(epochs=args.epochs, log_every=args.log_every)
        acc = run.trainer.evaluate(run.test_ids)
    finally:
        run.trainer.pipeline.close()
    print(
        f"final loss {log.losses[-1]:.4f} | test acc {acc:.4f} | "
        f"sample {log.sample_time:.1f}s compute {log.compute_time:.1f}s"
    )
    return {"losses": list(log.losses), "test_acc": acc,
            "sample_time_s": log.sample_time, "compute_time_s": log.compute_time}


def run_lm(args) -> dict:
    """Train ``args.steps`` steps of ``args.arch`` (reduced), as the
    reference's ``run_lm`` does: prints the first and last NLL, saves a
    checkpoint to ``args.ckpt`` if given; returns ``{"steps", "losses",
    "compute_time_s"}``."""
    from repro_torch.configs import get_config
    from repro_torch.train import LMTrainer

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.input_mode == "embeddings":
        raise SystemExit(
            f"{cfg.name} consumes precomputed embeddings; use "
            "python -m repro_torch.launch.serve (transformer decode)"
        )
    tr = LMTrainer(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed, device=args.device)
    log = tr.train(args.steps, log_every=args.log_every)
    print(f"nll: {log.losses[0]:.4f} -> {log.losses[-1]:.4f}")
    if args.ckpt:
        tr.save(args.ckpt, step=args.steps)
        print("checkpoint saved to", args.ckpt)
    return {"steps": list(log.steps), "losses": list(log.losses),
            "compute_time_s": log.compute_time}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train a GNN workload of the paper, or an LM of "
                                             "the pool, on the port.")
    sub = ap.add_subparsers(dest="mode", required=True)
    g = sub.add_parser("gnn")
    g.add_argument("--config", default="sage-products")
    g.add_argument("--epochs", type=int, default=1)
    g.add_argument("--scale", type=float, default=0.25)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--log-every", type=int, default=10)
    g.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    lm = sub.add_parser("lm")
    lm.add_argument("--arch", default="gemma-2b")
    lm.add_argument("--reduced", action="store_true", default=True)  # as the reference's
    lm.add_argument("--steps", type=int, default=50)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--log-every", type=int, default=10)
    lm.add_argument("--ckpt", default="")
    lm.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return run_lm(args) if args.mode == "lm" else run_gnn(args)


if __name__ == "__main__":
    main()
