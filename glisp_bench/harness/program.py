"""The system under test, reached through its public entry points: the
port ``repro_torch`` (``GLISPSystem.build``, ``GNNModel``, the trainer's
AdamW settings), built from a configuration file and the run's seed."""
from __future__ import annotations

__all__ = ["build_system", "make_model", "adamw", "copy_weights"]


def build_system(cfg: dict, arrays: dict, seed: int):
    """``GLISPSystem.build`` over the graph ``arrays`` with the
    configuration's partitioner, sampling, batch, storage and serving
    settings; ``seed`` keys its partitioner and sampling streams."""
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph.graph import HeteroGraph

    g = HeteroGraph(**arrays)
    gcfg = GLISPConfig(
        num_parts=cfg["num_parts"],
        partitioner=cfg["partitioner"],
        fanouts=tuple(cfg["fanouts"]),
        batch_size=cfg["batch_size"],
        prefetch=cfg["prefetch"],
        infer_batch_size=cfg["infer_batch_size"],
        serve_queue_depth=cfg["serve_queue_depth"],
        serve_max_batch_delay_ms=cfg["serve_max_batch_delay_ms"],
        serve_deadline_ms=cfg["serve_deadline_ms"],
        seed=int(seed),
    )
    return GLISPSystem.build(g, gcfg)


def copy_weights(model, weights: dict) -> None:
    """Copy the benchmark's weight tree into ``model``'s parameters."""
    import torch

    tree = model.param_tree()
    with torch.no_grad():
        tree["out"].copy_(weights["out"])
        for mine, theirs in zip(tree["layers"], weights["layers"]):
            if set(mine) != set(theirs):
                raise ValueError(f"weight keys {sorted(theirs)} != the model's {sorted(mine)}")
            for name, p in mine.items():
                p.copy_(theirs[name])


def make_model(cfg: dict, weights: dict, device):
    """The configuration's ``GNNModel`` on ``device`` with ``weights``."""
    from repro_torch.models.gnn import GNNModel

    model = GNNModel(cfg["model"], cfg["feat_dim"], hidden=cfg["hidden"],
                     num_layers=cfg["num_layers"], num_classes=cfg["num_classes"],
                     num_heads=cfg["num_heads"], device=device)
    copy_weights(model, weights)
    return model


def adamw(cfg: dict):
    """The trainer's AdamW, as the configuration states it."""
    from repro_torch.train.optim import AdamWConfig

    return AdamWConfig(**cfg["optimizer"])
