"""GNN experiment configs — the paper's own workloads (Table II/IV, Fig. 9-15).

Each entry reproduces one of GLISP's evaluation settings at laptop scale:
dataset stand-in, partition count, model, fanouts (the paper uses [15,10,5]
with hidden 256, 3 layers, GAT 4 heads; RelNet uses a 2-layer HGT-128 KGE).
Copy of ``repro/configs/gnn.py``; ``to_glisp_config`` builds the port's
``GLISPConfig``.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class GNNExperimentConfig:
    name: str
    dataset: str
    num_parts: int
    model: str = "sage"  # gcn | sage | gat | hgt
    hidden: int = 256
    num_layers: int = 3
    num_heads: int = 4
    fanouts: tuple = (15, 10, 5)
    feat_dim: int = 64
    num_classes: int = 16
    batch_size: int = 256
    partitioner: str = "adadne"  # adadne | dne | hash2d | random | ldg
    weighted: bool = False
    direction: str = "out"


    def to_glisp_config(self, **overrides):
        """System half of this experiment as a ``repro_torch.api.GLISPConfig``
        (the model half stays here: model/hidden/num_layers/num_heads)."""
        from repro_torch.api import GLISPConfig

        sampler = "edge_cut" if self.partitioner == "ldg" else "gather_apply"
        cfg = GLISPConfig(
            num_parts=self.num_parts,
            partitioner=self.partitioner,  # validate() rejects unknown names
            sampler=sampler,
            fanouts=tuple(self.fanouts),
            weighted=self.weighted,
            direction=self.direction,
            batch_size=self.batch_size,
        )
        if overrides:
            cfg = cfg.replace(**overrides)
        return cfg.validate()


GNN_CONFIGS = {
    "gcn-products": GNNExperimentConfig(
        name="gcn-products", dataset="ogbn-products", num_parts=2, model="gcn"
    ),
    "sage-products": GNNExperimentConfig(
        name="sage-products", dataset="ogbn-products", num_parts=2, model="sage"
    ),
    "gat-products": GNNExperimentConfig(
        name="gat-products", dataset="ogbn-products", num_parts=2, model="gat"
    ),
    "sage-paper": GNNExperimentConfig(
        name="sage-paper", dataset="ogbn-paper", num_parts=8, model="sage"
    ),
    "hgt-relnet": GNNExperimentConfig(
        name="hgt-relnet",
        dataset="relnet",
        num_parts=8,
        model="hgt",
        hidden=128,
        num_layers=2,
        fanouts=(10, 5),
    ),
}


def get_gnn_config(name: str) -> GNNExperimentConfig:
    return GNN_CONFIGS[name]
