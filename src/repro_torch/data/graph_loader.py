"""Seed-batch loader for GNN training: shuffled epochs over the training set,
optionally emulating DistDGL's balanced-seed setup (equal seeds per
partition, paper §IV-C)."""
from __future__ import annotations

import numpy as np

__all__ = ["SeedBatchLoader"]


class SeedBatchLoader:
    def __init__(
        self,
        train_ids: np.ndarray,
        batch_size: int,
        seed: int = 0,
        partition_of: np.ndarray | None = None,
        balance_partitions: bool = False,
    ):
        self.ids = np.asarray(train_ids)
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.partition_of = partition_of
        self.balance = balance_partitions and partition_of is not None

    def epoch(self):
        if not self.balance:
            order = self.rng.permutation(self.ids)
            for lo in range(0, order.shape[0] - self.batch + 1, self.batch):
                yield order[lo : lo + self.batch]
            return
        # balanced: round-robin across partitions (DistDGL's balanced seeds)
        parts = self.partition_of[self.ids]
        groups = [
            self.rng.permutation(self.ids[parts == p]) for p in np.unique(parts)
        ]
        per = self.batch // len(groups)
        n_batches = min(g.shape[0] // max(1, per) for g in groups)
        for i in range(n_batches):
            chunks = [g[i * per : (i + 1) * per] for g in groups]
            yield np.concatenate(chunks)[: self.batch]
