"""Training: the hand-written optimizers, checkpoints, the GNN trainer
(data-parallel training included) and the LM trainer.

Counterpart of ``repro.train``."""
from repro_torch.train.checkpoint import CheckpointError, load_checkpoint, save_checkpoint
from repro_torch.train.data_parallel import DataParallelGNNTrainer, DPTrainLog, stack_batches
from repro_torch.train.loop import GNNTrainer, LMTrainer, TrainLog
from repro_torch.train.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    sgd_update,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "sgd_update",
    "clip_by_global_norm",
    "CheckpointError",
    "save_checkpoint",
    "load_checkpoint",
    "GNNTrainer",
    "LMTrainer",
    "TrainLog",
    "DataParallelGNNTrainer",
    "DPTrainLog",
    "stack_batches",
]
