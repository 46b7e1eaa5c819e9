"""Training: the hand-written optimizers, checkpoints and the GNN trainer.

Counterpart of ``repro.train`` for the GNN side, data-parallel training
included; the LM trainer comes in a later slice."""
from repro_torch.train.checkpoint import CheckpointError, load_checkpoint, save_checkpoint
from repro_torch.train.data_parallel import DataParallelGNNTrainer, DPTrainLog, stack_batches
from repro_torch.train.loop import GNNTrainer, TrainLog
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
    "TrainLog",
    "DataParallelGNNTrainer",
    "DPTrainLog",
    "stack_batches",
]
