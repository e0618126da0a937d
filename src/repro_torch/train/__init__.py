from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm, stochastic_round_bf16
from .train_step import TrainState, make_train_step
from .data import DataPipeline
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "stochastic_round_bf16",
    "TrainState",
    "make_train_step",
    "DataPipeline",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
