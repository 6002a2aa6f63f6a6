from .checkpoint import LAST_NAME, BEST_NAME, load_checkpoint, restore_into, save_checkpoint
from .driver import TrainConfig, TrainResult, train
from .step import Adam, AdamState, make_train_fns

__all__ = [
    "Adam",
    "AdamState",
    "BEST_NAME",
    "LAST_NAME",
    "TrainConfig",
    "TrainResult",
    "load_checkpoint",
    "make_train_fns",
    "restore_into",
    "save_checkpoint",
    "train",
]
