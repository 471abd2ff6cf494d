"""RD training on one card: port of ``icm_tpu/train`` (losses, the dual
optimizer, steps, schedules, checkpoints and the epoch engine)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .engine import AverageMeter, run_training, run_training_with_recovery
from .losses import DetectionICMLoss, RateDistortionLoss, compute_bpp
from .optim import DualOptimizer, TrainState, label_params, make_optimizer, set_trainable
from .schedule import PolyLR, ReduceLROnPlateau
from .steps import make_eval_step, make_train_step

__all__ = [
    "AverageMeter",
    "DetectionICMLoss",
    "DualOptimizer",
    "PolyLR",
    "RateDistortionLoss",
    "ReduceLROnPlateau",
    "TrainState",
    "compute_bpp",
    "label_params",
    "load_checkpoint",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "run_training",
    "run_training_with_recovery",
    "save_checkpoint",
    "set_trainable",
]
