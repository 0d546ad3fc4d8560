"""Training of the port: per-group optimizers and ``fit``."""

from dmel_tpu_torch.training.optim import build_optimizer
from dmel_tpu_torch.training.train import (bce_loss, ce_loss, current_lambd,
                                           eval_step, fit, loss_and_metrics,
                                           train_step)

__all__ = ["bce_loss", "build_optimizer", "ce_loss", "current_lambd",
           "eval_step", "fit", "loss_and_metrics", "train_step"]
