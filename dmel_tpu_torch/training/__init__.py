"""Training of the port: per-group optimizers, ``fit`` with its
checkpoints and resume, ``predict`` at a state's geometry."""

from dmel_tpu_torch.training.checkpoint import (import_panns_cnn6,
                                                load_checkpoint,
                                                save_checkpoint)
from dmel_tpu_torch.training.optim import build_optimizer
from dmel_tpu_torch.training.train import (bce_loss, ce_loss, current_lambd,
                                           eval_step, fit, loss_and_metrics,
                                           predict, train_step)

__all__ = ["bce_loss", "build_optimizer", "ce_loss", "current_lambd",
           "eval_step", "fit", "import_panns_cnn6", "load_checkpoint",
           "loss_and_metrics", "predict", "save_checkpoint", "train_step"]
