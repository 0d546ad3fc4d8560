"""Optimizers with per-group learning rates (counterpart of
``dmel_tpu/training/optim.py``): ``lambd`` at ``lr_tf``, every other
parameter at ``lr_model``; plain SGD or Adam with torch's defaults,
which optax's match.
"""

from __future__ import annotations

import torch

_OPTIMIZERS = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}


def build_optimizer(config: dict, model: torch.nn.Module):
    """The optimizer ``config`` names over ``model``'s parameters, in two
    groups: every parameter named ``lambd`` at ``lr_tf``, the rest at
    ``lr_model``.

    ``trainable=False`` freezes ``lambd`` (``requires_grad_(False)``,
    so the forward asks no gradient of it) and sets its group's rate to
    0, as ``optax.set_to_zero`` does.
    """
    name = config["optimizer_name"]
    if name not in _OPTIMIZERS:
        raise ValueError(f"optimizer not found: {name}")
    trainable = bool(config.get("trainable", True))
    lr_model = float(config["lr_model"])
    lr_tf = float(config["lr_tf"]) if trainable else 0.0
    tf, rest = [], []
    for pname, p in model.named_parameters():
        (tf if pname.rpartition(".")[2] == "lambd" else rest).append(p)
    if not trainable:
        for p in tf:
            p.requires_grad_(False)
    return _OPTIMIZERS[name]([{"params": tf, "lr": lr_tf},
                              {"params": rest, "lr": lr_model}],
                             lr=lr_model)
