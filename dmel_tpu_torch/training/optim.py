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


#: optax's Adam constants (torch's defaults)
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


class PackedOptimizer:
    """A scale-free SGD or Adam over a pack's stacked parameters (the
    JAX package's ``optax.sgd(1.0)`` / ``optax.adam(1.0)`` under
    ``jax.vmap``), its update multiplied by a per-leaf, per-trial rate
    and by the trial's ``active`` flag.

    ``params`` maps names to tensors with a leading trial axis of K;
    ``lrs`` maps the same names to (K,) rates (0 freezes a leaf of a
    trial).  Both rules are linear in the rate, so this is each trial's
    own optimizer at its own rates.  Adam's moments and step count
    advance for every trial, active or not, as they do in the JAX
    package's packed step.
    """

    def __init__(self, name: str, params: dict, lrs: dict):
        if name not in _OPTIMIZERS:
            raise ValueError(f"optimizer not found: {name}")
        self.name = name
        self.params = params
        self.lrs = lrs
        self.count = 0
        self.mu = self.nu = None
        if name == "adam":
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self, active: torch.Tensor) -> None:
        """Apply one update from the parameters' ``grad``; ``active``
        (K,) 0/1 masks each trial's update."""
        self.count += 1
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.name == "adam":
                mu, nu = self.mu[n], self.nu[n]
                mu.mul_(_ADAM_B1).add_(g, alpha=1.0 - _ADAM_B1)
                nu.mul_(_ADAM_B2).addcmul_(g, g, value=1.0 - _ADAM_B2)
                mu_hat = mu / (1.0 - _ADAM_B1 ** self.count)
                nu_hat = nu / (1.0 - _ADAM_B2 ** self.count)
                u = -mu_hat / (nu_hat.sqrt() + _ADAM_EPS)
            else:
                u = -g
            scale = (self.lrs[n] * active).reshape(
                (-1,) + (1,) * (p.dim() - 1))
            p.add_(u * scale)
