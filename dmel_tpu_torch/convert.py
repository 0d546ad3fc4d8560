"""Carry weights from the JAX package's models into the port.

:func:`from_jax_variables` takes the ``params`` and ``batch_stats``
trees of a flax model as nested dicts of numpy arrays (what
``jax.device_get`` returns) and gives the matching torch
``state_dict``.  Module names are the same in both packages, so the
map is per leaf:

- conv kernels HWIO -> OIHW, Dense kernels ``(in, out)`` -> ``(out, in)``,
  both named ``weight``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and the
  statistics ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``lambd`` stays ``lambd``.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value, dtype=np.float32)


def _param(path: str, a: np.ndarray):
    module, _, leaf = path.rpartition(".")
    prefix = module + "." if module else ""
    if leaf == "kernel":
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"{path}: kernel of rank {a.ndim}")
        return prefix + "weight", a
    if leaf == "scale":
        return prefix + "weight", a
    if leaf in ("bias", "lambd"):
        return path, a
    raise ValueError(f"{path}: no torch counterpart")


def from_jax_variables(params: dict, batch_stats: dict | None = None):
    """torch ``state_dict`` of the flax variables ``params`` and
    ``batch_stats`` (nested dicts of arrays)."""
    out = {}
    for path, a in _flatten(params):
        key, a = _param(path, a)
        out[key] = torch.tensor(a.copy())        # C-contiguous, keeps 0-d
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, a in _flatten(batch_stats or {}):
        module, _, leaf = path.rpartition(".")
        if leaf not in stat_names:
            raise ValueError(f"{path}: no torch counterpart")
        out[f"{module}.{stat_names[leaf]}"] = torch.tensor(a)
        out[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return out
