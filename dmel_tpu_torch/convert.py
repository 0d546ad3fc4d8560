"""Carry weights from the JAX package's models into the port.

:func:`from_jax_variables` takes the ``params`` and ``batch_stats``
trees of a flax model as nested dicts of numpy arrays (what
``jax.device_get`` returns) and gives the matching torch
``state_dict``.  Module names are the same in both packages, so the
map is per leaf:

- conv kernels HWIO -> OIHW and 1-D ones WIO -> OIW (``AttBlock``),
  Dense kernels ``(in, out)`` -> ``(out, in)``, all named ``weight``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and the
  statistics ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``lambd`` stays ``lambd``;
- in the conv probes (``ConvNet``, ``MelConvNet``: ``conv1`` and
  ``fc1`` side by side), ``fc1``'s input rows are also permuted: flax
  flattens the conv output NHWC as ``(F, T, C)``, torch NCHW as
  ``(C, F, T)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _nchw_flatten_order(tree: dict) -> dict:
    """``tree`` with the ``fc1`` kernel of every level that also holds a
    4-D ``conv1`` kernel reordered from NHWC-flattened inputs
    ``(F T C, out)`` to NCHW-flattened ones ``(C F T, out)``."""
    out = {}
    for key, value in tree.items():
        out[key] = _nchw_flatten_order(value) if isinstance(value,
                                                            dict) else value
    conv, fc = out.get("conv1"), out.get("fc1")
    if (isinstance(conv, dict) and isinstance(fc, dict)
            and np.ndim(conv.get("kernel")) == 4):
        channels = np.shape(conv["kernel"])[3]
        kernel = np.asarray(fc["kernel"])
        kernel = kernel.reshape(-1, channels, kernel.shape[1])
        out["fc1"] = dict(fc, kernel=kernel.transpose(1, 0, 2).reshape(
            -1, kernel.shape[2]))
    return out


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
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
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
    for path, a in _flatten(_nchw_flatten_order(params)):
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
