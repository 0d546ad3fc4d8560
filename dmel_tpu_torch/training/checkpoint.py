"""Checkpoints of the port (counterpart of
``dmel_tpu/training/checkpoint.py``): one ``torch.save`` file per
checkpoint, written atomically (a temporary file beside it, then
``os.replace``), read back with ``torch.load(weights_only=True)``.

A checkpoint is a dict of tensors, state dicts and plain Python values.
``fit`` writes two kinds: ``best_model`` (the model's state dict, with
its batch-norm statistics, and the optimizer's) and ``live_state`` (the
same, the dropout generator's state and the loop's bookkeeping).  The
JAX package's flax msgpack files are not read here: convert their trees
with :func:`dmel_tpu_torch.convert.from_jax_variables`.  The PANNs
pretrained import is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` to ``path`` (its directory is created), atomically:
    a reader sees the old file or the new one, never a partial write.
    Tensors are written as they lie; :func:`load_checkpoint` maps them
    to the device it is asked for."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`, its tensors
    on ``map_location`` (default the CPU).  Only tensors and plain
    Python values are unpickled (``weights_only=True``)."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
