"""Checkpoints of the port (counterpart of
``dmel_tpu/training/checkpoint.py``): one ``torch.save`` file per
checkpoint, written atomically (a temporary file beside it, then
``os.replace``), read back with ``torch.load(weights_only=True)``.

A checkpoint is a dict of tensors, state dicts and plain Python values.
``fit`` writes two kinds: ``best_model`` (the model's state dict, with
its batch-norm statistics, and the optimizer's) and ``live_state`` (the
same, the dropout generator's state and the loop's bookkeeping).  The
JAX package's flax msgpack files are not read here: convert their trees
with :func:`dmel_tpu_torch.convert.from_jax_variables`.
:func:`import_panns_cnn6` loads a PANNs Cnn6 checkpoint's weights into a
``MelPANNsNet``.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch import nn


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


#: the PANNs leaves the import maps: a ``weight`` of these ranks (conv,
#: dense, batch-norm scale), ``bias`` and the batch-norm statistics
_WEIGHT_RANKS = (1, 2, 4)
_LEAVES = ("bias", "running_mean", "running_var")


def import_panns_cnn6(torch_state_dict: dict, model: nn.Module,
                      verbose: bool = False) -> tuple[int, int]:
    """Copy a PANNs Cnn6 ``state_dict`` (``checkpoint["model"]``) into
    ``model``'s CNN6 (``model.spectrogram_model``), in place; returns
    the counts ``(imported, skipped)``.

    The JAX package's import (its reference's prefix re-key and
    non-strict load): each key goes to ``spectrogram_model.<key>``.  A
    ``weight`` of rank 1, 2 or 4, a ``bias`` and the running statistics
    are copied where the model has the key at the same shape; any other
    key, or one the model lacks (the AudioSet front end's buffers, PANNs'
    ``bn0``, which CNN6 names ``bn1``) or holds at another shape (the
    527-class ``fc_audioset`` head), is skipped; ``num_batches_tracked``
    is neither.  Tensors keep the model's dtype and device."""
    state = model.state_dict()
    imported, skipped = 0, 0
    for key, tensor in torch_state_dict.items():
        leaf = key.rpartition(".")[2]
        if leaf == "num_batches_tracked":
            continue
        target = state.get(f"spectrogram_model.{key}")
        ok = ((leaf == "weight" and tensor.dim() in _WEIGHT_RANKS
               or leaf in _LEAVES)
              and target is not None and target.shape == tensor.shape)
        if ok:
            with torch.no_grad():
                target.copy_(tensor)
        elif (verbose and target is not None
              and target.shape != tensor.shape):
            print(f"skip (shape) {key}: {tuple(target.shape)} vs "
                  f"{tuple(tensor.shape)}")
        imported += int(ok)
        skipped += int(not ok)
    if verbose:
        print(f"imported {imported} tensors, skipped {skipped}")
    return imported, skipped
