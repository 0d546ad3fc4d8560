"""Experiment search spaces and grid expansion: a copy of
``dmel_tpu/experiments/configs.py``, key for key.

Any config value wrapped in :func:`grid_search` is expanded into the
cartesian product of all grid axes (Ray Tune's ``grid_search``
semantics); ``num_samples`` repeats every grid point.

Keys the port reads differently:

- ``impl="pallas"`` is the auto dispatch over the port's CUDA kernels
  (``models/registry.py``);
- ``model_dtype="bfloat16"`` runs CNN6's conv stack in bf16;
- ``rng_impl`` names the JAX package's dropout PRNG; the port keeps it
  in the config and ignores it (its dropout masks come from one
  ``torch.Generator``);
- ``prefetch`` (no space sets it; default 2) is the depth of the
  background host-to-device feed of ``fit`` and ``predict_test``; the
  port reads it because the JAX package does (0 feeds from the loop).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List


class grid_search:  # noqa: N801 — mirrors ray's lowercase spelling
    """Marker for a grid axis in a search space."""

    def __init__(self, values):
        self.values = list(values)

    def __repr__(self):
        return f"grid_search({self.values})"


def expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cartesian-product expansion of all grid_search axes (insertion
    order, matching Ray's deterministic expansion)."""
    keys = [k for k, v in space.items() if isinstance(v, grid_search)]
    fixed = {k: v for k, v in space.items() if not isinstance(v, grid_search)}
    combos = itertools.product(*[space[k].values for k in keys])
    out = []
    for combo in combos:
        cfg = dict(fixed)
        cfg.update(dict(zip(keys, combo)))
        out.append(cfg)
    return out


def esc50(max_epochs: int) -> Dict[str, Any]:
    """ESC-50 space: PANNs CNN6, 64 mels, hop 10 ms, Adam, batch 32,
    initial window lengths {10, 35, 300} ms."""
    resample_rate = 8000
    return {
        "model_name": "panns_cnn6",
        "n_mels": 64,
        "hop_length": int(resample_rate * 0.010),
        "energy_normalize": True,
        "optimized": True,
        # the auto kernel dispatch, with the hint fit() refreshes
        "impl": "pallas",
        # the JAX package's dropout PRNG; ignored by the port
        "rng_impl": "rbg",
        # the conv stack in bf16; parameters and BN statistics stay f32
        "model_dtype": "bfloat16",
        "normalize_window": False,
        "augment": False,
        "pretrained": False,
        "checkpoint_path": "weights/Cnn6_mAP=0.343.pth",
        "optimizer_name": "adam",
        "lr_model": 1e-4,
        "lr_tf": 1.0,
        "batch_size": 32,
        "trainable": grid_search([True, False]),
        "max_epochs": max_epochs,
        "patience": 100,
        "resample_rate": resample_rate,
        "init_lambd": grid_search([(resample_rate * x) / 6
                                   for x in [0.01, 0.035, 0.3]]),
        "dataset_name": "esc50",
        "n_points": resample_rate * 5,
    }


def audio_mnist(max_epochs: int) -> Dict[str, Any]:
    """AudioMNIST space: a mel linear probe, 64 mels, hop 10 ms, batch
    64, 1 s clips."""
    resample_rate = 8000
    return {
        "model_name": "mel_linear_net",
        "n_mels": 64,
        "hop_length": int(resample_rate * 0.010),
        "energy_normalize": True,
        "optimized": True,
        "impl": "pallas",
        "rng_impl": "rbg",
        "normalize_window": False,
        "augment": False,
        "pretrained": False,
        "checkpoint_path": "weights/Cnn6_mAP=0.343.pth",
        "optimizer_name": "adam",
        "lr_model": 1e-4,
        "lr_tf": 1.0,
        "batch_size": 64,
        "trainable": grid_search([True, False]),
        "max_epochs": max_epochs,
        "patience": 100,
        "resample_rate": resample_rate,
        "init_lambd": grid_search([(resample_rate * x) / 6
                                   for x in [0.01, 0.035, 0.3]]),
        "dataset_name": "audio_mnist",
        "n_points": 8000,
    }


def time_frequency(max_epochs: int) -> Dict[str, Any]:
    """Synthetic Gauss-pulse space: a spectrogram linear probe in
    faithful mode (n_fft = 2T = 256, hop 1), on the exact route."""
    sigma_ref = 6.38
    return {
        "model_name": "linear_net",
        "hop_length": 1,
        "optimized": False,
        "normalize_window": False,
        "optimizer_name": "sgd",
        "lr_model": 1e-3,
        "lr_tf": 1,
        "batch_size": 128,
        "trainable": grid_search([True, False]),
        "max_epochs": max_epochs,
        "patience": 100,
        "n_points": 128,
        "noise_std": 0.5,
        "init_lambd": grid_search([x * sigma_ref for x in [0.2, 1.0, 5.0]]),
        "n_samples": 5000,
        "sigma_ref": sigma_ref,
        "dataset_name": "time_frequency",
        "center_offset": False,
    }


def fsd(max_epochs: int):
    """FSD50K space: DMEL + PANNs CNN6, multi-label BCE over 200
    classes, SpecAugment; the same lambda grid as ESC-50."""
    resample_rate = 8000
    return {
        "model_name": "panns_cnn6",
        "n_mels": 64,
        "hop_length": int(resample_rate * 0.010),
        "energy_normalize": True,
        "optimized": True,
        "impl": "pallas",
        "rng_impl": "rbg",
        "model_dtype": "bfloat16",
        "normalize_window": False,
        "augment": True,
        "pretrained": False,
        "checkpoint_path": "weights/Cnn6_mAP=0.343.pth",
        "optimizer_name": "adam",
        "lr_model": 1e-4,
        "lr_tf": 1.0,
        "batch_size": 32,
        "trainable": grid_search([True, False]),
        "max_epochs": max_epochs,
        "patience": 100,
        "resample_rate": resample_rate,
        "init_lambd": grid_search([(resample_rate * x) / 6
                                   for x in [0.01, 0.035, 0.3]]),
        "dataset_name": "fsd",
        "n_points": resample_rate * 5,
    }


def esc50_synth(max_epochs: int) -> Dict[str, Any]:
    """ESC-50-shaped synthetic space: the esc50 space's model, optimizer
    and geometry on the 10-class Gauss-pulse composite task, which needs
    no download."""
    space = esc50(max_epochs)
    space.update({
        "dataset_name": "esc50_synth",
        "pretrained": False,
        "sigma_ref": 8000 * 0.035 / 6,
        "noise_std": 0.05,
        "n_samples": 2000,
        "data_seed": 0,
    })
    return space


SEARCH_SPACES = {
    "fsd": fsd,
    # substring dispatch: longer keys first so "esc50_synth" does not
    # fall through to "esc50"
    "esc50_synth": esc50_synth,
    "esc50": esc50,
    "audio_mnist": audio_mnist,
    "time_frequency": time_frequency,
}


def get_search_space(name: str, max_epochs: int) -> Dict[str, Any]:
    """Name → space, the first key of :data:`SEARCH_SPACES` that is a
    substring of ``name``."""
    for key, fn in SEARCH_SPACES.items():
        if key in name:
            return fn(max_epochs)
    raise ValueError("search space not found ...")
