"""Config dict to model (counterpart of ``dmel_tpu/models/registry.py``).

Configs are the flat experiment dicts of the JAX package.  Their
``impl`` names map onto the port's routes: ``"xla"`` to ``"exact"``,
``"pallas"`` (the auto kernel dispatch) to ``"auto"``, and
``"pallas_specband"``, ``"pallas_framed"``, ``"pallas_fused"`` to
``"specband"``, ``"framed"``, ``"fused"``.

The ``precision`` key (the JAX registry's default ``"highest"``) is the
front end's matmul precision there.  The port's front end runs in
float32 only, which is ``"highest"``; ``"default"`` (bf16 matmuls on the
TPU) is refused with ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.models.classifiers import MelPANNsNet

N_CLASSES = {
    "time_frequency": 3,
    "audio_mnist": 10,
    "esc50": 50,
    "esc50_synth": 10,
    "fsd": 200,
}

_IMPL = {"xla": "exact", "pallas": "auto", "pallas_specband": "specband",
         "pallas_framed": "framed", "pallas_fused": "fused"}


def n_classes_for(dataset_name: str) -> int:
    try:
        return N_CLASSES[dataset_name]
    except KeyError:
        raise ValueError(f"dataset_name: {dataset_name} not supported.")


def _impl(config: dict) -> str:
    name = config.get("impl", "xla")
    try:
        return _IMPL[name]
    except KeyError:
        raise ValueError(f"unknown impl {name!r}")


def get_model_by_config(config: dict, window_length: Optional[int] = None,
                        lambd_hint: Optional[float] = None, *, device=None,
                        seed: int = 0):
    """Build the model of ``config`` on ``device`` (default ``cuda``),
    its weights drawn from a ``torch.Generator`` seeded with ``seed``.

    ``window_length`` is the static optimized-mode bucket (None in
    faithful mode) and ``lambd_hint`` the static dispatch hint
    (:func:`dispatch_hint_for`).  Only ``panns_cnn6`` is ported.
    """
    dev = resolve_device(device)
    name = config["model_name"]
    if name != "panns_cnn6":
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if config.get("model_dtype", "float32") != "float32":
        raise NotImplementedError("only model_dtype='float32' is ported")
    if config.get("precision", "highest") != "highest":
        raise NotImplementedError("the port's front end runs in float32 "
                                  "only: precision='highest'")
    gen = torch.Generator().manual_seed(seed)
    model = MelPANNsNet(
        n_classes=n_classes_for(config["dataset_name"]),
        init_lambd=float(config["init_lambd"]),
        n_mels=config.get("n_mels", 64),
        sample_rate=config.get("resample_rate", 8000),
        n_points=config["n_points"],
        hop_length=config["hop_length"],
        optimized=config["optimized"],
        window_length=window_length,
        energy_normalize=config.get("energy_normalize", False),
        normalize_window=config["normalize_window"],
        impl=_impl(config),
        lambd_hint=lambd_hint,
        n_sigma=int(config.get("n_sigma", 1)),
        augment=config.get("augment", False),
        generator=gen)
    return model.to(dev)


def dispatch_hint_for(config: dict, window_length: Optional[int],
                      lambd_value: float) -> Optional[float]:
    """Canonical static ``lambd_hint`` for a model built from
    ``config`` at ``lambd_value`` (a scalar: the mean for a multi-sigma
    model, as the trainer passes it); None where the config does not use
    the auto dispatch or runs in faithful mode."""
    if _impl(config) != "auto" or window_length is None:
        return None
    from dmel_tpu_torch.ops.stft import pallas_compile_hint
    return pallas_compile_hint(float(lambd_value), int(window_length),
                               int(config["hop_length"]))
