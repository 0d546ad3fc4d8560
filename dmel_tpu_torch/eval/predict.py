"""Inference over a set of clips (counterpart of the inference loop of
``dmel_tpu/eval/predict.py:predictions_by_row``)."""

from __future__ import annotations

import numpy as np
import torch

from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.precision import precision_scope


@precision_scope()
def predict(model: torch.nn.Module, xs: np.ndarray, batch_size: int = 32,
            device=None) -> tuple[np.ndarray, np.ndarray]:
    """Eval-mode forward passes of ``model`` over ``xs`` (n, T) in
    batches; returns ``(argmax, scores)``, scores ``(n, n_classes)``.

    Runs on ``device`` (default ``cuda``), where the model must lie,
    inside :func:`~dmel_tpu_torch.precision.precision_scope`.
    """
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model lies on {p.device}, not on {dev}")
    model.eval()
    scores = []
    with torch.no_grad():
        for i in range(0, len(xs), batch_size):
            xb = torch.as_tensor(np.ascontiguousarray(xs[i:i + batch_size]),
                                 dtype=torch.float32).to(dev)
            out, _ = model(xb)
            scores.append(out.cpu())
    scores = torch.cat(scores).numpy()
    return np.argmax(scores, axis=-1), scores
