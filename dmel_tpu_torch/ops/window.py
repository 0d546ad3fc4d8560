"""Gaussian windows (counterpart of ``dmel_tpu/ops/window.py``): the
differentiable analysis window and the translated window of the
synthetic data."""

from __future__ import annotations

import torch

#: guard added to lambd in the denominator, as in ``(lambd + 1e-15)``
LAMBD_EPS = 1e-15


def gaussian_window(lambd, window_length: int, norm: bool = False,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """``w[m] = exp(-0.5 * ((m - L/2) / (lambd + eps))^2)``, ``m < L``.

    The centre is ``L/2``, not ``(L-1)/2``.  Differentiable in
    ``lambd`` (a scalar tensor or float).  ``norm=True`` divides by
    ``sqrt(sum(w^2))``.  The window lies on ``lambd``'s device when
    ``lambd`` is a tensor, else on ``device`` (default CPU).
    """
    if isinstance(lambd, torch.Tensor):
        lambd = lambd.to(dtype)
        device = lambd.device
    else:
        lambd = torch.tensor(float(lambd), dtype=dtype, device=device)
    m = torch.arange(window_length, dtype=dtype, device=device)
    z = (m - window_length / 2) / (lambd + LAMBD_EPS)
    window = torch.exp(-0.5 * z * z)
    if norm:
        window = window / torch.sqrt(torch.sum(window * window))
    return window


def translated_gaussian_window(sigma, tc, signal_length: int,
                               norm: str = "amplitude",
                               dtype=torch.float32) -> torch.Tensor:
    """Gaussian of width ``sigma`` centred at ``tc`` over
    ``signal_length`` samples, for data synthesis (not the transform).
    ``norm="amplitude"`` divides by the maximum; ``"energy"`` by the sum
    of squares (not its square root)."""
    sigma = torch.as_tensor(sigma, dtype=dtype)
    tc = torch.as_tensor(tc, dtype=dtype, device=sigma.device)
    ts = torch.arange(signal_length, dtype=dtype, device=sigma.device)
    window = torch.exp(-0.5 * torch.square((ts - tc) / (sigma + LAMBD_EPS)))
    if norm == "energy":
        return window / torch.sum(torch.square(window))
    if norm == "amplitude":
        return window / torch.max(window)
    raise ValueError(f"unknown norm: {norm!r}")
