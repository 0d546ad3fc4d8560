"""Gaussian-windowed power spectrogram (counterpart of
``dmel_tpu/ops/spectrogram.py``).

``optimized=False`` analyses with ``win_length = T`` and
``n_fft = 2 T``; ``optimized=True`` with
``win_length = n_fft = window_length``, a power of two chosen on the
host from the current lambda (:func:`optimized_window_length`).
"""

from __future__ import annotations

import torch

from dmel_tpu_torch.ops.stft import stft_power
from dmel_tpu_torch.ops.window import gaussian_window


def next_power_of_2(x) -> int:
    """Smallest power of two >= int(x)."""
    x = int(x)
    return 1 << (x - 1).bit_length()


def optimized_window_length(lambd_value: float, n_stds: int = 6) -> int:
    """Window length of optimized mode: ``next_power_of_2(|lambd| *
    n_stds)``, from a host value of lambda."""
    return next_power_of_2(abs(float(lambd_value)) * n_stds)


def bucketed_window_length(lambd_value: float, n_points: int,
                           n_stds: int = 6) -> int:
    """:func:`optimized_window_length` clamped to the signal's own
    power-of-two bucket."""
    return min(optimized_window_length(lambd_value, n_stds),
               next_power_of_2(int(n_points)))


def spectrogram(x: torch.Tensor, lambd, *, optimized: bool = False,
                hop_length: int = 1, norm: bool = False,
                window_length: int | None = None) -> torch.Tensor:
    """Gaussian-windowed power spectrogram ``(..., n_fft//2 + 1,
    T//hop + 1)`` of ``x`` (..., T); differentiable in ``lambd``.

    ``window_length`` is required in optimized mode and ignored
    otherwise.
    """
    t = x.shape[-1]
    if optimized:
        if window_length is None:
            raise ValueError(
                "optimized mode needs a static window_length; compute it "
                "with optimized_window_length(lambd)")
        win_length = int(window_length)
        n_fft = win_length
    else:
        win_length = t
        n_fft = 2 * t
    if not isinstance(lambd, torch.Tensor):
        lambd = torch.tensor(float(lambd), device=x.device)
    window = gaussian_window(lambd, win_length, norm=norm, dtype=x.dtype)
    return stft_power(x, window, n_fft, hop_length)
