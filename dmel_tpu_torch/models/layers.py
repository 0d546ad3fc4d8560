"""Trainable time-frequency front ends (counterpart of
``dmel_tpu/models/layers.py``): DMEL (:class:`MelSpectrogramLayer`, its
multi-sigma form) and DSPEC (:class:`SpectrogramLayer`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dmel_tpu_torch.ops.dmel import (mel_spectrogram,
                                     multi_sigma_mel_spectrogram)
from dmel_tpu_torch.ops.spectrogram import spectrogram


class MelSpectrogramLayer(nn.Module):
    """DMEL: mel power spectrogram with a trainable window length
    ``lambd``.  Output ``(B, 1, n_mels, n_points // hop_length + 1)``.

    ``window_length`` is the static optimized-mode bucket and
    ``lambd_hint`` the static hint of the ``"auto"`` dispatch, both
    chosen on the host from the current lambda; :meth:`set_geometry`
    re-selects them on a built layer.
    """

    def __init__(self, init_lambd: float, n_mels: int, n_points: int,
                 sample_rate: int, hop_length: int = 1,
                 optimized: bool = False,
                 window_length: Optional[int] = None,
                 normalize_window: bool = False, impl: str = "exact",
                 lambd_hint: Optional[float] = None):
        super().__init__()
        self.lambd = nn.Parameter(torch.tensor(float(init_lambd)))
        self.n_mels = n_mels
        self.n_points = n_points
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.optimized = optimized
        self.window_length = window_length
        self.normalize_window = normalize_window
        self.impl = impl
        self.lambd_hint = lambd_hint

    def set_geometry(self, window_length: Optional[int],
                     lambd_hint: Optional[float]) -> None:
        """Set the bucket and the hint (the trainer does so at each epoch
        boundary); the parameters stay as they are."""
        self.window_length = window_length
        self.lambd_hint = lambd_hint

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mel = mel_spectrogram(
            x, self.lambd, n_mels=self.n_mels, sample_rate=self.sample_rate,
            hop_length=self.hop_length, optimized=self.optimized,
            window_length=self.window_length,
            normalize_window=self.normalize_window, impl=self.impl,
            lambd_hint=self.lambd_hint, device=x.device)
        return mel[:, None, :, :]


class MultiSigmaMelSpectrogramLayer(MelSpectrogramLayer):
    """Multi-sigma DMEL: a vector of ``n_sigma`` trainable window lengths,
    one a contiguous group of mel bands (``default_band_map``).  The
    parameter keeps the name ``lambd`` (shape ``(n_sigma,)``), so the
    optimizer's ``lr_tf`` group and the trajectory records treat it as
    the scalar one.  ``lambd_hint`` may be a scalar or one a sigma.
    Output ``(B, 1, n_mels, n_points // hop_length + 1)``."""

    def __init__(self, init_lambd: float, n_sigma: int, n_mels: int,
                 n_points: int, sample_rate: int, **kwargs):
        super().__init__(init_lambd, n_mels, n_points, sample_rate,
                         **kwargs)
        self.lambd = nn.Parameter(torch.full((n_sigma,), float(init_lambd)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mel = multi_sigma_mel_spectrogram(
            x, self.lambd, n_mels=self.n_mels, sample_rate=self.sample_rate,
            hop_length=self.hop_length, optimized=self.optimized,
            window_length=self.window_length,
            normalize_window=self.normalize_window, impl=self.impl,
            lambd_hint=self.lambd_hint, device=x.device)
        return mel[:, None, :, :]


class SpectrogramLayer(nn.Module):
    """DSPEC: power spectrogram of the mean-subtracted signal with a
    trainable window length ``lambd`` (its magnitude is used).

    Faithful mode (``optimized=False``) analyses with a window of
    ``T`` samples and ``n_fft = 2 T``: output ``(B, 1, T + 1,
    T // hop_length + 1)``.  Optimized mode analyses with
    ``window_length`` samples and ``n_fft = window_length``.  Both go
    through :func:`~dmel_tpu_torch.ops.spectrogram.spectrogram`, the
    exact route (``torch.stft``): the JAX package's DSPEC has no Pallas
    kernel either.
    """

    def __init__(self, init_lambd: float, hop_length: int = 1,
                 optimized: bool = False,
                 window_length: Optional[int] = None,
                 normalize_window: bool = False):
        super().__init__()
        self.lambd = nn.Parameter(torch.tensor(float(init_lambd)))
        self.hop_length = hop_length
        self.optimized = optimized
        self.window_length = window_length
        self.normalize_window = normalize_window

    def set_geometry(self, window_length: Optional[int],
                     lambd_hint: Optional[float] = None) -> None:
        """Set the optimized-mode window length (DSPEC takes no hint)."""
        self.window_length = window_length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x - x.mean(dim=-1, keepdim=True)
        s = spectrogram(x, self.lambd.abs(), optimized=self.optimized,
                        hop_length=self.hop_length,
                        norm=self.normalize_window,
                        window_length=self.window_length)
        return s[:, None, :, :]
