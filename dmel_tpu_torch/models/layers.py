"""Trainable time-frequency front end (counterpart of
``dmel_tpu/models/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dmel_tpu_torch.ops.dmel import mel_spectrogram


class MelSpectrogramLayer(nn.Module):
    """DMEL: mel power spectrogram with a trainable window length
    ``lambd``.  Output ``(B, 1, n_mels, n_points // hop_length + 1)``.

    ``window_length`` is the static optimized-mode bucket and
    ``lambd_hint`` the static hint of the ``"auto"`` dispatch, both
    chosen on the host from the current lambda.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mel = mel_spectrogram(
            x, self.lambd, n_mels=self.n_mels, sample_rate=self.sample_rate,
            hop_length=self.hop_length, optimized=self.optimized,
            window_length=self.window_length,
            normalize_window=self.normalize_window, impl=self.impl,
            lambd_hint=self.lambd_hint, device=x.device)
        return mel[:, None, :, :]
