"""Classifiers over the trainable front end (counterpart of
``dmel_tpu/models/classifiers.py``).  ``forward`` returns
``(clipwise_sigmoid, s)`` with ``s`` the log-mel features
``(B, 1, n_mels, n_frames)``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dmel_tpu_torch.models.layers import MelSpectrogramLayer
from dmel_tpu_torch.models.panns import Cnn6
from dmel_tpu_torch.ops.specband import LOG_EPS


class _MelFrontEnd(nn.Module):
    """Holds the DMEL front end shared by the mel classifiers."""

    def __init__(self, init_lambd: float, n_mels: int, sample_rate: int,
                 n_points: int, hop_length: int = 1,
                 optimized: bool = False,
                 window_length: Optional[int] = None,
                 energy_normalize: bool = False,
                 normalize_window: bool = False, impl: str = "exact",
                 lambd_hint: Optional[float] = None):
        super().__init__()
        self.energy_normalize = energy_normalize
        self.spectrogram_layer = MelSpectrogramLayer(
            init_lambd=init_lambd, n_mels=n_mels, n_points=n_points,
            sample_rate=sample_rate, hop_length=hop_length,
            optimized=optimized, window_length=window_length,
            normalize_window=normalize_window, impl=impl,
            lambd_hint=lambd_hint)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spectrogram_layer(x)
        if self.energy_normalize:
            s = torch.log(s + LOG_EPS)
        return s


class MelPANNsNet(_MelFrontEnd):
    """DMEL front end + PANNs CNN6 backbone."""

    def __init__(self, n_classes: int, init_lambd: float, n_mels: int,
                 sample_rate: int, n_points: int, augment: bool = False,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, n_mels, sample_rate, n_points,
                         **kwargs)
        self.spectrogram_model = Cnn6(n_classes, n_mels, augment=augment,
                                      generator=generator)

    def forward(self, x: torch.Tensor):
        s = self.features(x)                        # (B, 1, M, T)
        out = self.spectrogram_model(s.transpose(2, 3))
        return out, s
