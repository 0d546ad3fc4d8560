"""Classifiers over the trainable front end (counterpart of
``dmel_tpu/models/classifiers.py``).  ``forward`` returns
``(clipwise_sigmoid, s)`` with ``s`` the log-mel features
``(B, 1, n_mels, n_frames)``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dmel_tpu_torch.models.layers import (MelSpectrogramLayer,
                                          MultiSigmaMelSpectrogramLayer)
from dmel_tpu_torch.models.panns import Cnn6
from dmel_tpu_torch.ops.specband import LOG_EPS


class _MelFrontEnd(nn.Module):
    """Holds the DMEL front end shared by the mel classifiers: the
    multi-sigma layer when ``n_sigma > 1``, else the scalar one."""

    def __init__(self, init_lambd: float, n_mels: int, sample_rate: int,
                 n_points: int, hop_length: int = 1,
                 optimized: bool = False,
                 window_length: Optional[int] = None,
                 energy_normalize: bool = False,
                 normalize_window: bool = False, impl: str = "exact",
                 lambd_hint: Optional[float] = None, n_sigma: int = 1):
        super().__init__()
        self.energy_normalize = energy_normalize
        kw = dict(init_lambd=init_lambd, n_mels=n_mels, n_points=n_points,
                  sample_rate=sample_rate, hop_length=hop_length,
                  optimized=optimized, window_length=window_length,
                  normalize_window=normalize_window, impl=impl,
                  lambd_hint=lambd_hint)
        self.spectrogram_layer = (
            MultiSigmaMelSpectrogramLayer(n_sigma=n_sigma, **kw)
            if n_sigma > 1 else MelSpectrogramLayer(**kw))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spectrogram_layer(x)
        if self.energy_normalize:
            s = torch.log(s + LOG_EPS)
        return s


#: CNN6s conv-stack dtype by ``model_dtype`` (None: the parameters')
_MODEL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class MelPANNsNet(_MelFrontEnd):
    """DMEL front end + PANNs CNN6 backbone.

    ``model_dtype="bfloat16"`` runs CNN6's conv stack in bf16; the
    parameters, the batch-norm statistics, the DMEL front end and the
    classifier head stay float32 (:class:`~dmel_tpu_torch.models.panns.Cnn6`).
    """

    def __init__(self, n_classes: int, init_lambd: float, n_mels: int,
                 sample_rate: int, n_points: int, augment: bool = False,
                 generator: Optional[torch.Generator] = None,
                 model_dtype: str = "float32", **kwargs):
        super().__init__(init_lambd, n_mels, sample_rate, n_points,
                         **kwargs)
        if model_dtype not in _MODEL_DTYPES:
            raise ValueError(f"unknown model_dtype {model_dtype!r}")
        self.spectrogram_model = Cnn6(n_classes, n_mels, augment=augment,
                                      generator=generator,
                                      dtype=_MODEL_DTYPES[model_dtype])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws CNN6's training-mode dropout masks."""
        s = self.features(x)                        # (B, 1, M, T)
        out = self.spectrogram_model(s.transpose(2, 3), generator)
        return out, s
