"""Classifiers over the trainable front ends (counterpart of
``dmel_tpu/models/classifiers.py``).

Every ``forward(x, generator=None)`` returns ``(out, s)``: ``out`` the
logits (the clipwise sigmoid scores for :class:`MelPANNsNet`) and ``s``
the features the head reads, ``(B, 1, F, T)``.  ``generator`` draws the
training-mode dropout masks.

- over DSPEC (:class:`~dmel_tpu_torch.models.layers.SpectrogramLayer`):
  :class:`LinearNet`, :class:`BatchNormLinearNet`, :class:`MlpNet`,
  :class:`ConvNet`, with ``size = (F, T)`` the spectrogram's shape;
- over DMEL: :class:`MelLinearNet`, :class:`MelMlpNet`,
  :class:`MelConvNet` and :class:`MelPANNsNet`.

The probes' weights and biases take torch's default init
(``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``), drawn from the ``generator``
their constructor is given.  The conv probes flatten ``(C, F, T)``, as
torch's NCHW layout does; the JAX package flattens NHWC ``(F, T, C)``,
and :func:`~dmel_tpu_torch.convert.from_jax_variables` permutes ``fc1``'s
inputs to match.  Dropout follows the training mode (the JAX package's
``eval_dropout`` is not ported).  The probes' dropout and
:class:`BatchNormLinearNet`'s batch norm are
:mod:`~dmel_tpu_torch.models.panns`'s, so under a data-parallel mesh
scope they draw at the global batch and normalise by its statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dmel_tpu_torch.models.layers import (MelSpectrogramLayer,
                                          MultiSigmaMelSpectrogramLayer,
                                          SpectrogramLayer)
from dmel_tpu_torch.models.panns import BiasedBatchNorm1d, Cnn6, dropout
from dmel_tpu_torch.ops.specband import LOG_EPS


def _torch_default_init(module: nn.Module,
                        generator: Optional[torch.Generator]) -> None:
    """torch's default init of every ``nn.Linear`` and ``nn.Conv2d`` in
    ``module``, from ``generator``: weight and bias ``U(-b, b)``,
    ``b = 1 / sqrt(fan_in)``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


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

    @property
    def size(self) -> Tuple[int, int]:
        """``(n_mels, n_frames)`` of the features."""
        layer = self.spectrogram_layer
        return layer.n_mels, layer.n_points // layer.hop_length + 1

    def features(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spectrogram_layer(x)
        if self.energy_normalize:
            s = torch.log(s + LOG_EPS)
        return s


class MelLinearNet(_MelFrontEnd):
    """DMEL + dropout(0.2) + linear probe."""

    def __init__(self, n_classes: int, init_lambd: float, n_mels: int,
                 sample_rate: int, n_points: int,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, n_mels, sample_rate, n_points,
                         **kwargs)
        f, t = self.size
        self.fc = nn.Linear(f * t, n_classes)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.features(x)
        h = dropout(s.reshape(s.shape[0], -1), 0.2, self.training, generator)
        return self.fc(h), s


class MelMlpNet(_MelFrontEnd):
    """DMEL + fc 32 + ReLU + dropout(0.2) + fc."""

    def __init__(self, n_classes: int, init_lambd: float, n_mels: int,
                 sample_rate: int, n_points: int,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, n_mels, sample_rate, n_points,
                         **kwargs)
        f, t = self.size
        self.fc1 = nn.Linear(f * t, 32)
        self.fc2 = nn.Linear(32, n_classes)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.features(x)
        h = F.relu(self.fc1(s.reshape(s.shape[0], -1)))
        h = dropout(h, 0.2, self.training, generator)
        return self.fc2(h), s


def _add_conv_head(module: nn.Module, n_classes: int,
                   size: Tuple[int, int], hidden_state: int) -> None:
    """The conv probes' head on ``module``: conv ``hidden_state`` @ 5x5
    (padding 2, flax's ``"SAME"``), fc ``hidden_state``, fc."""
    f, t = size
    module.conv1 = nn.Conv2d(1, hidden_state, 5, padding=2)
    module.fc1 = nn.Linear(hidden_state * f * t, hidden_state)
    module.fc2 = nn.Linear(hidden_state, n_classes)


def _conv_head(module: nn.Module, s: torch.Tensor) -> torch.Tensor:
    """Logits of :func:`_add_conv_head`'s head over ``(B, 1, F, T)``."""
    h = F.relu(module.conv1(s))
    h = F.relu(module.fc1(h.reshape(h.shape[0], -1)))
    return module.fc2(h)


class MelConvNet(_MelFrontEnd):
    """DMEL + conv 32 @ 5x5 + fc 32 + fc."""

    def __init__(self, n_classes: int, init_lambd: float, n_mels: int,
                 sample_rate: int, n_points: int, hidden_state: int = 32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, n_mels, sample_rate, n_points,
                         **kwargs)
        _add_conv_head(self, n_classes, self.size, hidden_state)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.features(x)
        return _conv_head(self, s), s


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


class _SpecFrontEnd(nn.Module):
    """Holds the DSPEC front end shared by the spectrogram probes;
    ``size`` is the spectrogram's ``(F, T)``."""

    def __init__(self, init_lambd: float, size: Tuple[int, int] = (512, 1024),
                 hop_length: int = 1, optimized: bool = False,
                 window_length: Optional[int] = None,
                 normalize_window: bool = False):
        super().__init__()
        self.size = tuple(size)
        self.spectrogram_layer = SpectrogramLayer(
            init_lambd, hop_length=hop_length, optimized=optimized,
            window_length=window_length, normalize_window=normalize_window)


class LinearNet(_SpecFrontEnd):
    """DSPEC + linear probe."""

    def __init__(self, n_classes: int, init_lambd: float,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, **kwargs)
        f, t = self.size
        self.fc = nn.Linear(f * t, n_classes)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.spectrogram_layer(x)
        return self.fc(s.reshape(s.shape[0], -1)), s


class MlpNet(_SpecFrontEnd):
    """DSPEC + fc 128 + ReLU + fc."""

    def __init__(self, n_classes: int, init_lambd: float,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, **kwargs)
        f, t = self.size
        self.fc1 = nn.Linear(f * t, 128)
        self.fc2 = nn.Linear(128, n_classes)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.spectrogram_layer(x)
        return self.fc2(F.relu(self.fc1(s.reshape(s.shape[0], -1)))), s


class BatchNormLinearNet(_SpecFrontEnd):
    """DSPEC + batch norm over frequency bins + linear probe.

    The batch norm keeps one mean and variance a frequency bin, over
    the batch and the frames (momentum 0.1, eps 1e-5, the running
    variance from the biased batch variance: flax's
    ``BatchNorm(axis=2, momentum=0.9)`` on ``(B, 1, F, T)``).  The
    features returned, and the energy computed from them, are the
    normalised ones."""

    def __init__(self, n_classes: int, init_lambd: float,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, **kwargs)
        f, t = self.size
        self.bn = BiasedBatchNorm1d(f, momentum=0.1, eps=1e-5)
        self.fc = nn.Linear(f * t, n_classes)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.spectrogram_layer(x)
        sb = self.bn(s[:, 0].contiguous())[:, None]
        return self.fc(sb.reshape(sb.shape[0], -1)), sb


class ConvNet(_SpecFrontEnd):
    """DSPEC + conv 32 @ 5x5 + fc 32 + fc."""

    def __init__(self, n_classes: int, init_lambd: float,
                 hidden_state: int = 32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(init_lambd, **kwargs)
        _add_conv_head(self, n_classes, self.size, hidden_state)
        _torch_default_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        s = self.spectrogram_layer(x)
        return _conv_head(self, s), s
