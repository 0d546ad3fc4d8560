"""PANNs CNN6 backbone (counterpart of ``dmel_tpu/models/panns.py``).

PyTorch layout: ``Cnn6`` takes ``(B, 1, time, mel)``, as the original
PANNs code does.  Batch norm has torch semantics (momentum 0.1, eps
1e-5).  Weights are Xavier-uniform with zero biases, drawn from a
``torch.Generator``.

The JAX package's ``Patches5x5Conv`` computes the one-input-channel
5x5 convolution as an im2col matrix product, a workaround for the TPU
matrix unit's contraction depth; here it is a plain ``nn.Conv2d``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def xavier_uniform_(weight: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> None:
    """Xavier-uniform init: ``U(-a, a)``, ``a = sqrt(6 / (fan_in +
    fan_out))``, with receptive field sizes folded into both fans."""
    receptive = weight[0][0].numel() if weight.dim() > 2 else 1
    fan_in = weight.shape[1] * receptive
    fan_out = weight.shape[0] * receptive
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


class ConvBlock5x5(nn.Module):
    """conv5x5 (no bias) + BN + ReLU + 2x2 average pool."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 5, padding=2,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels, momentum=0.1, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(F.relu(self.bn1(self.conv1(x))), 2)


class Cnn6(nn.Module):
    """PANNs CNN6: input ``(B, 1, time, mel)``, output the sigmoid
    clipwise scores ``(B, classes_num)``.

    SpecAugment (``augment=True``) acts only in training, which is not
    ported yet: a training-mode forward with it raises.
    """

    def __init__(self, classes_num: int, n_mels: int, augment: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.augment = augment
        self.bn1 = nn.BatchNorm2d(n_mels, momentum=0.1, eps=1e-5)
        self.conv_block1 = ConvBlock5x5(1, 64)
        self.conv_block2 = ConvBlock5x5(64, 128)
        self.conv_block3 = ConvBlock5x5(128, 256)
        self.conv_block4 = ConvBlock5x5(256, 512)
        self.fc1 = nn.Linear(512, 512)
        self.fc_esc50 = nn.Linear(512, classes_num)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                xavier_uniform_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.augment:
            raise NotImplementedError("SpecAugment belongs to training, "
                                      "which is not ported yet")
        # batch norm over mel bins: put mel in the channel slot
        x = self.bn1(x.transpose(1, 3)).transpose(1, 3)
        for block in (self.conv_block1, self.conv_block2,
                      self.conv_block3, self.conv_block4):
            x = F.dropout(block(x), 0.2, training=self.training)
        x = x.mean(dim=3)                                 # over mel
        x = x.max(dim=2).values + x.mean(dim=2)           # over time
        x = F.dropout(x, 0.5, training=self.training)
        x = F.relu(self.fc1(x))
        x = F.dropout(x, 0.5, training=self.training)
        return torch.sigmoid(self.fc_esc50(x))
