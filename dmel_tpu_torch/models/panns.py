"""PANNs CNN6 backbone (counterpart of ``dmel_tpu/models/panns.py``).

PyTorch layout: ``Cnn6`` takes ``(B, 1, time, mel)``, as the original
PANNs code does.  Batch norm has torch semantics (momentum 0.1, eps
1e-5).  Weights are Xavier-uniform with zero biases, drawn from a
``torch.Generator``; dropout masks in training come from the generator
the caller passes to ``forward``.

``dtype=torch.bfloat16`` runs the conv stack in bf16, as the JAX
package's ``model_dtype="bfloat16"`` does: each block's convolution,
batch-norm output, ReLU, pooling and dropout.  The casts are explicit,
not ``torch.autocast``: the weights and batch-norm parameters stay
float32 and are cast in ``forward``, batch-norm statistics are computed
and kept in float32, the mel batch norm ``bn1`` runs in float32 (so the
front end's gradient arrives in float32), and the head casts to float32
before the mean over mel.

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


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with flax's semantics: keep each element with
    probability ``1 - p`` and scale it by ``1 / (1 - p)``.  The mask is
    drawn from ``generator`` (on ``x``'s device; None takes torch's
    default generator) in float32 whatever ``x``'s dtype, so a bf16 and
    a float32 model draw the same masks from the same generator state.
    The identity outside training."""
    if not training:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class ConvBlock5x5(nn.Module):
    """conv5x5 (no bias) + BN + ReLU + 2x2 average pool.

    ``dtype`` None computes in the input's dtype, as the parameters'
    (flax's ``dtype=None``).  ``torch.bfloat16`` casts the input and the
    float32 kernel to bf16; the batch norm then takes the bf16 input
    with its float32 parameters and statistics and returns bf16."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, out_channels, 5, padding=2,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels, momentum=0.1, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = F.conv2d(x.to(dtype), self.conv1.weight.to(dtype), padding=2)
        return F.avg_pool2d(F.relu(self.bn1(x)), 2)


class Cnn6(nn.Module):
    """PANNs CNN6: input ``(B, 1, time, mel)``, output the sigmoid
    clipwise scores ``(B, classes_num)``.

    ``dtype`` is the conv stack's compute dtype (None: the parameters'
    dtype, or ``torch.bfloat16``); the mel batch norm and the head run
    in the parameters' dtype either way.

    SpecAugment (``augment=True``) is not ported yet: a training-mode
    forward with it raises.
    """

    def __init__(self, classes_num: int, n_mels: int, augment: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.augment = augment
        self.bn1 = nn.BatchNorm1d(n_mels, momentum=0.1, eps=1e-5)
        self.conv_block1 = ConvBlock5x5(1, 64, dtype)
        self.conv_block2 = ConvBlock5x5(64, 128, dtype)
        self.conv_block3 = ConvBlock5x5(128, 256, dtype)
        self.conv_block4 = ConvBlock5x5(256, 512, dtype)
        self.fc1 = nn.Linear(512, 512)
        self.fc_esc50 = nn.Linear(512, classes_num)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                xavier_uniform_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the training-mode dropout masks."""
        if self.training and self.augment:
            raise NotImplementedError("SpecAugment is not ported yet")
        # batch norm over mel bins, as rows (B * time, mel) with mel the
        # channel.  BatchNorm2d over the transposed (B, mel, time, 1) view
        # returned wrong gradients on the CPU when that view and its output
        # gradient came in different memory layouts (torch 2.13.0+cpu)
        x = self.bn1(x.reshape(-1, x.shape[-1])).reshape(x.shape)
        for block in (self.conv_block1, self.conv_block2,
                      self.conv_block3, self.conv_block4):
            x = dropout(block(x), 0.2, self.training, generator)
        x = x.to(self.fc1.weight.dtype).mean(dim=3)       # f32, over mel
        x = x.max(dim=2).values + x.mean(dim=2)           # over time
        x = dropout(x, 0.5, self.training, generator)
        x = F.relu(self.fc1(x))
        x = dropout(x, 0.5, self.training, generator)
        return torch.sigmoid(self.fc_esc50(x))
