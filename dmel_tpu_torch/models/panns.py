"""PANNs backbones: CNN6, Cnn14 and the attention head (counterpart of
``dmel_tpu/models/panns.py``).

PyTorch layout: ``Cnn6`` and ``Cnn14`` take ``(B, 1, time, mel)``, as
the original PANNs code does, and ``AttBlock`` takes ``(B, C, time)``.
Batch norm has torch's output and flax's statistics (momentum 0.1, eps
1e-5, the running variance from the biased batch variance:
:class:`BiasedBatchNorm1d`, :class:`BiasedBatchNorm2d`).  Weights are
Xavier-uniform with zero biases, drawn from a ``torch.Generator``;
SpecAugment's and dropout's masks in training come from the generator
the caller passes to ``forward``.

Inside a :func:`~dmel_tpu_torch.distributed.mesh_scope` of more than
one rank each rank holds its rows of the global batch: the masks are
drawn at the global shape and each rank keeps its rows, and the batch
norms take their statistics over the global batch
(:func:`_global_batch_norm`).

``dtype=torch.bfloat16`` runs the conv stack in bf16, as the JAX
package's ``model_dtype="bfloat16"`` does: each block's convolutions,
batch-norm outputs, ReLUs, pooling and dropout.  The casts are explicit,
not ``torch.autocast``: the weights and batch-norm parameters stay
float32 and are cast in ``forward``, batch-norm statistics are computed
and kept in float32, the mel batch norm (``bn1``, Cnn14's ``bn0``) and
SpecAugment run in float32 (so the front end's gradient arrives in
float32), and the head casts to float32 before the mean over mel.

The JAX package's ``Patches5x5Conv`` computes the one-input-channel
first convolution as an im2col matrix product, a workaround for the TPU
matrix unit's contraction depth; here it is a plain convolution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dmel_tpu_torch.distributed import all_reduce_sum, data_mesh, rank_rand


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
            generator: Optional[torch.Generator] = None,
            dim: int = 0) -> torch.Tensor:
    """Inverted dropout with flax's semantics: keep each element with
    probability ``1 - p`` and scale it by ``1 / (1 - p)``.  The mask is
    drawn from ``generator`` (on ``x``'s device; None takes torch's
    default generator) in float32 whatever ``x``'s dtype, so a bf16 and
    a float32 model draw the same masks from the same generator state;
    in a mesh scope, at the global shape, each rank keeping its slice of
    the split axis ``dim`` (:func:`~dmel_tpu_torch.distributed.rank_rand`).
    The identity outside training."""
    if not training:
        return x
    keep = rank_rand(x.shape, generator, x.device, dim) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class _BiasedVariance:
    """Mixin for torch's batch norms: in training the running variance
    takes the biased batch variance, as flax's ``BatchNorm`` does; the
    output is torch's, which normalises by the biased variance anyway.

    torch's update is ``rv = (1 - m) rv_old + m n / (n - 1) v`` (``v``
    the biased variance over ``n = numel / C`` values a channel); the
    biased one is ``rv - (rv - (1 - m) rv_old) / n``.  So the fused
    kernel runs as it is, statistics in float32 whatever the input's
    dtype, on a copy of ``rv_old`` (autograd keeps the tensor it
    updates, which must not change again), and the repair takes no
    second pass over the activations.  In a data-parallel mesh scope of
    more than one rank the statistics are the global batch's
    (:func:`_global_batch_norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        mesh = data_mesh()
        if mesh is not None:
            return _global_batch_norm(self, x, mesh)
        rv = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            old = self.running_var
            old.copy_(rv - (rv - (1.0 - self.momentum) * old) / n)
        return y


def _global_batch_norm(bn: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """Training-mode batch norm of this rank's rows ``x`` with the mean and
    the biased variance of the global batch: per-channel sums (float32,
    or ``x``'s dtype where wider) summed over the ranks through the
    differentiable all-reduce, first the mean's, then the squared
    deviations' (two passes, as exact as a single device's kernel).  The
    running statistics take flax's update at the global ``n``; the
    output is in ``x``'s dtype."""
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    shape = [1, c] + [1] * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.numel() // c * mesh.size
    mean = all_reduce_sum(xf.sum(dims), mesh) / n
    d = xf - mean.reshape(shape)
    var = all_reduce_sum((d * d).sum(dims), mesh) / n
    y = d * torch.rsqrt(var + bn.eps).reshape(shape)
    if bn.affine:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return y.to(x.dtype)


class BiasedBatchNorm1d(_BiasedVariance, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance
    (:class:`_BiasedVariance`)."""


class BiasedBatchNorm2d(_BiasedVariance, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance
    (:class:`_BiasedVariance`)."""


def mask_span(x: torch.Tensor, dim: int, mask_param: int,
              u_width: torch.Tensor, u_start: torch.Tensor) -> torch.Tensor:
    """``x`` with one span along ``dim`` set to 0 in each clip, from the
    clips' uniforms ``u_width`` and ``u_start`` (``(B,)`` float32 in
    [0, 1)): width ``u_width * mask_param``, start ``u_start * (L -
    width)``, the positions ``i`` with ``start <= i < start + width``
    masked (torchaudio's ``iid_masks`` distribution, in float32 as the
    JAX package computes it)."""
    length = x.shape[dim]
    width = u_width * mask_param
    start = u_start * (length - width)
    idx = torch.arange(length, dtype=torch.float32, device=x.device)
    mask = (idx >= start[:, None]) & (idx < (start + width)[:, None])
    shape = [1] * x.dim()
    shape[0], shape[dim] = x.shape[0], length
    return torch.where(mask.reshape(shape),
                       torch.zeros((), dtype=x.dtype, device=x.device), x)


def time_mask(x: torch.Tensor, mask_param: int,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SpecAugment time masking of ``(B, 1, T, M)``, iid per clip: the
    widths' uniforms, then the starts', drawn from ``generator`` (on
    ``x``'s device; None takes torch's default generator); in a mesh
    scope at the global batch, each rank keeping its clips'."""
    u = rank_rand((2, x.shape[0]), generator, x.device, dim=1)
    return mask_span(x, 2, mask_param, u[0], u[1])


def freq_mask(x: torch.Tensor, mask_param: int,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SpecAugment frequency masking over the mel axis of ``(B, 1, T,
    M)``, drawn as :func:`time_mask` draws."""
    u = rank_rand((2, x.shape[0]), generator, x.device, dim=1)
    return mask_span(x, 3, mask_param, u[0], u[1])


def _pool(x: torch.Tensor, pool_size: Tuple[int, int],
          pool_type: str) -> torch.Tensor:
    if pool_type == "max":
        return F.max_pool2d(x, pool_size)
    if pool_type == "avg":
        return F.avg_pool2d(x, pool_size)
    if pool_type == "avg+max":
        return F.avg_pool2d(x, pool_size) + F.max_pool2d(x, pool_size)
    raise ValueError(f"Incorrect pool_type: {pool_type!r}")


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype):
    """``conv`` (no bias, "same" padding) of ``x``, both cast to
    ``dtype``."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype),
                    padding=conv.padding)


def _xavier_init(module: nn.Module,
                 generator: Optional[torch.Generator]) -> None:
    """Xavier-uniform weights and zero biases for every convolution and
    linear layer of ``module``, drawn in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            xavier_uniform_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def _mel_batch_norm(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Batch norm over the mel bins of ``(B, 1, time, mel)``, as rows
    ``(B * time, mel)`` with mel the channel.  BatchNorm2d over the
    transposed ``(B, mel, time, 1)`` view returned wrong gradients on the
    CPU when that view and its output gradient came in different memory
    layouts (torch 2.13.0+cpu)."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


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
        self.bn1 = BiasedBatchNorm2d(out_channels, momentum=0.1, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(x, self.conv1, self.dtype or x.dtype)
        return F.avg_pool2d(F.relu(self.bn1(x)), 2)


class ConvBlock(nn.Module):
    """Two conv3x3 (no bias) + BN + ReLU, then pool; ``dtype`` as in
    :class:`ConvBlock5x5`."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = BiasedBatchNorm2d(out_channels, momentum=0.1, eps=1e-5)
        self.bn2 = BiasedBatchNorm2d(out_channels, momentum=0.1, eps=1e-5)

    def forward(self, x: torch.Tensor, pool_size=(2, 2),
                pool_type: str = "avg") -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        x = F.relu(self.bn2(_conv(x, self.conv2, dtype)))
        return _pool(x, pool_size, pool_type)


class AttBlock(nn.Module):
    """Attention pooling head over ``(B, n_in, time)``: returns the
    clipwise output ``(B, n_out)``, the attention ``(B, n_out, time)``
    (softmax over time of the clipped ``att``) and the framewise
    ``cla`` (sigmoid where ``activation="sigmoid"``).  ``bn_att`` and
    ``temperature`` exist, as in PANNs, and are never applied."""

    def __init__(self, n_in: int, n_out: int, activation: str = "linear",
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.temperature = temperature
        self.att = nn.Conv1d(n_in, n_out, 1)
        self.cla = nn.Conv1d(n_in, n_out, 1)
        self.bn_att = BiasedBatchNorm1d(n_out, momentum=0.1, eps=1e-5)
        _xavier_init(self, generator)

    def forward(self, x: torch.Tensor):
        norm_att = torch.softmax(torch.clamp(self.att(x), -10, 10), dim=-1)
        cla = self.cla(x)
        if self.activation == "sigmoid":
            cla = torch.sigmoid(cla)
        return (norm_att * cla).sum(dim=-1), norm_att, cla


class Cnn6(nn.Module):
    """PANNs CNN6: input ``(B, 1, time, mel)``, output the sigmoid
    clipwise scores ``(B, classes_num)``.

    ``dtype`` is the conv stack's compute dtype (None: the parameters'
    dtype, or ``torch.bfloat16``); the mel batch norm and the head run
    in the parameters' dtype either way.

    ``augment=True`` applies SpecAugment in training, after the mel
    batch norm: :func:`time_mask` (64 frames) then :func:`freq_mask` (8
    mels).  ``forward``'s generator is drawn in this order: the time
    mask's uniforms, the frequency mask's, then the dropout masks.
    """

    def __init__(self, classes_num: int, n_mels: int, augment: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.augment = augment
        self.bn1 = BiasedBatchNorm1d(n_mels, momentum=0.1, eps=1e-5)
        self.conv_block1 = ConvBlock5x5(1, 64, dtype)
        self.conv_block2 = ConvBlock5x5(64, 128, dtype)
        self.conv_block3 = ConvBlock5x5(128, 256, dtype)
        self.conv_block4 = ConvBlock5x5(256, 512, dtype)
        self.fc1 = nn.Linear(512, 512)
        self.fc_esc50 = nn.Linear(512, classes_num)
        _xavier_init(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the training-mode SpecAugment and dropout
        masks."""
        x = _mel_batch_norm(self.bn1, x)
        if self.training and self.augment:
            x = time_mask(x, 64, generator)
            x = freq_mask(x, 8, generator)
        for block in (self.conv_block1, self.conv_block2,
                      self.conv_block3, self.conv_block4):
            x = dropout(block(x), 0.2, self.training, generator)
        x = x.to(self.fc1.weight.dtype).mean(dim=3)       # f32, over mel
        x = x.max(dim=2).values + x.mean(dim=2)           # over time
        x = dropout(x, 0.5, self.training, generator)
        x = F.relu(self.fc1(x))
        x = dropout(x, 0.5, self.training, generator)
        return torch.sigmoid(self.fc_esc50(x))


class Cnn14(nn.Module):
    """PANNs Cnn14 over a precomputed log-mel ``(B, 1, time, mel)``, as
    :class:`Cnn6`: six :class:`ConvBlock` stages (64 to 2048 channels,
    the last without pooling), each followed by dropout 0.2, then the
    same head with ``fc1`` 2048 wide and ``fc_audioset``.  ``dtype`` as
    in :class:`Cnn6`; ``forward``'s generator draws the dropout masks."""

    WIDTHS = (64, 128, 256, 512, 1024, 2048)

    def __init__(self, classes_num: int, n_mels: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn0 = BiasedBatchNorm1d(n_mels, momentum=0.1, eps=1e-5)
        for i, (cin, cout) in enumerate(zip((1,) + self.WIDTHS[:-1],
                                            self.WIDTHS), start=1):
            setattr(self, f"conv_block{i}", ConvBlock(cin, cout, dtype))
        self.fc1 = nn.Linear(2048, 2048)
        self.fc_audioset = nn.Linear(2048, classes_num)
        _xavier_init(self, generator)

    def frames(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The conv stack's output averaged over mel, ``(B, 2048,
        time / 32)`` in float32: the frames the head pools (and an
        :class:`AttBlock` takes)."""
        x = _mel_batch_norm(self.bn0, x)
        for i in range(1, 7):
            x = getattr(self, f"conv_block{i}")(
                x, pool_size=(1, 1) if i == 6 else (2, 2))
            x = dropout(x, 0.2, self.training, generator)
        return x.to(self.fc1.weight.dtype).mean(dim=3)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.frames(x, generator)
        x = x.max(dim=2).values + x.mean(dim=2)
        x = dropout(x, 0.5, self.training, generator)
        x = F.relu(self.fc1(x))
        x = dropout(x, 0.5, self.training, generator)
        return torch.sigmoid(self.fc_audioset(x))
