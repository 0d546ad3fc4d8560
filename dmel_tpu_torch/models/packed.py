"""A pack of K models of one configuration family, run as one program
with an explicit leading trial axis (the port's counterpart of the JAX
package's ``jax.vmap`` over stacked parameters in
``dmel_tpu/parallel/trials.py``).

:class:`TrialPack` stacks K models' parameters and buffers along a new
leading axis (``torch.func.stack_module_state``); the names are the
models' own, so trial k's slice of every tensor is trial k's
``state_dict``.  :meth:`TrialPack.forward` takes ``x`` (K, B, T) and
gives ``(out (K, B, classes), s (K, B, 1, F, T'))``, trial k's from its
own slice:

- the front end is the packed DMEL or DSPEC function (``mel_spectrogram``
  with ``lambd`` (K,), or (K, n_sigma) for the multi-sigma layer;
  ``spectrogram`` with (K,)), so each front-end kernel runs once for the
  pack;
- convolutions are one grouped convolution (``groups = K``), linear
  layers one batched product, batch norms one call over the (trial,
  channel) pairs with flax's running variance
  (:class:`~dmel_tpu_torch.models.panns.BiasedBatchNorm1d`'s update);
- dropout and SpecAugment draw their masks over the whole pack from one
  generator, so every trial draws its own; CNN6's bf16 casts are those
  of :class:`~dmel_tpu_torch.models.panns.Cnn6`.  Each mask is split
  over an axis that holds the trials in order (the trial axis, or the
  conv stack's trial-major channels), so a pack whose trials are split
  over ranks (a ``mesh_scope`` with ``axis="trial"``) draws the whole
  pack's and keeps its trials' part.

``torch.func.vmap`` over ``functional_call`` does not serve here: its
batch-norm rule refuses a bf16 input with float32 statistics (torch
2.13), the dtype split CNN6 runs in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dmel_tpu_torch.models import classifiers as C
from dmel_tpu_torch.models.layers import MultiSigmaMelSpectrogramLayer
from dmel_tpu_torch.models.panns import dropout, freq_mask, time_mask
from dmel_tpu_torch.ops.dmel import (mel_spectrogram,
                                     multi_sigma_mel_spectrogram)
from dmel_tpu_torch.ops.specband import LOG_EPS
from dmel_tpu_torch.ops.spectrogram import spectrogram


def linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """Trial k's ``name`` linear layer on ``x[k]`` (K, B, D): one batched
    product."""
    return torch.baddbmm(p[name + ".bias"][:, None, :], x,
                         p[name + ".weight"].transpose(1, 2))


def conv_folded(x: torch.Tensor, weight: torch.Tensor, padding,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Trial k's convolution ``weight[k]`` (K, O, C, kh, kw) on the
    channels ``k C .. (k + 1) C - 1`` of ``x`` (B, K C, H, W): one grouped
    convolution, output (B, K O, H', W'); both cast to ``dtype`` when
    given (no bias)."""
    w = weight.reshape((-1,) + weight.shape[2:])
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    return F.conv2d(x, w, padding=padding, groups=weight.shape[0])


def batch_norm(x: torch.Tensor, p: dict, name: str, bn: nn.Module,
               training: bool) -> torch.Tensor:
    """``bn`` (a :class:`~dmel_tpu_torch.models.panns.BiasedBatchNorm1d`
    or ``2d`` of the template) with trial k's parameters and statistics on
    the channels ``k C ..`` of ``x`` (rows, K C, ...).  In training the
    statistics of every trial update in place, the running variance from
    the biased batch variance, as the module's own forward does."""
    weight = p[name + ".weight"].reshape(-1)
    bias = p[name + ".bias"].reshape(-1)
    mean = p[name + ".running_mean"].view(-1)
    var = p[name + ".running_var"]
    if not training:
        return F.batch_norm(x, mean, var.view(-1), weight, bias, False,
                            bn.momentum, bn.eps)
    p[name + ".num_batches_tracked"].add_(1)
    rv = var.reshape(-1).clone()
    y = F.batch_norm(x, mean, rv, weight, bias, True, bn.momentum, bn.eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        old = var.view(-1)
        old.copy_(rv - (rv - (1.0 - bn.momentum) * old) / n)
    return y


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(K, B, C, H, W) -> (B, K C, H, W), trial-major channels."""
    return x.transpose(0, 1).reshape((x.shape[1], -1) + x.shape[3:])


def _unfold(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, K C, ...) -> (K, B, C, ...)."""
    return x.reshape((x.shape[0], k, -1) + x.shape[2:]).transpose(0, 1)


class TrialPack:
    """K models built from one configuration family, stacked.

    ``params`` and ``buffers`` map each of the models' names to a tensor
    with a leading axis of K (parameters are leaves that require a
    gradient).  ``template`` is the first model, moved to the ``meta``
    device: it keeps the static attributes (geometry, route, dtypes)
    and its weights are never read.  ``training`` picks dropout, the
    batch statistics and SpecAugment, as ``nn.Module.train`` does.
    """

    def __init__(self, models: list):
        if not models:
            raise ValueError("a pack needs at least one model")
        kind = type(models[0])
        if kind not in _FORWARDS or any(type(m) is not kind for m in models):
            raise NotImplementedError(
                f"no packed forward for {[type(m).__name__ for m in models]}")
        self.params, self.buffers = torch.func.stack_module_state(models)
        self.k = len(models)
        self.template = models[0].to("meta")
        self.training = True
        self._forward = _FORWARDS[kind]

    @property
    def layer(self) -> nn.Module:
        """The template's front-end layer (its geometry is the pack's)."""
        return self.template.spectrogram_layer

    def set_geometry(self, window_length, lambd_hint) -> None:
        """Set the pack's one bucket and hint, as the single layer's
        ``set_geometry`` does."""
        self.layer.set_geometry(window_length, lambd_hint)

    def train(self, mode: bool = True) -> "TrialPack":
        self.training = mode
        return self

    def eval(self) -> "TrialPack":
        return self.train(False)

    def state(self) -> dict:
        """Every stacked tensor by name, parameters and buffers."""
        return {**self.params, **self.buffers}

    def trial_state_dict(self, i: int) -> dict:
        """Trial ``i``'s ``state_dict`` on the CPU: its slice of every
        tensor, copied (the other trials' are not transferred)."""
        return {n: t[i].detach().to("cpu", copy=True)
                for n, t in self.state().items()}

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``(out, s)`` of every trial on its rows of ``x`` (K, B, T)."""
        if x.shape[0] != self.k:
            raise ValueError(f"x has {x.shape[0]} trials, the pack {self.k}")
        return self._forward(self, self.state(), x, generator)

    __call__ = forward


def _mel_features(pack: TrialPack, p: dict, x: torch.Tensor):
    """The DMEL front end of every trial, (K, B, 1, M, T')."""
    layer = pack.layer
    fn = (multi_sigma_mel_spectrogram
          if isinstance(layer, MultiSigmaMelSpectrogramLayer)
          else mel_spectrogram)
    s = fn(x, p["spectrogram_layer.lambd"], n_mels=layer.n_mels,
           sample_rate=layer.sample_rate, hop_length=layer.hop_length,
           optimized=layer.optimized, window_length=layer.window_length,
           normalize_window=layer.normalize_window, impl=layer.impl,
           lambd_hint=layer.lambd_hint, device=x.device)[:, :, None]
    if pack.template.energy_normalize:
        s = torch.log(s + LOG_EPS)
    return s


def _spec_features(pack: TrialPack, p: dict, x: torch.Tensor):
    """The DSPEC front end of every trial, (K, B, 1, F, T')."""
    layer = pack.layer
    x = x - x.mean(dim=-1, keepdim=True)
    s = spectrogram(x, p["spectrogram_layer.lambd"].abs(),
                    optimized=layer.optimized, hop_length=layer.hop_length,
                    norm=layer.normalize_window,
                    window_length=layer.window_length)
    return s[:, :, None]


def _flat(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(s.shape[0], s.shape[1], -1)


def _conv_head(pack: TrialPack, p: dict, s: torch.Tensor) -> torch.Tensor:
    """The conv probes' head (:func:`classifiers._conv_head`) of every
    trial on ``s`` (K, B, 1, F, T)."""
    conv = pack.template.conv1
    h = F.relu(conv_folded(_fold(s), p["conv1.weight"], conv.padding)
               + p["conv1.bias"].reshape(1, -1, 1, 1))
    h = F.relu(linear(_flat(_unfold(h, pack.k)), p, "fc1"))
    return linear(h, p, "fc2")


def _mel_linear(pack, p, x, generator):
    s = _mel_features(pack, p, x)
    h = dropout(_flat(s), 0.2, pack.training, generator)
    return linear(h, p, "fc"), s


def _mel_mlp(pack, p, x, generator):
    s = _mel_features(pack, p, x)
    h = dropout(F.relu(linear(_flat(s), p, "fc1")), 0.2, pack.training,
                generator)
    return linear(h, p, "fc2"), s


def _mel_conv(pack, p, x, generator):
    s = _mel_features(pack, p, x)
    return _conv_head(pack, p, s), s


def _mel_panns(pack, p, x, generator):
    """:class:`classifiers.MelPANNsNet` (DMEL + CNN6) of every trial."""
    s = _mel_features(pack, p, x)                          # (K, B, 1, M, T)
    net = pack.template.spectrogram_model
    k, b, _, n_mels, t = s.shape
    pre = "spectrogram_model."
    # the mel batch norm over rows (B T) with (trial, mel) channels
    h = s.transpose(3, 4).permute(1, 2, 3, 0, 4).reshape(b * t, k * n_mels)
    h = batch_norm(h, p, pre + "bn1", net.bn1, pack.training)
    h = h.reshape(b, 1, t, k, n_mels).permute(3, 0, 1, 2, 4)
    if pack.training and net.augment:
        h = h.reshape(k * b, 1, t, n_mels)
        h = time_mask(h, 64, generator)
        h = freq_mask(h, 8, generator)
        h = h.reshape(k, b, 1, t, n_mels)
    h = _fold(h)                                           # (B, K, T, M)
    for i in range(1, 5):
        block = getattr(net, f"conv_block{i}")
        name = f"{pre}conv_block{i}"
        h = conv_folded(h, p[name + ".conv1.weight"], block.conv1.padding,
                        block.dtype or h.dtype)
        h = F.avg_pool2d(F.relu(batch_norm(h, p, name + ".bn1", block.bn1,
                                           pack.training)), 2)
        h = dropout(h, 0.2, pack.training, generator, dim=1)
    h = h.to(p[pre + "fc1.weight"].dtype).mean(dim=3)     # f32, over mel
    h = h.max(dim=2).values + h.mean(dim=2)                # over time
    h = h.reshape(b, k, -1).transpose(0, 1)                # (K, B, 512)
    h = dropout(h, 0.5, pack.training, generator)
    h = F.relu(linear(h, p, pre + "fc1"))
    h = dropout(h, 0.5, pack.training, generator)
    return torch.sigmoid(linear(h, p, pre + "fc_esc50")), s


def _linear_probe(pack, p, x, generator):
    s = _spec_features(pack, p, x)
    return linear(_flat(s), p, "fc"), s


def _mlp_probe(pack, p, x, generator):
    s = _spec_features(pack, p, x)
    return linear(F.relu(linear(_flat(s), p, "fc1")), p, "fc2"), s


def _bn_linear_probe(pack, p, x, generator):
    s = _spec_features(pack, p, x)                         # (K, B, 1, F, T)
    k, b = s.shape[:2]
    sb = batch_norm(_fold(s[:, :, 0]), p, "bn", pack.template.bn,
                    pack.training)
    sb = _unfold(sb, k)[:, :, None]
    return linear(_flat(sb), p, "fc"), sb


def _conv_probe(pack, p, x, generator):
    s = _spec_features(pack, p, x)
    return _conv_head(pack, p, s), s


_FORWARDS = {C.MelLinearNet: _mel_linear, C.MelMlpNet: _mel_mlp,
             C.MelConvNet: _mel_conv, C.MelPANNsNet: _mel_panns,
             C.LinearNet: _linear_probe, C.MlpNet: _mlp_probe,
             C.BatchNormLinearNet: _bn_linear_probe, C.ConvNet: _conv_probe}
