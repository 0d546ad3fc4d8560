"""Fused mel power for any n_fft up to 4096 and a window shorter than
n_fft (counterpart of ``dmel_tpu/ops/pallas/fused_dmel.py``).

The JAX package framed the signal in XLA and ran its TPU kernel K5
(``_kernel_core``) over the frames.  Here the forward is the second entry
point of the framed forward kernel (``csrc/framed_fwd.cu``,
``fused_fwd``): it reads each frame at its own offset of the signal, so
no frames tensor is built, and takes an n_fft that is not a lane multiple
(faithful mode's ``2 T``) and a window centred in n_fft
(:func:`pad_window`).

The backward is not a kernel, in the JAX package either
(``USE_FUSED_BWD = False``): it is the adjoint chain ``_dmel_bwd`` over
the saved Re|Im, written in torch (:func:`framed.framed_dwindow_plain`),
where ``torch.matmul`` plays the part of XLA's GEMMs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmel_tpu_torch.ops import framed
from dmel_tpu_torch.ops.window import gaussian_window

#: largest n_fft the kernel serves (the JAX package's cap)
MAX_N_FFT = 4096


def pad_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Centre-pad a window of length ``win_length <= n_fft`` to ``n_fft``:
    ``(n_fft - win_length) // 2`` zeros on the left, as ``torch.stft``
    places a short window."""
    win_length = window.shape[-1]
    if win_length == n_fft:
        return window
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    left = (n_fft - win_length) // 2
    return F.pad(window, (left, n_fft - win_length - left))


def _window(lambd, win_length: int, n_fft: int, normalize_window: bool,
            device: torch.device) -> torch.Tensor:
    lambd = torch.as_tensor(lambd, dtype=torch.float32).to(device)
    return pad_window(gaussian_window(lambd, win_length,
                                      norm=normalize_window), n_fft)


def _check(win_length: int, n_fft: int):
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    if n_fft > MAX_N_FFT or n_fft < 2 or n_fft % 2:
        raise ValueError(f"the fused kernel takes an even n_fft up to "
                         f"{MAX_N_FFT}, not {n_fft}")


def dmel_power_plain(x: torch.Tensor, lambd, *, win_length: int,
                     n_fft: int, hop_length: int, n_mels: int,
                     sample_rate: int, f_min: float = 0.0,
                     f_max: float | None = None,
                     normalize_window: bool = False) -> torch.Tensor:
    """Plain PyTorch fused mel power ``(..., n_mels, n_frames)`` in
    float32, differentiable in ``x`` and ``lambd``; the contract of
    :func:`dmel_power`."""
    if f_max is None:
        f_max = sample_rate // 2
    _check(win_length, n_fft)
    lead = x.shape[:-1]
    g = framed.Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
                    float(f_max))
    w = _window(lambd, win_length, n_fft, normalize_window, x.device)
    mel = framed.mel_plain(x.reshape(-1, x.shape[-1]).to(torch.float32), w,
                           g)
    return mel.reshape(lead + mel.shape[-2:])


def fused_fwd(x2: torch.Tensor, window: torch.Tensor, g: framed.Geom):
    """K5's wrapper: ``(out, reim)`` as :func:`framed.fwd_plain` gives
    them, ``window`` already centred in n_fft.  CPU tensors take
    :func:`framed.fwd_plain`; CUDA tensors launch ``csrc/framed_fwd.cu``
    (entry ``fused_fwd``) and add one to ``dmel_power.launches``."""
    if x2.device.type == "cpu":
        return framed.fwd_plain(x2, window, g)
    res = framed.launch_fwd("fused_fwd", x2, window, g)
    dmel_power.launches += 1
    return res


def dmel_power(x: torch.Tensor, lambd, *, win_length: int, n_fft: int,
               hop_length: int, n_mels: int, sample_rate: int,
               f_min: float = 0.0, f_max: float | None = None,
               normalize_window: bool = False) -> torch.Tensor:
    """Fused mel power ``(..., n_mels, n_frames)`` of ``x`` (..., T) with
    the Gaussian window of ``lambd`` (``win_length`` samples, centred in
    ``n_fft``), no log (the contract of the JAX package's
    ``fused_dmel.dmel_power``): ``win_length <= n_fft``, any even
    ``n_fft <= 4096``, else ``ValueError``.

    Differentiable in ``lambd`` (through the window) and ``x``.  CUDA
    tensors launch K5 (adding one to ``dmel_power.launches``) on the
    current stream, without synchronising, and float32 only
    (``TypeError`` otherwise); CPU tensors run the same autograd function
    over the plain forward.
    """
    if f_max is None:
        f_max = sample_rate // 2
    _check(win_length, n_fft)
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise TypeError("the fused kernel takes float32 signals")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    g = framed.Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
                    float(f_max))
    w = _window(lambd, win_length, n_fft, normalize_window, x.device)
    out = framed.WindowedMel.apply(x2, w, g, fused_fwd,
                                   framed.framed_dwindow_plain)
    return out.reshape(lead + out.shape[-2:])


dmel_power.launches = 0
