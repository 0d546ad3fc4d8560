"""Fused mel power for any n_fft up to 4096 and a window shorter than
n_fft (counterpart of ``dmel_tpu/ops/pallas/fused_dmel.py``).

The JAX package framed the signal in XLA and ran its TPU kernel K5
(``_kernel_core``) over the frames.  Here the forward is the second entry
point of the framed forward kernel (``csrc/framed_fwd.cu``,
``fused_fwd``): it reads each frame at its own offset of the signal, so
no frames tensor is built, and takes an n_fft that is not a lane multiple
(faithful mode's ``2 T``) and a window centred in n_fft
(:func:`pad_window`).  Its spectra stage is an FFT per frame in shared
memory at every even n_fft (:func:`fft_plan.fused_stage`): the
Stockham stages of :func:`fft_plan.plan` where n_fft / 2 has no prime
factor above 5 (every power of two, faithful 3000), else Bluestein's
chirp-z through a power-of-two FFT (faithful mode's other 2 T, e.g.
1400); the direct DFT stays reachable through the C entry
(:func:`framed.launch_fwd` with no stage).

The backward into the window is, by default, not a kernel, in the JAX
package either (``USE_FUSED_BWD = False``): it is the adjoint chain
``_dmel_bwd`` over the saved Re|Im, written in torch
(:func:`framed.framed_dwindow_plain`), where ``torch.matmul`` plays the
part of XLA's GEMMs.  With :data:`USE_FUSED_BWD` set it is K6
(:func:`fused_dwindow`), the counterpart of the JAX package's fused dw
kernel: the second entry point of the framed backward kernel
(``csrc/framed_bwd.cu``, ``fused_bwd``), whose plain version is that same
torch adjoint: an inverse real FFT per frame through the same stage as
K5's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dmel_tpu_torch.ops import fft_plan, framed
from dmel_tpu_torch.ops.window import gaussian_window

#: largest n_fft the kernel serves (the JAX package's cap)
MAX_N_FFT = 4096

#: take the window's gradient from K6 (:func:`fused_dwindow`) instead of
#: the torch adjoint; off by default, as in the JAX package
USE_FUSED_BWD = False


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


def _count(counter, stage):
    """One launch on ``counter``: ``launches``, and ``fft_launches`` on a
    plan's FFT or ``bluestein_launches`` on Bluestein's."""
    counter.launches += 1
    if isinstance(stage, fft_plan.Bluestein):
        counter.bluestein_launches += 1
    elif stage is not None:
        counter.fft_launches += 1


def fused_fwd(x2: torch.Tensor, window: torch.Tensor, g: framed.Geom):
    """K5's wrapper: ``(out, reim)`` as :func:`framed.fwd_plain` gives
    them, ``window`` already centred in n_fft.  CPU tensors take
    :func:`framed.fwd_plain`; CUDA tensors launch ``csrc/framed_fwd.cu``
    (entry ``fused_fwd``) with the spectra stage
    :func:`fft_plan.fused_stage` picks for n_fft, and add one to
    ``dmel_power.launches`` and to ``dmel_power.fft_launches`` (a plan's
    FFT) or ``dmel_power.bluestein_launches``."""
    if x2.device.type == "cpu":
        return framed.fwd_plain(x2, window, g)
    stage = fft_plan.fused_stage(g.n_fft)
    res = framed.launch_fwd("fused_fwd", x2, window, g, stage)
    _count(dmel_power, stage)
    return res


def fused_dwindow(x2: torch.Tensor, reim: torch.Tensor, dmel: torch.Tensor,
                  g: framed.Geom) -> torch.Tensor:
    """K6's wrapper: the window's gradient ``(n_fft,)`` from K5's residual,
    as :func:`framed.framed_dwindow_plain` defines it.  CPU tensors take
    that plain version; CUDA tensors launch ``csrc/framed_bwd.cu`` (entry
    ``fused_bwd``, any even n_fft up to 4096) with the stage
    :func:`fft_plan.fused_stage` picks for n_fft, and add one to
    ``fused_dwindow.launches`` and to ``fused_dwindow.fft_launches`` (a
    plan's inverse FFT) or ``fused_dwindow.bluestein_launches``."""
    if x2.device.type == "cpu":
        return framed.framed_dwindow_plain(x2, reim, dmel, g)
    stage = fft_plan.fused_stage(g.n_fft)
    dw = framed.launch_bwd("fused_bwd", x2, reim, dmel, g, stage)
    _count(fused_dwindow, stage)
    return dw


fused_dwindow.launches = 0
fused_dwindow.fft_launches = 0
fused_dwindow.bluestein_launches = 0


def fused_fwd_packed(x2: torch.Tensor, windows: torch.Tensor,
                     g: framed.Geom):
    """K5's wrapper on a pack of K trials: ``x2`` (K B, T), trial k's rows
    ``k B ..``, ``windows`` (K, n_fft) each centred in n_fft; ``(out,
    reim)`` as :func:`fused_fwd` gives them on each trial's rows,
    concatenated.  CPU tensors take :func:`framed.fwd_plain` on each
    trial; CUDA tensors launch ``csrc/framed_fwd.cu`` (entry
    ``fused_fwd``) once for the pack, and add one to
    ``fused_fwd_packed.launches``."""
    if x2.device.type == "cpu":
        return framed._looped_fwd(framed.fwd_plain, x2, windows, g)
    res = framed.launch_fwd("fused_fwd", x2, windows, g,
                            fft_plan.fused_stage(g.n_fft))
    fused_fwd_packed.launches += 1
    return res


fused_fwd_packed.launches = 0


def fused_dwindow_packed(x2: torch.Tensor, reim: torch.Tensor,
                         dmel: torch.Tensor, g: framed.Geom,
                         trials: int) -> torch.Tensor:
    """K6's wrapper on a pack of ``trials`` trials (rows as
    :func:`fused_fwd_packed`'s): the windows' gradients ``(trials,
    n_fft)``.  CPU tensors take :func:`framed.framed_dwindow_plain` on
    each trial; CUDA tensors launch ``csrc/framed_bwd.cu`` (entry
    ``fused_bwd``) once for the pack, its partials per (trial, block),
    and add one to ``fused_dwindow_packed.launches``."""
    if x2.device.type == "cpu":
        return framed._looped_dwindow(framed.framed_dwindow_plain, x2, reim,
                                      dmel, g, trials)
    dw = framed.launch_bwd("fused_bwd", x2, reim, dmel, g,
                           fft_plan.fused_stage(g.n_fft), trials)
    fused_dwindow_packed.launches += 1
    return dw.reshape(trials, g.n_fft)


fused_dwindow_packed.launches = 0


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
    tensors launch K5 (adding one to ``dmel_power.launches``, and to
    ``dmel_power.fft_launches`` where n_fft takes a plan's FFT or to
    ``dmel_power.bluestein_launches`` where it takes Bluestein's) on the
    current stream, without synchronising, and float32 only
    (``TypeError`` otherwise); CPU tensors run the same autograd function
    over the plain forward.  The window's gradient comes from K6 when
    :data:`USE_FUSED_BWD` is set, else from the torch adjoint.

    A vector ``lambd`` (K,) is a pack of K trials: ``x`` (K, ..., T),
    trial k's rows analysed with ``lambd[k]``'s window, the result ``(K,
    ..., n_mels, n_frames)``; CUDA tensors launch K5 once for the pack
    (:func:`fused_fwd_packed`) and K6 (:func:`fused_dwindow_packed`) or
    the torch adjoint on each trial for the gradient.
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
    if w.dim() == 2:
        dwindow = (fused_dwindow_packed if USE_FUSED_BWD
                   else framed.framed_dwindow_plain_packed)
        out = framed.WindowedMelPacked.apply(x2, w.contiguous(), g,
                                             fused_fwd_packed, dwindow)
    else:
        dwindow = (fused_dwindow if USE_FUSED_BWD
                   else framed.framed_dwindow_plain)
        out = framed.WindowedMel.apply(x2, w, g, fused_fwd, dwindow)
    return out.reshape(lead + out.shape[-2:])


dmel_power.launches = 0
dmel_power.fft_launches = 0
dmel_power.bluestein_launches = 0
