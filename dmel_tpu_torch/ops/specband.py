"""Specband mel power: extended-bin DFT spectra, real-tap banded window
convolution, power and mel projection (counterpart of
``dmel_tpu/ops/pallas/specband_dmel.py``).

A window symmetric about ``N/2`` (the Gaussian is) has the spectrum
``What[d] = (-1)^d rho_d`` with real ``rho``.  With the phase-flipped
spectra ``X'[k] = (-1)^k X[k]`` of the unwindowed frame, the windowed
spectrum is ``S[k] = (-1)^k sum_d rho_d X'[k + d] / N``, truncated to
``|d| <= J``.  The sign dies in ``|S|^2``, so lambda enters only
through the ``2J + 1`` real taps.

Two versions of the function live here:

- :func:`specband_mel_power_plain`, plain PyTorch in float32 on any
  device: the math of the JAX package's ``_specband_xla_ref``
  (direct extended-bin DFT, banded matmul with the tap matrix, power,
  mel).  The CPU tests hold it against the JAX package; on the GPU it
  is the yardstick the kernel is held against.
- :func:`specband_mel_power`, the wrapper of the hand-written CUDA
  kernel ``csrc/specband_fwd.cu``.  It launches the kernel for CUDA
  tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from math import gcd

import numpy as np
import torch

from dmel_tpu_torch.ops import _cuda
from dmel_tpu_torch.ops.mel import melscale_fbanks_np
from dmel_tpu_torch.ops.stft import SPECGEMM_J_TAPS, frame_signal, num_frames

LANE = 128
MEL_PAD = 128
#: epsilon of the log epilogue, ``log(mel + 1e-10)``
LOG_EPS = 1e-10
#: largest n_fft the kernel serves
SPECBAND_MAX_NFFT = 4096
#: the kernel's spectra planes (cos, sin) are padded to a multiple of
#: this many columns, half its GEMM tile width
_KP_ALIGN = 64


def supported(n_fft: int, hop_length: int, n_mels: int,
              j_taps: int = SPECGEMM_J_TAPS) -> bool:
    """Static geometry guard, verbatim from the JAX package so that the
    auto dispatch decides alike (the lambda-value guard is
    ``stft.specband_ok``)."""
    g = LANE // gcd(hop_length, LANE)
    return (n_fft % LANE == 0 and g <= 16 and n_mels <= MEL_PAD
            and (n_fft <= 1024 or n_fft in (2048, 4096))
            and 2 * j_taps < LANE
            and 2 * hop_length <= n_fft)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geom(n_fft: int, j_taps: int):
    """(n_bins, k_ext, nt, kpad): bins, extended bins ``-J .. n_bins-1+J``,
    128-bin output tiles, and the plain version's column padding (every
    tile's ``LANE + 2J``-wide slice lies inside it)."""
    n_bins = n_fft // 2 + 1
    k_ext = n_bins + 2 * j_taps
    nt = -(-n_bins // LANE)
    kpad = _round_up(max(k_ext, (nt - 1) * LANE + LANE + 2 * j_taps), LANE)
    return n_bins, k_ext, nt, kpad


@functools.lru_cache(maxsize=16)
def _bases_np(n_fft: int, j_taps: int, kpad: int):
    """Phase-flipped extended-bin DFT bases ``(n_fft, kpad)`` each.

    Column j holds bin ``k = j - J`` of ``(-1)^k DFT`` (cos and sin
    planes); columns ``>= k_ext`` are zero.  Built in float64, cast to
    float32.
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(kpad)[None, :] - j_taps
    valid = (k >= -j_taps) & (k < n_bins + j_taps)
    flip = np.where(k % 2 == 0, 1.0, -1.0)
    m = np.arange(n_fft)[:, None]
    ang = -2.0 * np.pi * m * k / n_fft
    c = np.where(valid, np.cos(ang) * flip, 0.0).astype(np.float32)
    s = np.where(valid, np.sin(ang) * flip, 0.0).astype(np.float32)
    c.flags.writeable = False
    s.flags.writeable = False
    return c, s


@functools.lru_cache(maxsize=16)
def _taps_basis_np(n_fft: int, j_taps: int) -> np.ndarray:
    m = np.arange(n_fft)[:, None] - n_fft / 2.0
    d = np.arange(j_taps + 1)[None, :]
    cb = np.cos(2.0 * np.pi * m * d / n_fft).astype(np.float32)
    cb.flags.writeable = False
    return cb


def window_taps_sym(window: torch.Tensor, n_fft: int,
                    j_taps: int = SPECGEMM_J_TAPS) -> torch.Tensor:
    """Real taps ``rho_d / N``, ``d = -J .. J``, of a window symmetric
    about ``N/2``: ``rho_d = sum_m w[m] cos(2 pi (m - N/2) d / N)``.

    Differentiable in the window; this is the only place lambda enters
    the specband function.  A broadcast product and a sum, so the GPU
    route calls no matrix-product library.
    """
    cb = torch.tensor(_taps_basis_np(n_fft, j_taps), dtype=window.dtype,
                      device=window.device)
    rho_pos = (window[:, None] * cb).sum(0)                 # (J + 1,)
    return torch.cat([rho_pos[1:].flip(0), rho_pos]) / n_fft


def band_matrix(rho: torch.Tensor, j_taps: int) -> torch.Tensor:
    """``(LANE + 2J, LANE)`` banded Toeplitz block
    ``T[u, v] = rho[v - u + 2J]`` on the band, 0 outside."""
    width = LANE + 2 * j_taps
    u = torch.arange(width, device=rho.device)[:, None]
    v = torch.arange(LANE, device=rho.device)[None, :]
    idx = v - u + 2 * j_taps
    valid = (idx >= 0) & (idx <= 2 * j_taps)
    return torch.where(valid, rho[idx.clamp(0, 2 * j_taps)],
                       torch.zeros((), dtype=rho.dtype, device=rho.device))


def fb_pad(n_fft: int, nt: int, n_mels: int, sample_rate: int,
           f_min: float, f_max: float) -> np.ndarray:
    """Mel filterbank zero-padded to ``(nt * LANE, MEL_PAD)``."""
    fb = melscale_fbanks_np(n_fft // 2 + 1, f_min, f_max, n_mels,
                            sample_rate)
    return np.pad(fb, ((0, nt * LANE - fb.shape[0]),
                       (0, MEL_PAD - n_mels)))


def _check(x, window, n_fft, hop_length, n_mels, j_taps):
    if window.shape[-1] != n_fft:
        raise ValueError("specband requires win_length == n_fft")
    if not supported(n_fft, hop_length, n_mels, j_taps):
        raise ValueError("unsupported geometry for the specband kernel; "
                         "gate with specband.supported")
    if window.device != x.device:
        raise ValueError(f"window on {window.device}, signal on {x.device}")


def specband_mel_power_plain(x: torch.Tensor, window: torch.Tensor, *,
                             n_fft: int, hop_length: int, n_mels: int,
                             sample_rate: int, f_min: float = 0.0,
                             f_max: float | None = None,
                             j_taps: int = SPECGEMM_J_TAPS,
                             log_epilogue: bool = False) -> torch.Tensor:
    """Plain PyTorch specband mel power ``(..., n_mels, n_frames)``.

    Float32 on the inputs' device; differentiable in ``x`` and
    ``window``.  ``log_epilogue=True`` returns ``log(mel + 1e-10)``.
    """
    if f_max is None:
        f_max = sample_rate // 2
    _check(x, window, n_fft, hop_length, n_mels, j_taps)
    dev = x.device
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    _, _, nt, kpad = _geom(n_fft, j_taps)
    frames = frame_signal(x2, n_fft, hop_length)        # (B, nfr, n_fft)
    bc, bs = _bases_np(n_fft, j_taps, kpad)
    xr = frames @ torch.tensor(bc, device=dev)
    xi = frames @ torch.tensor(bs, device=dev)
    tmat = band_matrix(window_taps_sym(window.to(torch.float32), n_fft,
                                       j_taps), j_taps)
    width = LANE + 2 * j_taps
    tiles = []
    for f in range(nt):
        sre = xr[..., f * LANE:f * LANE + width] @ tmat
        sim = xi[..., f * LANE:f * LANE + width] @ tmat
        tiles.append(sre * sre + sim * sim)
    p = torch.cat(tiles, dim=-1)                        # (B, nfr, nt*LANE)
    fb = torch.tensor(fb_pad(n_fft, nt, n_mels, sample_rate, f_min, f_max),
                      device=dev)
    mel = (p @ fb)[..., :n_mels].transpose(-1, -2)
    if log_epilogue:
        mel = torch.log(mel + LOG_EPS)
    return mel.reshape(lead + mel.shape[-2:])


@functools.lru_cache(maxsize=8)
def _kernel_consts(n_fft: int, j_taps: int, n_mels: int, sample_rate: int,
                   f_min: float, f_max: float, device: torch.device):
    """The kernel's constant operands on ``device``: the bases as one
    ``(n_fft, 2 kp)`` matrix (cos plane, then sin plane, each padded
    with zero columns to ``kp``), the dense ``(n_bins, n_mels)``
    filterbank, and ``kp``."""
    n_bins, k_ext, _, _ = _geom(n_fft, j_taps)
    kp = _round_up(k_ext, _KP_ALIGN)
    bc, bs = _bases_np(n_fft, j_taps, kp)
    basis = torch.tensor(np.concatenate([bc, bs], axis=1), device=device)
    fb = torch.tensor(melscale_fbanks_np(n_bins, f_min, f_max, n_mels,
                                         sample_rate), device=device)
    return basis, fb, kp


def _lib() -> ctypes.CDLL:
    """The kernel library with its C signatures declared: pointers and
    the stream as ``c_void_p`` (ctypes would pass a bare Python int as a
    32-bit int), sizes as ``c_int``."""
    lib = _cuda.load("specband_fwd").cdll
    lib.specband_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                                 + [ctypes.c_void_p])
    lib.specband_fwd.restype = ctypes.c_int
    lib.specband_error_string.argtypes = [ctypes.c_int]
    lib.specband_error_string.restype = ctypes.c_char_p
    return lib


def specband_mel_power(x: torch.Tensor, window: torch.Tensor, *,
                       n_fft: int, hop_length: int, n_mels: int,
                       sample_rate: int, f_min: float = 0.0,
                       f_max: float | None = None,
                       j_taps: int = SPECGEMM_J_TAPS,
                       log_epilogue: bool = False) -> torch.Tensor:
    """Specband mel power ``(..., n_mels, n_frames)`` through the CUDA
    kernel; ``log_epilogue=True`` returns ``log(mel + 1e-10)``
    computed in the kernel.

    CPU tensors take :func:`specband_mel_power_plain`.  CUDA tensors
    launch the kernel, on the current stream and without
    synchronising; a failed build or launch raises.  The backward
    kernel is not ported yet, so a CUDA call that would need a
    gradient raises ``NotImplementedError``.  Each launch adds one to
    ``specband_mel_power.launches``.
    """
    if f_max is None:
        f_max = sample_rate // 2
    _check(x, window, n_fft, hop_length, n_mels, j_taps)
    if x.device.type == "cpu":
        return specband_mel_power_plain(
            x, window, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            sample_rate=sample_rate, f_min=f_min, f_max=f_max,
            j_taps=j_taps, log_epilogue=log_epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"specband runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or window.requires_grad):
        raise NotImplementedError(
            "the specband backward kernel is not ported yet; run the "
            "specband route under torch.no_grad() or take impl='exact'")
    if x.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("specband takes float32 signals and windows")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    b, t = x2.shape
    nfr = num_frames(t, hop_length)
    n_bins, k_ext, _, _ = _geom(n_fft, j_taps)
    with torch.cuda.device(x.device):
        rho = window_taps_sym(window, n_fft, j_taps).contiguous()
        basis, fb, kp = _kernel_consts(n_fft, j_taps, n_mels, sample_rate,
                                       float(f_min), float(f_max), x.device)
        xext = torch.empty((b * nfr, 2 * kp), dtype=torch.float32,
                           device=x.device)
        out = torch.empty((b, n_mels, nfr), dtype=torch.float32,
                          device=x.device)
        lib = _lib()
        rc = lib.specband_fwd(
            x2.data_ptr(), basis.data_ptr(), rho.data_ptr(), fb.data_ptr(),
            xext.data_ptr(), out.data_ptr(), b, t, nfr, hop_length, n_fft,
            kp, k_ext, n_bins, 2 * j_taps + 1, n_mels, int(log_epilogue),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("specband_fwd launch failed: "
                           + lib.specband_error_string(rc).decode())
    specband_mel_power.launches += 1
    return out.reshape(lead + out.shape[-2:])


specband_mel_power.launches = 0
