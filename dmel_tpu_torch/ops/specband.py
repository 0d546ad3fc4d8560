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
  is the yardstick the kernels are held against.
- :func:`specband_mel_power`, an autograd function over two
  hand-written CUDA kernels: K1 (``csrc/specband_fwd.cu``, the
  forward) and K2 (``csrc/specband_bwd.cu``, the gradient in the taps,
  wrapped by :func:`specband_drho` with its plain version
  :func:`specband_drho_plain`).  CUDA tensors launch the kernels; CPU
  tensors take the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from math import gcd
from typing import NamedTuple

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


@functools.lru_cache(maxsize=16)
def _taps_basis(n_fft: int, j_taps: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """:func:`_taps_basis_np` on ``device``, copied there once: a copy
    from host memory on every call would make the host wait for the
    stream."""
    return torch.tensor(_taps_basis_np(n_fft, j_taps), dtype=dtype,
                        device=device)


def window_taps_sym(window: torch.Tensor, n_fft: int,
                    j_taps: int = SPECGEMM_J_TAPS) -> torch.Tensor:
    """Real taps ``rho_d / N``, ``d = -J .. J``, of a window symmetric
    about ``N/2``: ``rho_d = sum_m w[m] cos(2 pi (m - N/2) d / N)``.

    Differentiable in the window; this is the only place lambda enters
    the specband function.  A broadcast product and a sum, so the GPU
    route calls no matrix-product library.
    """
    cb = _taps_basis(n_fft, j_taps, window.dtype, window.device)
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


class _Geom(NamedTuple):
    """Static geometry of one specband call."""
    n_fft: int
    hop_length: int
    n_mels: int
    sample_rate: int
    f_min: float
    f_max: float
    j_taps: int
    log_epilogue: bool


def _mel_from_taps_plain(x2: torch.Tensor, rho: torch.Tensor,
                         g: _Geom) -> torch.Tensor:
    """Plain specband mel ``(B, n_mels, n_frames)`` of ``x2`` (B, T)
    from the taps ``rho``: direct extended-bin DFT, banded matmul with
    the tap matrix, power, mel, optional log."""
    dev = x2.device
    _, _, nt, kpad = _geom(g.n_fft, g.j_taps)
    frames = frame_signal(x2, g.n_fft, g.hop_length)    # (B, nfr, n_fft)
    bc, bs = _bases_np(g.n_fft, g.j_taps, kpad)
    xr = frames @ torch.tensor(bc, device=dev)
    xi = frames @ torch.tensor(bs, device=dev)
    tmat = band_matrix(rho, g.j_taps)
    width = LANE + 2 * g.j_taps
    tiles = []
    for f in range(nt):
        sre = xr[..., f * LANE:f * LANE + width] @ tmat
        sim = xi[..., f * LANE:f * LANE + width] @ tmat
        tiles.append(sre * sre + sim * sim)
    p = torch.cat(tiles, dim=-1)                        # (B, nfr, nt*LANE)
    fb = torch.tensor(fb_pad(g.n_fft, nt, g.n_mels, g.sample_rate, g.f_min,
                             g.f_max), device=dev)
    mel = (p @ fb)[..., :g.n_mels].transpose(-1, -2)
    if g.log_epilogue:
        mel = torch.log(mel + LOG_EPS)
    return mel


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
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    g = _Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
              float(f_max), j_taps, log_epilogue)
    rho = window_taps_sym(window.to(torch.float32), n_fft, j_taps)
    mel = _mel_from_taps_plain(x2, rho, g)
    return mel.reshape(lead + mel.shape[-2:])


@functools.lru_cache(maxsize=8)
def _kernel_consts(n_fft: int, j_taps: int, n_mels: int, sample_rate: int,
                   f_min: float, f_max: float, device: torch.device):
    """The kernels' constant operands on ``device``: the bases as one
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


def _consts(g: _Geom, device: torch.device):
    return _kernel_consts(g.n_fft, g.j_taps, g.n_mels, g.sample_rate,
                          g.f_min, g.f_max, device)


def _band_sum(plane: torch.Tensor, rho: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    """``S[:, k] = sum_i rho[i] plane[:, k + 2J - i]``, k < n_bins."""
    two_j = rho.shape[0] - 1
    return sum(rho[i] * plane[:, two_j - i:two_j - i + n_bins]
               for i in range(two_j + 1))


def _fwd_plain(x2: torch.Tensor, rho: torch.Tensor, g: _Geom):
    """K1's plain version in the kernel's buffer layout: ``(out,
    xext)`` with ``out`` (B, n_mels, n_frames) and ``xext`` the
    ``(B n_frames, 2 kp)`` spectra, cos plane in columns ``[0, kp)``,
    sin plane in ``[kp, 2 kp)``, row ``b n_frames + t``."""
    b, t = x2.shape
    nfr = num_frames(t, g.hop_length)
    n_bins = g.n_fft // 2 + 1
    basis, fb, kp = _consts(g, x2.device)
    frames = frame_signal(x2, g.n_fft, g.hop_length)
    xext = frames.reshape(b * nfr, g.n_fft) @ basis
    s_re = _band_sum(xext[:, :kp], rho, n_bins)
    s_im = _band_sum(xext[:, kp:], rho, n_bins)
    mel = (s_re * s_re + s_im * s_im) @ fb
    if g.log_epilogue:
        mel = torch.log(mel + LOG_EPS)
    return mel.reshape(b, nfr, g.n_mels).transpose(1, 2).contiguous(), xext


def _fwd_lib() -> ctypes.CDLL:
    """K1's library with its C signatures declared: pointers and the
    stream as ``c_void_p`` (ctypes would pass a bare Python int as a
    32-bit int), sizes as ``c_int``."""
    lib = _cuda.load("specband_fwd").cdll
    lib.specband_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                                 + [ctypes.c_void_p])
    lib.specband_fwd.restype = ctypes.c_int
    lib.specband_error_string.argtypes = [ctypes.c_int]
    lib.specband_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    """K2's library with its C signatures declared (as :func:`_fwd_lib`)."""
    lib = _cuda.load("specband_bwd").cdll
    lib.specband_bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
    lib.specband_bwd.restype = ctypes.c_int
    lib.specband_bwd_rows_per_block.argtypes = []
    lib.specband_bwd_rows_per_block.restype = ctypes.c_int
    lib.specband_bwd_error_string.argtypes = [ctypes.c_int]
    lib.specband_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _fwd(x2: torch.Tensor, rho: torch.Tensor, g: _Geom):
    """K1's wrapper: ``(out, xext)`` as :func:`_fwd_plain` gives them.
    CPU tensors take :func:`_fwd_plain`; CUDA tensors launch
    ``csrc/specband_fwd.cu``, on the current stream and without
    synchronising, and add one to ``specband_mel_power.launches``."""
    if x2.device.type == "cpu":
        return _fwd_plain(x2, rho, g)
    b, t = x2.shape
    nfr = num_frames(t, g.hop_length)
    n_bins, k_ext, _, _ = _geom(g.n_fft, g.j_taps)
    with torch.cuda.device(x2.device):
        basis, fb, kp = _consts(g, x2.device)
        rho = rho.contiguous()
        xext = torch.empty((b * nfr, 2 * kp), dtype=torch.float32,
                           device=x2.device)
        out = torch.empty((b, g.n_mels, nfr), dtype=torch.float32,
                          device=x2.device)
        lib = _fwd_lib()
        rc = lib.specband_fwd(
            x2.data_ptr(), basis.data_ptr(), rho.data_ptr(), fb.data_ptr(),
            xext.data_ptr(), out.data_ptr(), b, t, nfr, g.hop_length,
            g.n_fft, kp, k_ext, n_bins, 2 * g.j_taps + 1, g.n_mels,
            int(g.log_epilogue),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("specband_fwd launch failed: "
                           + lib.specband_error_string(rc).decode())
    specband_mel_power.launches += 1
    return out, xext


def specband_drho_plain(xext: torch.Tensor, rho: torch.Tensor,
                        fb: torch.Tensor, dmel: torch.Tensor,
                        logmel: torch.Tensor | None = None) -> torch.Tensor:
    """K2's plain version: the gradient in the ``2J + 1`` taps ``rho``,
    written as the kernel's arithmetic in float32 on any device.

    ``xext`` is K1's ``(rows, 2 kp)`` spectra buffer, ``fb`` the dense
    ``(n_bins, n_mels)`` filterbank and ``dmel`` the ``(B, n_mels,
    n_frames)`` cotangent of the mel power, or of the log-mel when
    ``logmel`` (the forward's log output) is given:
    ``g = dmel exp(-logmel)``, ``dP = g fb^T``, ``S`` recomputed from
    the taps, ``drho[i] = sum 2 dP (S_re X'_re + S_im X'_im)`` at the
    shift ``2J - i``.
    """
    rows, ncol = xext.shape
    kp = ncol // 2
    n_bins, n_mels = fb.shape
    two_j = rho.shape[0] - 1
    g = dmel if logmel is None else dmel * torch.exp(-logmel)
    dp = g.transpose(1, 2).reshape(rows, n_mels) @ fb.T
    xr, xi = xext[:, :kp], xext[:, kp:]
    wr = 2.0 * dp * _band_sum(xr, rho, n_bins)
    wi = 2.0 * dp * _band_sum(xi, rho, n_bins)
    return torch.stack([
        (wr * xr[:, two_j - i:two_j - i + n_bins]).sum()
        + (wi * xi[:, two_j - i:two_j - i + n_bins]).sum()
        for i in range(two_j + 1)])


def _check_drho_operands(xext, rho, fb, dmel, logmel):
    ops = [xext, rho, fb, dmel] + ([] if logmel is None else [logmel])
    for t in ops:
        if t.device != xext.device:
            raise ValueError(f"operand on {t.device}, xext on {xext.device}")
        if t.dtype != torch.float32:
            raise TypeError("specband_drho takes float32 operands")
        if not t.is_contiguous():
            raise ValueError("specband_drho takes contiguous operands")
    if xext.dim() != 2 or rho.dim() != 1 or fb.dim() != 2 or dmel.dim() != 3:
        raise ValueError("specband_drho: xext (rows, 2 kp), rho (taps,), "
                         "fb (n_bins, n_mels), dmel (B, n_mels, n_frames)")
    rows, ncol = xext.shape
    n_bins, n_mels = fb.shape
    b, m, nfr = dmel.shape
    if (ncol % 2 or n_bins + rho.shape[0] - 1 > ncol // 2 or m != n_mels
            or b * nfr != rows
            or (logmel is not None and logmel.shape != dmel.shape)):
        raise ValueError(
            f"specband_drho: inconsistent shapes xext {tuple(xext.shape)}, "
            f"rho {tuple(rho.shape)}, fb {tuple(fb.shape)}, dmel "
            f"{tuple(dmel.shape)}")


def specband_drho(xext: torch.Tensor, rho: torch.Tensor, fb: torch.Tensor,
                  dmel: torch.Tensor,
                  logmel: torch.Tensor | None = None) -> torch.Tensor:
    """K2's wrapper: the taps' gradient ``(2J + 1,)`` as
    :func:`specband_drho_plain` defines it.

    CPU tensors take :func:`specband_drho_plain`.  CUDA tensors launch
    ``csrc/specband_bwd.cu`` on the current stream, without
    synchronising, after checking device, dtype, shape and contiguity;
    a failed build or launch raises.  Each launch adds one to
    ``specband_drho.launches``.
    """
    if xext.device.type == "cpu":
        return specband_drho_plain(xext, rho, fb, dmel, logmel)
    if xext.device.type != "cuda":
        raise ValueError(f"specband runs on cpu or cuda, not {xext.device}")
    _check_drho_operands(xext, rho, fb, dmel, logmel)
    rows, ncol = xext.shape
    n_bins, n_mels = fb.shape
    n_taps = rho.shape[0]
    with torch.cuda.device(xext.device):
        lib = _bwd_lib()
        fr = lib.specband_bwd_rows_per_block()
        partials = torch.empty((n_taps, -(-rows // fr)), dtype=torch.float32,
                               device=xext.device)
        drho = torch.empty(n_taps, dtype=torch.float32, device=xext.device)
        rc = lib.specband_bwd(
            xext.data_ptr(), rho.data_ptr(), fb.data_ptr(), dmel.data_ptr(),
            None if logmel is None else logmel.data_ptr(),
            partials.data_ptr(), drho.data_ptr(), rows, dmel.shape[2],
            ncol // 2, n_bins + n_taps - 1, n_bins, n_taps, n_mels,
            torch.cuda.current_stream(xext.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("specband_bwd launch failed: "
                           + lib.specband_bwd_error_string(rc).decode())
    specband_drho.launches += 1
    return drho


specband_drho.launches = 0


class _SpecbandMel(torch.autograd.Function):
    """``(x2, rho) -> mel`` through K1, with the taps' gradient from K2:
    the counterpart of the JAX package's ``_specband_mel`` custom vjp.

    The JAX function differentiates ``band_matrix(rho)``, a TPU lane
    layout of the same ``2J + 1`` numbers, so its gradient summed over
    the band diagonals is this one.  The forward keeps K1's spectra
    buffer ``xext`` and, with the log epilogue, its output as the
    residuals.  ``dx`` (only when ``x2`` needs a gradient) is a vjp
    through the plain rebuild, outside any kernel, as there.
    """

    @staticmethod
    def forward(ctx, x2, rho, g: _Geom):
        out, xext = _fwd(x2, rho, g)
        ctx.g = g
        ctx.save_for_backward(x2, rho, xext, out if g.log_epilogue else None)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, rho, xext, logmel = ctx.saved_tensors
        g = ctx.g
        dout = dout.contiguous()
        dx = drho = None
        if ctx.needs_input_grad[1]:
            _, fb, _ = _consts(g, xext.device)
            drho = specband_drho(xext, rho.contiguous(), fb, dout, logmel)
        if ctx.needs_input_grad[0]:
            dmel = dout if logmel is None else dout * torch.exp(-logmel)
            with torch.enable_grad():
                xv = x2.detach().requires_grad_()
                mel = _mel_from_taps_plain(xv, rho.detach(),
                                           g._replace(log_epilogue=False))
                dx, = torch.autograd.grad(mel, xv, dmel)
        return dx, drho, None


def specband_mel_power(x: torch.Tensor, window: torch.Tensor, *,
                       n_fft: int, hop_length: int, n_mels: int,
                       sample_rate: int, f_min: float = 0.0,
                       f_max: float | None = None,
                       j_taps: int = SPECGEMM_J_TAPS,
                       log_epilogue: bool = False) -> torch.Tensor:
    """Specband mel power ``(..., n_mels, n_frames)`` through the CUDA
    kernels; ``log_epilogue=True`` returns ``log(mel + 1e-10)``
    computed in the kernel.

    CPU tensors take :func:`specband_mel_power_plain` (autograd through
    it gives every gradient).  CUDA tensors launch K1 (adding one to
    ``specband_mel_power.launches``), on the current stream and without
    synchronising; a failed build or launch raises.  The gradient in
    ``window`` comes from K2 through the taps (:func:`window_taps_sym`
    is differentiable), the gradient in ``x`` from the plain rebuild.
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
    if x.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("specband takes float32 signals and windows")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    g = _Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
              float(f_max), j_taps, log_epilogue)
    with torch.cuda.device(x.device):
        rho = window_taps_sym(window, n_fft, j_taps)
        out = _SpecbandMel.apply(x2, rho, g)
    return out.reshape(lead + out.shape[-2:])


specband_mel_power.launches = 0
