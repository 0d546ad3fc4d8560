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
  forward, whose spectra stage is an FFT per frame in shared memory
  wherever :func:`fft_plan.plan` has a plan for n_fft, else the direct
  DFT) and K2 (``csrc/specband_bwd.cu``, the gradient in the taps,
  wrapped by :func:`specband_drho` with its plain version
  :func:`specband_drho_plain`).  CUDA tensors launch the kernels; CPU
  tensors take the plain version.

The multi-sigma pair :func:`specband_mel_power_multi_plain` and
:func:`specband_mel_power_multi` (the JAX package's
``specband_mel_power_multi``) runs K windows through the same kernels at
``k_sig = K``: one spectra pass, a ``(K, 2J + 1)`` tap matrix, and mel
band ``m`` taken from the power of tap vector ``band_map[m]`` (the
per-sigma masked filterbank of :func:`fb_pad`).  Its launches count on
``specband_mel_power_multi.launches`` and ``specband_drho.multi_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from math import gcd
from typing import NamedTuple

import numpy as np
import torch

from dmel_tpu_torch.ops import _cuda, fft_plan
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
#: most sigma groups of one multi-sigma call (the JAX package's
#: ``k_sig * 128 <= 1024``)
MAX_SIGMA = 8
#: bins K1's band stage convolves at a time (``CHUNK`` in
#: ``csrc/specband_fwd.cu``); a band group spans one or two of them
#: (:func:`band_plan`)
BAND_CHUNK = 128


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
    about ``N/2``: ``rho_d = sum_m w[m] cos(2 pi (m - N/2) d / N)``;
    ``(..., 2J + 1)`` for windows ``(..., n_fft)``.

    Differentiable in the window; this is the only place lambda enters
    the specband function.  A broadcast product and a sum, so the GPU
    route calls no matrix-product library.
    """
    cb = _taps_basis(n_fft, j_taps, window.dtype, window.device)
    rho_pos = (window[..., :, None] * cb).sum(-2)           # (..., J + 1)
    return torch.cat([rho_pos[..., 1:].flip(-1), rho_pos], -1) / n_fft


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
           f_min: float, f_max: float, band_map=None,
           k_sig: int = 1) -> np.ndarray:
    """Mel filterbank zero-padded to ``(nt * LANE, MEL_PAD)``; for
    ``k_sig > 1``, ``(nt * k_sig * LANE, MEL_PAD)`` with rows ordered
    (tile, sigma, lane) and each sigma's copy masked to the mel bands
    ``band_map`` gives it (the JAX package's ``_fb_pad``)."""
    fb = melscale_fbanks_np(n_fft // 2 + 1, f_min, f_max, n_mels,
                            sample_rate)
    fb = np.pad(fb, ((0, nt * LANE - fb.shape[0]), (0, MEL_PAD - n_mels)))
    if k_sig == 1:
        return fb
    sel = np.zeros((MEL_PAD, k_sig), np.float32)
    sel[np.arange(n_mels), np.asarray(band_map)] = 1.0
    fb4 = fb.reshape(nt, 1, LANE, MEL_PAD) * sel.T[None, :, None, :]
    return np.ascontiguousarray(fb4.reshape(nt * k_sig * LANE, MEL_PAD))


def _check(x, window, n_fft, hop_length, n_mels, j_taps):
    if window.shape[-1] != n_fft:
        raise ValueError("specband requires win_length == n_fft")
    if not supported(n_fft, hop_length, n_mels, j_taps):
        raise ValueError("unsupported geometry for the specband kernel; "
                         "gate with specband.supported")
    if window.device != x.device:
        raise ValueError(f"window on {window.device}, signal on {x.device}")


def _check_multi(x, windows, band_map, n_fft, hop_length, n_mels, j_taps):
    """The multi-sigma call's guards (the JAX package's, plus the band
    map's own); returns the band map as a tuple of ints."""
    if windows.dim() != 2:
        raise ValueError("windows must be (K, n_fft), one a sigma group")
    _check(x, windows, n_fft, hop_length, n_mels, j_taps)
    return check_band_map(band_map, n_mels, windows.shape[0])


def check_band_map(band_map, n_mels: int, k_sig: int) -> tuple:
    """``band_map`` as a tuple of ``n_mels`` ints in ``[0, k_sig)``, the
    sigma groups at most 8; ``ValueError`` otherwise."""
    if k_sig > MAX_SIGMA:
        raise ValueError(f"too many sigma groups: {k_sig} > {MAX_SIGMA}")
    bm = tuple(int(v) for v in np.asarray(band_map).reshape(-1))
    if len(bm) != n_mels or not all(0 <= v < k_sig for v in bm):
        raise ValueError(f"band_map must give each of the {n_mels} mel "
                         f"bands a sigma group in [0, {k_sig})")
    return bm


@functools.lru_cache(maxsize=16)
def _band_map_tensor(band_map: tuple, device: torch.device) -> torch.Tensor:
    """The band map as an int32 tensor on ``device``, copied there once."""
    return torch.tensor(band_map, dtype=torch.int32, device=device)


class _Geom(NamedTuple):
    """Static geometry of one specband call; ``band_map`` (a tuple, one
    sigma group a mel band) only on the multi-sigma function."""
    n_fft: int
    hop_length: int
    n_mels: int
    sample_rate: int
    f_min: float
    f_max: float
    j_taps: int
    log_epilogue: bool
    band_map: tuple | None = None


def _taps2(rho: torch.Tensor) -> torch.Tensor:
    """The taps as a ``(k_sig, 2J + 1)`` matrix."""
    return rho[None] if rho.dim() == 1 else rho


def _mel_from_taps_plain(x2: torch.Tensor, rho: torch.Tensor,
                         g: _Geom) -> torch.Tensor:
    """Plain specband mel ``(B, n_mels, n_frames)`` of ``x2`` (B, T)
    from the taps ``rho`` (``(2J + 1,)``, or ``(K, 2J + 1)`` with
    ``g.band_map``): direct extended-bin DFT, banded matmul with the
    concatenated tap matrix, power, the (masked) filterbank, optional
    log."""
    dev = x2.device
    _, _, nt, kpad = _geom(g.n_fft, g.j_taps)
    rho2 = _taps2(rho)
    k_sig = rho2.shape[0]
    frames = frame_signal(x2, g.n_fft, g.hop_length)    # (B, nfr, n_fft)
    bc, bs = _bases_np(g.n_fft, g.j_taps, kpad)
    xr = frames @ torch.tensor(bc, device=dev)
    xi = frames @ torch.tensor(bs, device=dev)
    tmat = torch.cat([band_matrix(r, g.j_taps) for r in rho2], dim=1)
    width = LANE + 2 * g.j_taps
    tiles = []
    for f in range(nt):
        sre = xr[..., f * LANE:f * LANE + width] @ tmat
        sim = xi[..., f * LANE:f * LANE + width] @ tmat
        tiles.append(sre * sre + sim * sim)
    p = torch.cat(tiles, dim=-1)                   # (B, nfr, nt*K*LANE)
    fb = torch.tensor(fb_pad(g.n_fft, nt, g.n_mels, g.sample_rate, g.f_min,
                             g.f_max, g.band_map, k_sig), device=dev)
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


def specband_mel_power_multi_plain(x: torch.Tensor, windows: torch.Tensor,
                                   band_map, *, n_fft: int, hop_length: int,
                                   n_mels: int, sample_rate: int,
                                   f_min: float = 0.0,
                                   f_max: float | None = None,
                                   j_taps: int = SPECGEMM_J_TAPS
                                   ) -> torch.Tensor:
    """Plain PyTorch multi-sigma specband mel power ``(..., n_mels,
    n_frames)``: ``windows`` ``(K, n_fft)``, one symmetric window a
    sigma group, and ``band_map`` (``n_mels`` ints in ``[0, K)``) the
    group of each mel band.  Float32 on the inputs' device;
    differentiable in ``x`` and ``windows``; the guards of
    :func:`specband_mel_power_multi`."""
    if f_max is None:
        f_max = sample_rate // 2
    bm = _check_multi(x, windows, band_map, n_fft, hop_length, n_mels,
                      j_taps)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    g = _Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
              float(f_max), j_taps, False, bm)
    rho = window_taps_sym(windows.to(torch.float32), n_fft, j_taps)
    mel = _mel_from_taps_plain(x2, rho, g)
    return mel.reshape(lead + mel.shape[-2:])


def _kp(n_fft: int, j_taps: int) -> int:
    """Columns of one plane of the kernels' spectra buffer: the ``k_ext``
    extended bins padded to a multiple of 64."""
    return _round_up(_geom(n_fft, j_taps)[1], _KP_ALIGN)


@functools.lru_cache(maxsize=8)
def _fb_dense(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
              f_max: float, device: torch.device) -> torch.Tensor:
    """The dense ``(n_bins, n_mels)`` filterbank on ``device``."""
    return torch.tensor(melscale_fbanks_np(n_fft // 2 + 1, f_min, f_max,
                                           n_mels, sample_rate),
                        device=device)


def _fb(g: _Geom, device: torch.device) -> torch.Tensor:
    return _fb_dense(g.n_fft, g.n_mels, g.sample_rate, g.f_min, g.f_max,
                     device)


class BandPlan(NamedTuple):
    """K1's band groups for one geometry (:func:`band_plan`).

    ``groups`` ``(n_groups, 5)`` int32: each group's sigma, its bin range
    ``[lo, hi)`` (the union of its bands' nonzero ranges; ``[0, 0)`` when
    they have none) and its bands ``[m0, m1)``; ``bands`` ``(n_mels, 2)``
    int32: each band's nonzero bin range of the filterbank (``[0, 0)`` for
    an all-zero column); ``max_bands``: the most bands a group holds;
    ``cap``: the most bins a group of more than one band spans."""
    groups: np.ndarray
    bands: np.ndarray
    max_bands: int
    cap: int


@functools.lru_cache(maxsize=32)
def band_plan(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
              f_max: float, band_map: tuple | None = None) -> BandPlan:
    """Cut the mel bands into K1's band groups: runs of consecutive bands
    that share one sigma under ``band_map`` (``None``: all sigma 0), each
    cut where adding a band would make its bins span more than the cap,
    counted from its first bin rounded down to a multiple of 4 (where the
    kernel's 16-byte loads start).  A band wider than the cap is a group
    of its own.  The kernel walks a group in chunks of :data:`BAND_CHUNK`
    bins.

    The cap is one chunk where no band spans more than half a chunk, else
    two.  A cut between two groups of one sigma costs the bins their
    neighbouring triangles share, about half a band convolved twice; a
    second chunk costs its halo, 2J columns staged again.  Bands wider
    than half a chunk (n_fft 2048 and 4096 at 8 kHz) make the cut the
    dearer.

    Read from the numpy filterbank that :func:`_fb_dense` uploads, so the
    plan and the filterbank the kernel reads are one geometry's."""
    fb = melscale_fbanks_np(n_fft // 2 + 1, f_min, f_max, n_mels,
                            sample_rate)
    sigma = (0,) * n_mels if band_map is None else band_map
    bands = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1] + 1
    widest = int((bands[:, 1] - bands[:, 0]).max())
    cap = BAND_CHUNK if 2 * widest <= BAND_CHUNK else 2 * BAND_CHUNK
    groups = []
    for m in range(n_mels):
        lo, hi = bands[m]
        g = groups[-1] if groups else None
        if g is not None and g[0] == sigma[m]:
            if hi == lo:
                g[4] = m + 1
                continue
            glo, ghi = (lo, hi) if g[1] == g[2] else (min(g[1], lo),
                                                      max(g[2], hi))
            if ghi - (glo & ~3) <= cap or g[1] == g[2]:
                g[1:3], g[4] = (glo, ghi), m + 1
                continue
        groups.append([sigma[m], lo, hi, m, m + 1])
    groups = np.array(groups, np.int32)
    for a in (groups, bands):
        a.flags.writeable = False
    return BandPlan(groups, bands, int((groups[:, 4] - groups[:, 3]).max()),
                    cap)


@functools.lru_cache(maxsize=16)
def _band_plan_tensors(n_fft: int, n_mels: int, sample_rate: int,
                       f_min: float, f_max: float, band_map: tuple | None,
                       device: torch.device):
    """:func:`band_plan` as int32 tensors on ``device``, copied there
    once: ``(groups, bands, n_groups, max_bands)``."""
    plan = band_plan(n_fft, n_mels, sample_rate, f_min, f_max, band_map)
    return (torch.tensor(plan.groups, device=device),
            torch.tensor(plan.bands, device=device), len(plan.groups),
            plan.max_bands)


@functools.lru_cache(maxsize=8)
def _kernel_consts(n_fft: int, j_taps: int, n_mels: int, sample_rate: int,
                   f_min: float, f_max: float, device: torch.device):
    """The direct stage's constant operands on ``device``: the bases as
    one ``(n_fft, 2 kp)`` matrix (cos plane, then sin plane, each padded
    with zero columns to ``kp``), the dense ``(n_bins, n_mels)``
    filterbank, and ``kp``."""
    kp = _kp(n_fft, j_taps)
    bc, bs = _bases_np(n_fft, j_taps, kp)
    basis = torch.tensor(np.concatenate([bc, bs], axis=1), device=device)
    return (basis, _fb_dense(n_fft, n_mels, sample_rate, f_min, f_max,
                             device), kp)


def _consts(g: _Geom, device: torch.device):
    return _kernel_consts(g.n_fft, g.j_taps, g.n_mels, g.sample_rate,
                          g.f_min, g.f_max, device)


@functools.lru_cache(maxsize=8)
def _fft_consts(n_fft: int, j_taps: int, device: torch.device):
    """The FFT stage's constant operands on ``device``: the ``(2, n_fft)``
    cos / -sin table and the extended-bin map ``(bins, signs)`` of
    :func:`fft_plan.ext_bin_map`."""
    bins, signs = fft_plan.ext_bin_map(n_fft, j_taps, _kp(n_fft, j_taps))
    return tuple(torch.tensor(a, device=device) for a in
                 (fft_plan.table_np(n_fft), bins, signs))


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
    sin plane in ``[kp, 2 kp)``, row ``b n_frames + t``.  With
    ``(K, 2J + 1)`` taps, mel band ``m`` is taken from the power of tap
    vector ``g.band_map[m]``."""
    b, t = x2.shape
    nfr = num_frames(t, g.hop_length)
    basis = _consts(g, x2.device)[0]
    frames = frame_signal(x2, g.n_fft, g.hop_length)
    xext = frames.reshape(b * nfr, g.n_fft) @ basis
    return band_mel_plain(xext, rho, g, b), xext


def band_mel_plain(xext: torch.Tensor, rho: torch.Tensor, g: _Geom,
                   batch: int) -> torch.Tensor:
    """K1's band stage in plain PyTorch: ``out`` (B, n_mels, n_frames)
    from the ``(B n_frames, 2 kp)`` spectra buffer ``xext`` and the taps,
    as :func:`_fwd_plain` computes it after its spectra."""
    kp = xext.shape[1] // 2
    n_bins = g.n_fft // 2 + 1
    nfr = xext.shape[0] // batch
    fb = _fb(g, xext.device)
    mels = []
    for r in _taps2(rho):
        s_re = _band_sum(xext[:, :kp], r, n_bins)
        s_im = _band_sum(xext[:, kp:], r, n_bins)
        mels.append((s_re * s_re + s_im * s_im) @ fb)
    mel = mels[0]
    if g.band_map is not None:
        bands = torch.arange(g.n_mels, device=xext.device)
        sigma = _band_map_tensor(g.band_map, xext.device).long()
        mel = torch.stack(mels)[sigma, :, bands].T
    if g.log_epilogue:
        mel = torch.log(mel + LOG_EPS)
    return mel.reshape(batch, nfr, g.n_mels).transpose(1, 2).contiguous()


def _fwd_lib() -> ctypes.CDLL:
    """K1's library with its C signatures declared: pointers and the
    stream as ``c_void_p`` (ctypes would pass a bare Python int as a
    32-bit int), sizes as ``c_int``."""
    lib = _cuda.load("specband_fwd").cdll
    lib.specband_fwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 15
                                 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p])
    lib.specband_fwd.restype = ctypes.c_int
    lib.specband_error_string.argtypes = [ctypes.c_int]
    lib.specband_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    """K2's library with its C signatures declared (as :func:`_fwd_lib`)."""
    lib = _cuda.load("specband_bwd").cdll
    lib.specband_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                                 + [ctypes.c_void_p])
    lib.specband_bwd.restype = ctypes.c_int
    lib.specband_bwd_partial_blocks.argtypes = []
    lib.specband_bwd_partial_blocks.restype = ctypes.c_int
    lib.specband_bwd_error_string.argtypes = [ctypes.c_int]
    lib.specband_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _pack_of(rows: int, rho: torch.Tensor, trials: int | None):
    """``(trials, rows of one trial, k_sig)`` of a launch: ``trials`` None
    is one trial with ``rho`` ``(2J + 1,)`` or ``(k_sig, 2J + 1)``; an int
    K is a pack whose ``rho`` has a leading axis of K and whose trial k
    owns rows ``k (rows / K) ..``; ``ValueError`` otherwise."""
    k = 1 if trials is None else trials
    single_dim = rho.dim() - (trials is not None)
    if (k < 1 or rows % k or (trials is not None and rho.shape[0] != k)
            or single_dim not in (1, 2)):
        raise ValueError(f"specband: {rows} rows and taps "
                         f"{tuple(rho.shape)} are no pack of {k}")
    return k, rows // k, rho.shape[-2] if single_dim == 2 else 1


def launch_fwd(x2: torch.Tensor, rho: torch.Tensor, g: _Geom,
               radices: tuple[int, ...] | None, trials: int | None = None,
               *, band_stage: bool = True):
    """Launch K1 (``csrc/specband_fwd.cu``) at ``k_sig`` = the taps' rows
    on the current stream, without synchronising: ``(out, xext)`` as
    :func:`_fwd_plain` gives them.  ``trials`` K launches a pack of K
    trials in one grid (:func:`_pack_of`; ``rho`` ``(K, ...)``): one
    spectra pass over all rows, trial k's band stage with its own taps,
    its outputs those of a launch on its rows alone.  ``radices`` is the
    spectra stage, the FFT of that plan (:func:`fft_plan.plan`) or
    ``None`` for the direct DFT.  The band stage takes the geometry's
    :func:`band_plan`; ``band_stage=False`` launches the spectra stage
    alone and gives ``(None, xext)``.  A failed build or launch raises.
    The caller counts the launch."""
    bk, t = x2.shape
    k, b, k_sig = _pack_of(bk, rho, trials)
    nfr = num_frames(t, g.hop_length)
    n_bins, k_ext, _, _ = _geom(g.n_fft, g.j_taps)
    kp = _kp(g.n_fft, g.j_taps)
    with torch.cuda.device(x2.device):
        fb = _fb(g, x2.device)
        basis = table = bins = signs = None
        if radices is None:
            basis = _consts(g, x2.device)[0]
        else:
            table, bins, signs = _fft_consts(g.n_fft, g.j_taps, x2.device)
        groups, bands, n_groups, max_bands = _band_plan_tensors(
            g.n_fft, g.n_mels, g.sample_rate, g.f_min, g.f_max, g.band_map,
            x2.device)
        rho = rho.contiguous()
        xext = torch.empty((bk * nfr, 2 * kp), dtype=torch.float32,
                           device=x2.device)
        out = (torch.empty((bk, g.n_mels, nfr), dtype=torch.float32,
                           device=x2.device) if band_stage else None)
        lib = _fwd_lib()
        rc = lib.specband_fwd(
            x2.data_ptr(), *(None if a is None else a.data_ptr()
                             for a in (basis, table, bins, signs, rho, fb,
                                       groups, bands, xext, out)),
            b, k, t, nfr, g.hop_length, g.n_fft, kp, k_ext, n_bins,
            2 * g.j_taps + 1, g.n_mels, k_sig, int(g.log_epilogue),
            n_groups, max_bands, *_cuda.plan_args(radices),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("specband_fwd launch failed: "
                           + lib.specband_error_string(rc).decode())
    return out, xext


def _fwd(x2: torch.Tensor, rho: torch.Tensor, g: _Geom):
    """K1's wrapper: ``(out, xext)`` as :func:`_fwd_plain` gives them.
    CPU tensors take :func:`_fwd_plain`; CUDA tensors launch
    ``csrc/specband_fwd.cu`` (:func:`launch_fwd`) with the spectra stage
    :func:`fft_plan.plan` picks for n_fft, and add one to
    ``specband_mel_power.launches`` (or, with ``g.band_map``, to
    ``specband_mel_power_multi.launches``) and, on the FFT stage, to that
    function's ``fft_launches``."""
    if x2.device.type == "cpu":
        return _fwd_plain(x2, rho, g)
    radices = fft_plan.plan(g.n_fft)
    res = launch_fwd(x2, rho, g, radices)
    counter = (specband_mel_power if g.band_map is None
               else specband_mel_power_multi)
    counter.launches += 1
    if radices is not None:
        counter.fft_launches += 1
    return res


def specband_drho_plain(xext: torch.Tensor, rho: torch.Tensor,
                        fb: torch.Tensor, dmel: torch.Tensor,
                        logmel: torch.Tensor | None = None,
                        band_map=None) -> torch.Tensor:
    """K2's plain version: the gradient in the ``2J + 1`` taps ``rho``,
    written as the kernel's arithmetic in float32 on any device.

    ``xext`` is K1's ``(rows, 2 kp)`` spectra buffer, ``fb`` the dense
    ``(n_bins, n_mels)`` filterbank and ``dmel`` the ``(B, n_mels,
    n_frames)`` cotangent of the mel power, or of the log-mel when
    ``logmel`` (the forward's log output) is given:
    ``g = dmel exp(-logmel)``, ``dP = g fb^T``, ``S`` recomputed from
    the taps, ``drho[i] = sum 2 dP (S_re X'_re + S_im X'_im)`` at the
    shift ``2J - i``.

    With ``(K, 2J + 1)`` taps and ``band_map`` (``n_mels`` ints in
    ``[0, K)``) it gives ``(K, 2J + 1)``: sigma ``s`` takes ``dP_s`` over
    its own mel bands only.
    """
    rows, ncol = xext.shape
    kp = ncol // 2
    n_bins, n_mels = fb.shape
    two_j = rho.shape[-1] - 1
    g = dmel if logmel is None else dmel * torch.exp(-logmel)
    g = g.transpose(1, 2).reshape(rows, n_mels)
    xr, xi = xext[:, :kp], xext[:, kp:]

    def one(r, dp):
        wr = 2.0 * dp * _band_sum(xr, r, n_bins)
        wi = 2.0 * dp * _band_sum(xi, r, n_bins)
        return torch.stack([
            (wr * xr[:, two_j - i:two_j - i + n_bins]).sum()
            + (wi * xi[:, two_j - i:two_j - i + n_bins]).sum()
            for i in range(two_j + 1)])

    if rho.dim() == 1:
        return one(rho, g @ fb.T)
    sigma = _band_map_tensor(check_band_map(band_map, n_mels, rho.shape[0]),
                             xext.device)
    return torch.stack([one(r, (g * (sigma == s)) @ fb.T)
                        for s, r in enumerate(rho)])


def _check_drho_operands(xext, rho, fb, dmel, logmel, band_map,
                         trials=None):
    ops = [xext, rho, fb, dmel] + ([] if logmel is None else [logmel])
    for t in ops:
        if t.device != xext.device:
            raise ValueError(f"operand on {t.device}, xext on {xext.device}")
        if t.dtype != torch.float32:
            raise TypeError("specband_drho takes float32 operands")
        if not t.is_contiguous():
            raise ValueError("specband_drho takes contiguous operands")
    taps_dim = (1 if band_map is None else 2) + (trials is not None)
    if (xext.dim() != 2 or rho.dim() != taps_dim
            or fb.dim() != 2 or dmel.dim() != 3):
        raise ValueError("specband_drho: xext (rows, 2 kp), rho (taps,) or "
                         "(K, taps) with a band_map, fb (n_bins, n_mels), "
                         "dmel (B, n_mels, n_frames)")
    rows, ncol = xext.shape
    n_bins, n_mels = fb.shape
    b, m, nfr = dmel.shape
    if (ncol % 2 or n_bins + rho.shape[-1] - 1 > ncol // 2 or m != n_mels
            or b * nfr != rows
            or (logmel is not None and logmel.shape != dmel.shape)):
        raise ValueError(
            f"specband_drho: inconsistent shapes xext {tuple(xext.shape)}, "
            f"rho {tuple(rho.shape)}, fb {tuple(fb.shape)}, dmel "
            f"{tuple(dmel.shape)}")


def specband_drho(xext: torch.Tensor, rho: torch.Tensor, fb: torch.Tensor,
                  dmel: torch.Tensor, logmel: torch.Tensor | None = None,
                  band_map=None, trials: int | None = None) -> torch.Tensor:
    """K2's wrapper: the taps' gradient, ``(2J + 1,)`` or, with
    ``(K, 2J + 1)`` taps and a ``band_map``, ``(K, 2J + 1)``, as
    :func:`specband_drho_plain` defines it.

    CPU tensors take :func:`specband_drho_plain`.  CUDA tensors launch
    ``csrc/specband_bwd.cu`` at ``k_sig = K`` on the current stream,
    without synchronising, after checking device, dtype, shape and
    contiguity; a failed build or launch raises.  Each launch adds one
    to ``specband_drho.launches``, or with a ``band_map`` to
    ``specband_drho.multi_launches``.  ``trials`` K (and ``rho`` ``(K,
    ...)``) launches a pack of K trials in one grid, the caller counting
    the launch (:func:`specband_drho_packed`); trial k's gradient is a
    launch's on its rows alone, bit for bit.
    """
    if xext.device.type == "cpu":
        return specband_drho_plain(xext, rho, fb, dmel, logmel, band_map)
    if xext.device.type != "cuda":
        raise ValueError(f"specband runs on cpu or cuda, not {xext.device}")
    _check_drho_operands(xext, rho, fb, dmel, logmel, band_map, trials)
    rows, ncol = xext.shape
    n_bins, n_mels = fb.shape
    k, rows, k_sig = _pack_of(rows, rho, trials)
    n_taps = rho.shape[-1]
    with torch.cuda.device(xext.device):
        bm = (None if band_map is None else _band_map_tensor(
            check_band_map(band_map, n_mels, k_sig), xext.device))
        lib = _bwd_lib()
        sig_range = torch.empty((k_sig, 2), dtype=torch.int32,
                                device=xext.device)
        bin_range = torch.empty((n_bins, 2), dtype=torch.int32,
                                device=xext.device)
        partials = torch.empty(
            (k * k_sig * n_taps, lib.specband_bwd_partial_blocks()),
            dtype=torch.float32, device=xext.device)
        drho = torch.empty(rho.shape, dtype=torch.float32,
                           device=xext.device)
        rc = lib.specband_bwd(
            xext.data_ptr(), rho.data_ptr(), fb.data_ptr(), dmel.data_ptr(),
            None if logmel is None else logmel.data_ptr(),
            None if bm is None else bm.data_ptr(), sig_range.data_ptr(),
            bin_range.data_ptr(), partials.data_ptr(), drho.data_ptr(), rows,
            k, dmel.shape[2], ncol // 2, n_bins + n_taps - 1, n_bins, n_taps,
            n_mels, k_sig, torch.cuda.current_stream(xext.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("specband_bwd launch failed: "
                           + lib.specband_bwd_error_string(rc).decode())
    if trials is None:
        if band_map is None:
            specband_drho.launches += 1
        else:
            specband_drho.multi_launches += 1
    return drho


specband_drho.launches = 0
specband_drho.multi_launches = 0


def fwd_packed(x2: torch.Tensor, rho: torch.Tensor, g: _Geom):
    """K1's wrapper on a pack of K trials: ``x2`` (K B, T), trial k's rows
    ``k B ..``, ``rho`` (K, 2J + 1), or (K, k_sig, 2J + 1) with
    ``g.band_map``; ``(out, xext)`` as :func:`_fwd` gives them on each
    trial's rows, concatenated.  CPU tensors take :func:`_fwd_plain` on
    each trial; CUDA tensors launch ``csrc/specband_fwd.cu`` once for the
    pack (one spectra pass over every row, the band stage with each
    trial's taps) and add one to ``fwd_packed.launches`` (with
    ``g.band_map``, to ``fwd_packed.multi_launches``) and, on the FFT
    stage, to ``fwd_packed.fft_launches``."""
    trials = rho.shape[0]
    if x2.device.type == "cpu":
        outs = [_fwd_plain(xk, rk, g) for xk, rk in zip(x2.chunk(trials),
                                                         rho)]
        return torch.cat([o for o, _ in outs]), torch.cat([e for _, e in outs])
    radices = fft_plan.plan(g.n_fft)
    res = launch_fwd(x2, rho.contiguous(), g, radices, trials)
    if g.band_map is None:
        fwd_packed.launches += 1
    else:
        fwd_packed.multi_launches += 1
    if radices is not None:
        fwd_packed.fft_launches += 1
    return res


fwd_packed.launches = 0
fwd_packed.multi_launches = 0
fwd_packed.fft_launches = 0


def specband_drho_packed(xext: torch.Tensor, rho: torch.Tensor,
                         fb: torch.Tensor, dmel: torch.Tensor,
                         logmel: torch.Tensor | None, band_map,
                         trials: int) -> torch.Tensor:
    """K2's wrapper on a pack of ``trials`` trials (rows as
    :func:`fwd_packed`'s, ``rho`` with a leading trial axis): the taps'
    gradients, shaped as ``rho``.  CPU tensors take
    :func:`specband_drho_plain` on each trial; CUDA tensors launch
    ``csrc/specband_bwd.cu`` once for the pack, its partials per (trial,
    block), and add one to ``specband_drho_packed.launches`` (with a
    ``band_map``, to ``specband_drho_packed.multi_launches``)."""
    if xext.device.type == "cpu":
        parts = zip(xext.chunk(trials), rho, dmel.chunk(trials),
                    [None] * trials if logmel is None
                    else logmel.chunk(trials))
        return torch.stack([specband_drho_plain(xe, r, fb, dm, lm, band_map)
                            for xe, r, dm, lm in parts])
    drho = specband_drho(xext, rho, fb, dmel, logmel, band_map, trials)
    if band_map is None:
        specband_drho_packed.launches += 1
    else:
        specband_drho_packed.multi_launches += 1
    return drho


specband_drho_packed.launches = 0
specband_drho_packed.multi_launches = 0


def _dx(x2: torch.Tensor, rho: torch.Tensor, dout: torch.Tensor,
        logmel: torch.Tensor | None, g: _Geom) -> torch.Tensor:
    """The signal's gradient: a vjp through the plain rebuild, outside
    any kernel, as in the JAX package."""
    dmel = dout if logmel is None else dout * torch.exp(-logmel)
    with torch.enable_grad():
        xv = x2.detach().requires_grad_()
        mel = _mel_from_taps_plain(xv, rho.detach(),
                                   g._replace(log_epilogue=False))
        dx, = torch.autograd.grad(mel, xv, dmel)
    return dx


class _SpecbandMel(torch.autograd.Function):
    """``(x2, rho) -> mel`` through K1, with the taps' gradient from K2:
    the counterpart of the JAX package's ``_specband_mel`` custom vjp.
    ``rho`` is ``(2J + 1,)``, or ``(K, 2J + 1)`` with ``g.band_map``.

    The JAX function differentiates ``band_matrix(rho)``, a TPU lane
    layout of the same ``2J + 1`` numbers, so its gradient summed over
    the band diagonals is this one.  The forward keeps K1's spectra
    buffer ``xext`` and, with the log epilogue, its output as the
    residuals.  ``dx`` (only when ``x2`` needs a gradient) is a vjp
    through the plain rebuild, outside any kernel, as there (:func:`_dx`).
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
            fb = _fb(g, xext.device)
            drho = specband_drho(xext, rho.contiguous(), fb, dout, logmel,
                                 g.band_map)
        if ctx.needs_input_grad[0]:
            dx = _dx(x2, rho, dout, logmel, g)
        return dx, drho, None


class _SpecbandMelPacked(torch.autograd.Function):
    """:class:`_SpecbandMel` on a pack of K trials: ``x2`` (K B, T), trial
    k's rows ``k B ..``, ``rho`` with a leading trial axis; one launch of
    K1 (:func:`fwd_packed`) and of K2 (:func:`specband_drho_packed`) for
    the pack.  Returns the mel of all K B rows."""

    @staticmethod
    def forward(ctx, x2, rho, g: _Geom):
        out, xext = fwd_packed(x2, rho, g)
        ctx.g = g
        ctx.save_for_backward(x2, rho, xext, out if g.log_epilogue else None)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, rho, xext, logmel = ctx.saved_tensors
        g = ctx.g
        trials = rho.shape[0]
        dout = dout.contiguous()
        dx = drho = None
        if ctx.needs_input_grad[1]:
            drho = specband_drho_packed(xext, rho.contiguous(),
                                        _fb(g, xext.device), dout, logmel,
                                        g.band_map, trials)
        if ctx.needs_input_grad[0]:
            logs = ([None] * trials if logmel is None
                    else logmel.chunk(trials))
            dx = torch.cat([_dx(xk, rk, dk, lk, g) for xk, rk, dk, lk in zip(
                x2.chunk(trials), rho, dout.chunk(trials), logs)])
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
    ``specband_mel_power.launches``, and to its ``fft_launches`` where
    n_fft takes the FFT stage), on the current stream and without
    synchronising; a failed build or launch raises.  The gradient in
    ``window`` comes from K2 through the taps (:func:`window_taps_sym`
    is differentiable), the gradient in ``x`` from the plain rebuild.

    ``window`` ``(K, n_fft)`` is a pack of K trials: ``x`` (K, ..., T),
    trial k's rows analysed with window k, the result ``(K, ...,
    n_mels, n_frames)``.  CPU tensors take the plain function on each
    trial; CUDA tensors launch K1 and K2 once for the pack
    (:func:`fwd_packed`, :func:`specband_drho_packed`).
    """
    if f_max is None:
        f_max = sample_rate // 2
    _check(x, window, n_fft, hop_length, n_mels, j_taps)
    kw = dict(n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
              sample_rate=sample_rate, f_min=f_min, f_max=f_max,
              j_taps=j_taps, log_epilogue=log_epilogue)
    if x.device.type == "cpu":
        if window.dim() == 2:
            return torch.stack([specband_mel_power_plain(xk, wk, **kw)
                                for xk, wk in zip(x, window)])
        return specband_mel_power_plain(x, window, **kw)
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
        fn = _SpecbandMelPacked if window.dim() == 2 else _SpecbandMel
        out = fn.apply(x2, rho, g)
    return out.reshape(lead + out.shape[-2:])


specband_mel_power.launches = 0
specband_mel_power.fft_launches = 0


def specband_mel_power_multi(x: torch.Tensor, windows: torch.Tensor,
                             band_map, *, n_fft: int, hop_length: int,
                             n_mels: int, sample_rate: int,
                             f_min: float = 0.0, f_max: float | None = None,
                             j_taps: int = SPECGEMM_J_TAPS) -> torch.Tensor:
    """Multi-sigma specband mel power ``(..., n_mels, n_frames)``, no log
    (the JAX package's ``specband_mel_power_multi``): ``windows``
    ``(K, n_fft)``, one symmetric window a sigma group, ``band_map``
    (``n_mels`` ints in ``[0, K)``) the group of each mel band.  All K
    windows share K1's one spectra pass.  At most 8 groups, else
    ``ValueError``.

    CPU tensors take :func:`specband_mel_power_multi_plain`.  CUDA
    tensors launch K1 at ``k_sig = K`` (adding one to
    ``specband_mel_power_multi.launches``, and to its ``fft_launches`` on
    the FFT stage), float32 only, on the current
    stream and without synchronising; the gradient in ``windows`` comes
    from K2 at ``k_sig = K`` through the ``(K, 2J + 1)`` taps.

    ``windows`` ``(P, K, n_fft)`` is a pack of P trials, each with its K
    sigma groups: ``x`` (P, ..., T), the result ``(P, ..., n_mels,
    n_frames)``; CUDA tensors launch K1 and K2 at ``k_sig = K`` once for
    the pack, the trial axis beside the sigma one.
    """
    if f_max is None:
        f_max = sample_rate // 2
    packed = windows.dim() == 3
    bm = _check_multi(x, windows[0] if packed else windows, band_map, n_fft,
                      hop_length, n_mels, j_taps)
    kw = dict(n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
              sample_rate=sample_rate, f_min=f_min, f_max=f_max,
              j_taps=j_taps)
    if x.device.type == "cpu":
        if packed:
            return torch.stack([specband_mel_power_multi_plain(xk, wk, bm,
                                                               **kw)
                                for xk, wk in zip(x, windows)])
        return specband_mel_power_multi_plain(x, windows, bm, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"specband runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.float32 or windows.dtype != torch.float32:
        raise TypeError("specband takes float32 signals and windows")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    g = _Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
              float(f_max), j_taps, False, bm)
    with torch.cuda.device(x.device):
        rho = window_taps_sym(windows, n_fft, j_taps)
        fn = _SpecbandMelPacked if packed else _SpecbandMel
        out = fn.apply(x2, rho, g)
    return out.reshape(lead + out.shape[-2:])


specband_mel_power_multi.launches = 0
specband_mel_power_multi.fft_launches = 0
