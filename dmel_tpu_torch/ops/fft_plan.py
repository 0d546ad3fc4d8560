"""The spectra stage of the kernels K1 (``csrc/specband_fwd.cu``), K3
and K5 (``csrc/framed_fwd.cu``) and K6 (``csrc/framed_bwd.cu``), decided
on the host.

Each takes the real DFT of each frame (K6 its adjoint) with an FFT in
shared memory (``csrc/frame_fft.cuh``) or with the direct-DFT GEMM the
port began with, and the wrapper passes the stage to the kernel.
:func:`plan` gives the radices of the complex FFT of length ``n_fft / 2``
in stage order, or ``None``: every even ``n_fft`` up to 4096 whose half
has no prime factor above 5 (every power of two, and e.g. 384 or 3000)
has a plan.  K1, K3 and K4 read :func:`plan` and take the direct stage
where it has none (896 = 2^7 7).  K5 and K6 read :func:`fused_stage`:
the plan where there is one, else a :class:`Bluestein` stage (faithful
mode's 1400 = 2^3 5^2 7, and every other even ``n_fft`` up to 4096), the
chirp-z transform through a power-of-two FFT of ``m_pad`` points.

Beside the plan live the pieces of the FFT stage that the CPU tests
check, since the CUDA code cannot run there:

- :func:`rfft_mirror`, the forward kernels' arithmetic step by step in
  PyTorch (Stockham stages, or Bluestein's, then the real-FFT
  post-pass), at the same float32 table entries and integer phases;
- :func:`irfft_adjoint_mirror`, K6's: the adjoint of the real DFT as an
  inverse real FFT (the inverse post-pass, then the same stages on
  conjugated data);
- :func:`bluestein_kernel_np`, Bluestein's convolution kernel in the
  frequency domain, and :func:`bluestein_table_np`, its twiddles and
  chirp laid out for the card: the tables K5 and K6 read;
- :func:`ext_bin_map`, K1's map from its extended bins ``-J .. n_bins -
  1 + J`` to FFT bins, with the sign of each plane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

#: largest n_fft the FFT stage takes (both kernels' cap)
MAX_N_FFT = 4096
#: most stages of one plan (``FFT_MAX_STAGES`` in ``frame_fft.cuh``)
MAX_STAGES = 12


@functools.lru_cache(maxsize=16)
def table_np(n_fft: int) -> np.ndarray:
    """``(2, n_fft)``: ``cos`` and ``-sin`` of ``2 pi i / n_fft``, built
    in float64 and rounded once to float32: the kernels' table, for the
    direct DFT's bases and the FFT's twiddles alike."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tab = np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)
    tab.flags.writeable = False
    return tab


@functools.lru_cache(maxsize=64)
def plan(n_fft: int) -> tuple[int, ...] | None:
    """The radices of the FFT stage at ``n_fft``, in stage order: radix
    4 as long as it divides ``n_fft / 2``, then one radix 2, then 3s,
    then 5s.  ``None`` (the direct-DFT stage) where ``n_fft`` is odd,
    outside ``[2, 4096]``, or ``n_fft / 2`` has a prime factor above 5."""
    if n_fft < 2 or n_fft % 2 or n_fft > MAX_N_FFT:
        return None
    m = n_fft // 2
    radices = []
    for r in (4, 2, 3, 5):
        while m % r == 0:
            radices.append(r)
            m //= r
            if r == 2:
                break
    return tuple(radices) if m == 1 else None


def stage_name(n_fft: int) -> str:
    """``"fft"`` or ``"direct"``: the stage K1, K3 and K4 run at
    ``n_fft``."""
    return "direct" if plan(n_fft) is None else "fft"


class Bluestein(NamedTuple):
    """K5's and K6's spectra stage at an n_fft that :func:`plan` has no
    plan for: the complex DFT of length ``m = n_fft / 2`` as a circular
    convolution of length ``m_pad``, the smallest power of two ``>= 2 m -
    1``, through the Stockham stages of ``radices`` (radix 4, then at most one
    radix 2, as :func:`plan` orders them)."""
    m_pad: int
    radices: tuple[int, ...]


def _pow2_radices(m: int) -> tuple[int, ...]:
    """:func:`plan`'s radices for a power of two ``m`` (4s, then at most
    one 2), without its cap on n_fft: ``m`` may be 4096."""
    fours, two = divmod(m.bit_length() - 1, 2)
    return (4,) * fours + (2,) * two


@functools.lru_cache(maxsize=64)
def fused_stage(n_fft: int) -> tuple[int, ...] | Bluestein | None:
    """The spectra stage of K5 and K6 at ``n_fft``: :func:`plan`'s
    radices where it has them, else a :class:`Bluestein` stage, at every
    even ``n_fft`` in ``[2, 4096]``; ``None`` outside them."""
    radices = plan(n_fft)
    if radices is not None or n_fft < 2 or n_fft % 2 or n_fft > MAX_N_FFT:
        return radices
    m_pad = 1 << (n_fft - 2).bit_length()
    return Bluestein(m_pad, _pow2_radices(m_pad))


def fused_stage_name(n_fft: int) -> str:
    """``"fft"``, ``"bluestein"`` or ``"direct"``: the stage K5 and K6
    run at ``n_fft`` (:func:`fused_stage`)."""
    stage = fused_stage(n_fft)
    if stage is None:
        return "direct"
    return "bluestein" if isinstance(stage, Bluestein) else "fft"


def chirp_index(n_fft: int) -> np.ndarray:
    """``(n_fft / 2,)`` int64: ``n^2 mod n_fft``, the table entry of the
    chirp ``c[n] = exp(-i pi n^2 / m) = W_N^(n^2)``."""
    n = np.arange(n_fft // 2, dtype=np.int64)
    return n * n % n_fft


@functools.lru_cache(maxsize=16)
def bluestein_kernel_np(n_fft: int, m_pad: int) -> np.ndarray:
    """``(m_pad, 2)`` float32, (re, im) pairs: ``FFT(b) / m_pad`` of the
    conjugate chirp ``b[n] = conj c[n]`` for ``|n| < m``, wrapped mod
    ``m_pad`` (at least ``2 m - 1``) and zero elsewhere, built in float64
    from the same integer phases and rounded once (``1 / m_pad`` is a
    power of two, so the inverse FFT's scale costs no rounding)."""
    m = n_fft // 2
    if m_pad < 2 * m - 1:
        raise ValueError(f"m_pad {m_pad} < 2 m - 1 = {2 * m - 1}")
    conj_c = np.exp(2j * np.pi * chirp_index(n_fft) / n_fft)
    b = np.zeros(m_pad, np.complex128)
    b[:m] = conj_c
    b[m_pad - m + 1:] = conj_c[1:][::-1]
    bhat = np.fft.fft(b) / m_pad
    out = np.stack([bhat.real, bhat.imag], -1).astype(np.float32)
    out.flags.writeable = False
    return out


def bluestein_stage_twiddles(m_pad: int) -> list[tuple[int, int, int]]:
    """``(l, radix, first row)`` of each stage of the ``m_pad``-point FFT
    past the first (the first stage's twiddles are all exactly 1): ``l``
    the product of the radices before it (:func:`_pow2_radices`), its
    entries ``(r, k)``, ``1 <= r < radix``, ``k < l``, at rows ``first +
    (r - 1) l + k`` of :func:`bluestein_table_np` (``first = l - 4``)."""
    out, ell = [], 1
    for r in _pow2_radices(m_pad):
        if ell > 1:
            out.append((ell, r, ell - 4))
        ell *= r
    return out


@functools.lru_cache(maxsize=16)
def bluestein_table_np(n_fft: int, m_pad: int) -> np.ndarray:
    """``(m_pad + n_fft / 2, 2)`` float32, (cos, -sin) pairs: the table
    K5's and K6's Bluestein stage reads (``frame_fft.cuh:bl_tw``), each
    entry one of :func:`table_np`'s, laid out for the card.  Rows ``[0,
    m_pad - 4)`` hold the m_pad-point FFT's twiddles by stage
    (:func:`bluestein_stage_twiddles`): ``W_{lR}^{rk}``, entry ``r k 2
    m_pad / (l R)`` of ``table_np(2 m_pad)``, so that the threads of a
    warp read neighbouring rows; rows ``[m_pad - 4, m_pad)`` are zero;
    rows ``m_pad + n``, ``n < n_fft / 2``, hold the chirp ``c[n]``,
    entry ``n^2 mod n_fft`` of ``table_np(n_fft)`` (:func:`chirp_index`),
    in natural order."""
    m = n_fft // 2
    if m_pad < 16 or m_pad & (m_pad - 1) or m_pad < 2 * m - 1:
        raise ValueError(f"m_pad {m_pad} is no Bluestein length of {n_fft}")
    big = table_np(2 * m_pad)
    out = np.zeros((m_pad + m, 2), np.float32)
    for ell, radix, first in bluestein_stage_twiddles(m_pad):
        r, k = np.meshgrid(np.arange(1, radix), np.arange(ell), indexing="ij")
        idx = r * k * (2 * m_pad // (ell * radix))
        out[first + (r - 1) * ell + k] = big[:, idx].transpose(1, 2, 0)
    out[m_pad:] = table_np(n_fft)[:, chirp_index(n_fft)].T
    out.flags.writeable = False
    return out


def _cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def _butterfly(r: int, a: list, w: list):
    """The radix-``r`` DFT of ``a`` (``r`` pairs ``(re, im)``), as the
    kernel computes it; ``w[q]`` is the table entry ``W_r^q``."""
    if r == 2:
        (a0r, a0i), (a1r, a1i) = a
        return [(a0r + a1r, a0i + a1i), (a0r - a1r, a0i - a1i)]
    if r == 4:
        (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i) = a
        t0r, t0i = a0r + a2r, a0i + a2i
        t1r, t1i = a0r - a2r, a0i - a2i
        t2r, t2i = a1r + a3r, a1i + a3i
        t3r, t3i = a1r - a3r, a1i - a3i
        return [(t0r + t2r, t0i + t2i), (t1r + t3i, t1i - t3r),
                (t0r - t2r, t0i - t2i), (t1r - t3i, t1i + t3r)]
    if r == 3:
        (a0r, a0i), (a1r, a1i), (a2r, a2i) = a
        c, s = w[1]
        sr, si = a1r + a2r, a1i + a2i
        dr, di = a1r - a2r, a1i - a2i
        mr, mi = a0r + c * sr, a0i + c * si
        return [(a0r + sr, a0i + si), (mr - s * di, mi + s * dr),
                (mr + s * di, mi - s * dr)]
    # r == 5
    (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i), (a4r, a4i) = a
    (c1, s1), (c2, s2) = w[1], w[2]
    p1r, p1i = a1r + a4r, a1i + a4i
    d1r, d1i = a1r - a4r, a1i - a4i
    p2r, p2i = a2r + a3r, a2i + a3i
    d2r, d2i = a2r - a3r, a2i - a3i
    m1r, m1i = a0r + c1 * p1r + c2 * p2r, a0i + c1 * p1i + c2 * p2i
    m2r, m2i = a0r + c2 * p1r + c1 * p2r, a0i + c2 * p1i + c1 * p2i
    n1r, n1i = s1 * d1r + s2 * d2r, s1 * d1i + s2 * d2i
    n2r, n2i = s2 * d1r - s1 * d2r, s2 * d1i - s1 * d2i
    return [(a0r + p1r + p2r, a0i + p1i + p2i), (m1r - n1i, m1i + n1r),
            (m2r - n2i, m2i + n2r), (m2r + n2i, m2i - n2r),
            (m1r + n1i, m1i - n1r)]


def _stockham(zr, zi, radices: tuple[int, ...], tc, ts):
    """The complex FFT of length ``m`` (``zr``, ``zi``: rows, m) as the
    kernels' Stockham stages compute it (``frame_fft.cuh:fft_frames``);
    ``tc``, ``ts`` the ``(n,)`` cos / -sin table of ``n = 2 m``.  Each
    stage of radix ``R``, after stages whose radices multiply to ``L``,
    takes butterfly ``i < m / R`` with ``k = i mod L``: inputs ``z[i + r
    m / R]`` times the twiddle ``table[r k n / (L R)]``, a radix-``R``
    DFT, outputs to ``(i - k) R + k + q L``."""
    m = zr.shape[1]
    n = 2 * m
    ell = 1
    for r in radices:
        stride, ls = m // r, ell * r
        i = torch.arange(stride)
        k = i % ell
        w = [(tc[q * n // r], ts[q * n // r]) for q in range(r)]
        a = []
        for q in range(r):
            t = q * k * (n // ls)
            a.append(_cmul(zr[:, i + q * stride], zi[:, i + q * stride],
                           tc[t], ts[t]))
        b = _butterfly(r, a, w)
        yr, yi = torch.empty_like(zr), torch.empty_like(zi)
        base = (i - k) * r + k
        for q in range(r):
            yr[:, base + q * ell], yi[:, base + q * ell] = b[q]
        zr, zi, ell = yr, yi, ls
    return zr, zi


def _bluestein(zr, zi, stage: Bluestein, tc, ts):
    """The complex DFT of length ``m`` (``zr``, ``zi``: rows, m) as the
    kernels' Bluestein stage computes it (``frame_fft.cuh:bluestein``),
    ``tc``, ``ts`` the table of ``n = 2 m``: ``a = z c`` zero-padded to
    ``M = stage.m_pad``, its FFT by the Stockham stages at the table of
    ``2 M``, times ``FFT(b) / M`` (:func:`bluestein_kernel_np`) and
    conjugated, the same stages again, and bin ``k < m`` is ``c[k]``
    times the conjugate of that output."""
    m = zr.shape[1]
    n_fft = 2 * m
    idx = torch.from_numpy(chirp_index(n_fft))
    cr, ci = tc[idx], ts[idx]
    ar, ai = (F.pad(v, (0, stage.m_pad - m)) for v in _cmul(zr, zi, cr, ci))
    tc2, ts2 = torch.tensor(table_np(2 * stage.m_pad))
    ar, ai = _stockham(ar, ai, stage.radices, tc2, ts2)
    bh = torch.tensor(bluestein_kernel_np(n_fft, stage.m_pad))
    pr, pi = _cmul(ar, ai, bh[:, 0], bh[:, 1])
    qr, qi = _stockham(pr, -pi, stage.radices, tc2, ts2)
    return _cmul(qr[:, :m], -qi[:, :m], cr, ci)


def _complex_dft(zr, zi, stage, tc, ts):
    """The complex DFT of length ``m`` through ``stage``: a plan's
    radices (:func:`_stockham`), or a :class:`Bluestein` stage; ``None``
    takes :func:`fused_stage`'s."""
    if stage is None:
        stage = fused_stage(2 * zr.shape[1])
    if isinstance(stage, Bluestein):
        return _bluestein(zr, zi, stage, tc, ts)
    return _stockham(zr, zi, stage, tc, ts)


def rfft_mirror(frames: torch.Tensor, radices, table: torch.Tensor):
    """``(re, im)``, each ``(rows, n_fft / 2 + 1)``: the real DFT of the
    float32 ``frames`` (rows, n_fft) as the FFT stage computes it, with
    ``table`` the ``(2, n_fft)`` cos / -sin table (:func:`table_np`).

    The frame's samples, read in pairs, are ``m = n_fft / 2`` complex
    values ``z[n] = x[2n] + i x[2n+1]``, transformed by the Stockham
    stages of the plan ``radices`` (:func:`_stockham`), or by Bluestein's
    stage where ``radices`` is a :class:`Bluestein` or ``None``
    (:func:`fused_stage`'s).  The post-pass gives bin ``k <= m``:
    ``X[k] = E + W^k O`` with ``E = (Z[k] + conj Z[m-k]) / 2``, ``O =
    (Z[k] - conj Z[m-k]) / 2i`` and ``Z[m] = Z[0]``."""
    rows, n = frames.shape
    m = n // 2
    tc, ts = table[0], table[1]
    z = frames.reshape(rows, m, 2)
    zr, zi = _complex_dft(z[..., 0], z[..., 1], radices, tc, ts)
    k = torch.arange(m + 1)
    kk = torch.where(k == m, 0, k)
    km = torch.where(k == 0, 0, m - k)
    er, ei = 0.5 * (zr[:, kk] + zr[:, km]), 0.5 * (zi[:, kk] - zi[:, km])
    orr, oi = 0.5 * (zi[:, kk] + zi[:, km]), -0.5 * (zr[:, kk] - zr[:, km])
    wr, wi = tc[k], ts[k]
    return er + (wr * orr - wi * oi), ei + (wr * oi + wi * orr)


def irfft_adjoint_mirror(dreim, radices, n_fft: int) -> torch.Tensor:
    """``dfw`` (rows, n_fft): the adjoint of the real DFT applied to
    ``dreim = (dre, dim)``, each float32 ``(rows, n_fft / 2 + 1)``, as
    K6's FFT stage computes it::

        dfw[r, m] = sum_k dre[r, k] cos(2 pi m k / N)
                        - dim[r, k] sin(2 pi m k / N)

    That sum is ``N irfft(Y)`` with ``Y[k] = (dre + i dim)[k] / 2`` for
    ``0 < k < N/2`` and ``Y[0] = dre[0]``, ``Y[N/2] = dre[N/2]`` (the
    imaginary parts of those two drop out).  The kernel keeps ``Y`` in
    ``m = N/2`` complex slots, ``(Y[0], Y[m])`` sharing slot 0, and runs
    the inverse of :func:`rfft_mirror`'s post-pass::

        Z[k] = A + i W^-k B,  A = Y[k] + conj Y[m-k],  B = Y[k] - conj Y[m-k]

    then the complex inverse DFT of length ``m`` as the forward stages on
    ``conj Z`` (``conj FFT(conj Z)`` is the FFT with conjugate twiddles,
    to the bit): the plan ``radices``' Stockham stages, or Bluestein's
    where ``radices`` is a :class:`Bluestein` or ``None``;
    ``dfw[2n] + i dfw[2n+1]`` is its ``n``-th output.  Every twiddle is
    an entry of the float32 table (:func:`table_np`) at an integer
    phase."""
    dre, dim = dreim
    m = n_fft // 2
    tc, ts = torch.tensor(table_np(n_fft))
    k = torch.arange(m)
    first = k == 0
    # Y[k] and conj Y[m - k]; slot 0 holds the real Y[0] and Y[m]
    yr = torch.where(first, dre[:, :1], 0.5 * dre[:, :m])
    yi = torch.where(first, 0.0, 0.5 * dim[:, :m])
    km = torch.where(first, 0, m - k)
    cr = torch.where(first, dre[:, m:m + 1], yr[:, km])
    ci = torch.where(first, 0.0, -yi[:, km])
    ar, ai = yr + cr, yi + ci
    br, bi = yr - cr, yi - ci
    wr, wi = tc[k], ts[k]                   # W^k; W^-k = (wr, -wi)
    zr = ar - (wr * bi - wi * br)
    zi = ai + (wr * br + wi * bi)
    outr, outi = _complex_dft(zr, -zi, radices, tc, ts)
    return torch.stack([outr, -outi], -1).reshape(dre.shape[0], n_fft)


@functools.lru_cache(maxsize=16)
def ext_bin_map(n_fft: int, j_taps: int, kp: int):
    """K1's extended bins as FFT bins: ``(bins, signs)`` with ``bins``
    (kp,) int32 and ``signs`` (2, kp) float32.

    Column ``j`` holds extended bin ``k = j - J`` of the phase-flipped
    spectrum ``(-1)^k Y[k]`` of an unwindowed frame, ``Y = rfft``: bin
    ``k`` for ``0 <= k <= n_fft/2``, ``conj Y[-k]`` for ``k < 0`` and
    ``conj Y[n_fft - k]`` above.  So the cos plane is ``signs[0, j] Re
    Y[bins[j]]`` and the sin plane ``signs[1, j] Im Y[bins[j]]``;
    ``bins`` is -1 and both signs 0 at the zero columns ``j >=
    n_bins + 2J``."""
    n_bins = n_fft // 2 + 1
    k = np.arange(kp) - j_taps
    valid = k < n_bins + j_taps
    conj = (k < 0) | (k > n_fft // 2)
    bins = np.where(k < 0, -k, np.where(k > n_fft // 2, n_fft - k, k))
    flip = np.where(k % 2 == 0, 1.0, -1.0)
    signs = np.stack([np.where(valid, flip, 0.0),
                      np.where(valid, np.where(conj, -flip, flip), 0.0)])
    bins = np.where(valid, bins, -1).astype(np.int32)
    signs = signs.astype(np.float32)
    bins.flags.writeable = False
    signs.flags.writeable = False
    return bins, signs
