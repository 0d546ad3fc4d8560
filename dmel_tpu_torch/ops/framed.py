"""Framed mel power: windowed frames, real DFT, power and mel projection,
with the window's gradient (counterpart of
``dmel_tpu/ops/pallas/framed_dmel.py``).

The JAX package built the frames inside its TPU kernel from lane-aligned
group rows, because Mosaic cannot load from an unaligned HBM offset, and
ran the DFT as bf16 hi/lo operand splits with a ``lowbin_fix`` ladder and
a full-f32 ``hiprec`` variant to hold the 1e-4 gate.  Those are TPU
precision workarounds.  Here one fp32 kernel reads each frame at its own
offset of the signal: the ``framed_small`` / ``framed_hiprec`` /
``lowbin_fix`` distinctions still decide the *route* through the copied
guards (``stft.FRAMED_AUTO_NFFTS``, ``FRAMED_HIPREC_NFFTS``,
``lowbin_fix_needed``), and every one of them runs this same kernel.

Three versions of each half of the function live here:

- plain PyTorch in float32 on any device: :func:`framed_mel_power_plain`
  (the function, differentiable by autograd) and
  :func:`framed_dwindow_plain` (the window's gradient from the Re|Im
  residual, the JAX package's XLA adjoint written in torch);
- hand-written CUDA kernels: K3 (``csrc/framed_fwd.cu``, wrapped by
  :func:`framed_fwd`; an FFT per frame wherever
  :func:`fft_plan.plan` has a plan for n_fft, every framed n_fft but
  896) and K4 (``csrc/framed_bwd.cu``, wrapped by
  :func:`framed_dwindow`; an inverse real FFT per frame at the same
  n_fft (:func:`dwindow_radices`), the direct adjoint DFT at 896).  CUDA
  tensors launch them; CPU tensors take the plain versions;
- :func:`framed_mel_power`, the public function: :class:`WindowedMel`,
  an autograd function, over K3 and K4.

The fused route (:mod:`dmel_tpu_torch.ops.fused`) runs K3's and K4's
kernels through their second entry points (K5 and K6).
"""

from __future__ import annotations

import ctypes
import functools
from math import gcd
from typing import NamedTuple

import numpy as np
import torch

from dmel_tpu_torch.ops import _cuda, fft_plan
from dmel_tpu_torch.ops.fft_plan import table_np as _table_np
from dmel_tpu_torch.ops.mel import melscale_fbanks_np
from dmel_tpu_torch.ops.stft import frame_signal, num_frames

LANE = 128
MEL_PAD = 128
#: largest n_fft of the framed route (the JAX package's guard)
FRAMED_MAX_NFFT = 1024
#: the Re|Im residual's planes are padded to a multiple of this many
#: columns, half the kernels' GEMM tile width
_KP_ALIGN = 64


def supported(n_fft: int, hop_length: int, n_mels: int) -> bool:
    """Static geometry guard, verbatim from the JAX package so that the
    auto dispatch decides alike: n_fft a lane multiple up to 1024, a
    hop that admits a group of at most 16 frames, at most 128 mels."""
    g = LANE // gcd(hop_length, LANE)
    return (n_fft % LANE == 0 and g <= 16 and n_mels <= MEL_PAD
            and n_fft <= FRAMED_MAX_NFFT)


class Geom(NamedTuple):
    """Static geometry of one framed or fused call."""
    n_fft: int
    hop_length: int
    n_mels: int
    sample_rate: int
    f_min: float
    f_max: float


def kp_of(n_fft: int) -> int:
    """Columns of one plane of the Re|Im residual: the ``n_fft // 2 + 1``
    bins padded to a multiple of 64."""
    return -(-(n_fft // 2 + 1) // _KP_ALIGN) * _KP_ALIGN


@functools.lru_cache(maxsize=16)
def _bases_np(n_fft: int):
    """Real-DFT bases ``(n_fft, n_bins)``: ``C[m, k]`` and ``S[m, k]``,
    the table at the exact integer phase ``(m k) mod n_fft``, so that
    the plain version and the kernels use the same float32 numbers."""
    tab = _table_np(n_fft)
    idx = (np.arange(n_fft)[:, None]
           * np.arange(n_fft // 2 + 1)[None, :]) % n_fft
    c, s = tab[0][idx], tab[1][idx]
    c.flags.writeable = False
    s.flags.writeable = False
    return c, s


@functools.lru_cache(maxsize=16)
def _fb_ranges_np(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
                  f_max: float):
    """The dense ``(n_bins, n_mels)`` filterbank and its nonzero ranges:
    ``mel_lo``/``mel_hi`` (n_mels,) each band's bins, ``bin_lo``/``bin_hi``
    (n_bins,) each bin's bands, half-open; empty ranges are ``(0, 0)``.

    A triangular filterbank's nonzeros are contiguous in both
    directions; this is checked."""
    fb = melscale_fbanks_np(n_fft // 2 + 1, f_min, f_max, n_mels,
                            sample_rate)

    def ranges(nz):
        lo = np.zeros(nz.shape[0], np.int32)
        hi = np.zeros(nz.shape[0], np.int32)
        for i, row in enumerate(nz):
            idx = np.flatnonzero(row)
            if idx.size:
                if idx[-1] - idx[0] + 1 != idx.size:
                    raise ValueError("filterbank nonzeros not contiguous")
                lo[i], hi[i] = idx[0], idx[-1] + 1
        return lo, hi

    mel_lo, mel_hi = ranges(fb.T != 0)
    bin_lo, bin_hi = ranges(fb != 0)
    return fb, mel_lo, mel_hi, bin_lo, bin_hi


class _Consts(NamedTuple):
    """The kernels' constant operands on one device."""
    table: torch.Tensor       # (2, n_fft) float32
    fb: torch.Tensor          # (n_bins, n_mels) float32
    fb_t: torch.Tensor        # (n_mels, n_bins) float32, fb transposed
    mel_lo: torch.Tensor      # (n_mels,) int32
    mel_hi: torch.Tensor
    bin_lo: torch.Tensor      # (n_bins,) int32
    bin_hi: torch.Tensor


@functools.lru_cache(maxsize=8)
def _kernel_consts(g: Geom, device: torch.device) -> _Consts:
    fb, mel_lo, mel_hi, bin_lo, bin_hi = _fb_ranges_np(
        g.n_fft, g.n_mels, g.sample_rate, g.f_min, g.f_max)
    return _Consts(*(torch.tensor(a, device=device) for a in
                     (_table_np(g.n_fft), fb, np.ascontiguousarray(fb.T),
                      mel_lo, mel_hi, bin_lo, bin_hi)))


@functools.lru_cache(maxsize=8)
def _bluestein_consts(n_fft: int, m_pad: int, device: torch.device):
    """Bluestein's tables on ``device`` (:class:`fft_plan.Bluestein`):
    the m_pad-point FFT's twiddles by stage and the chirp,
    ``(m_pad + n_fft / 2, 2)`` (:func:`fft_plan.bluestein_table_np`), and
    ``FFT(b) / m_pad``, ``(m_pad, 2)``."""
    return (torch.tensor(fft_plan.bluestein_table_np(n_fft, m_pad),
                         device=device),
            torch.tensor(fft_plan.bluestein_kernel_np(n_fft, m_pad),
                         device=device))


def _stage_args(stage, n_fft: int, device: torch.device):
    """A spectra stage's five C arguments (``csrc/framed_fwd.cu``'s
    convention): the radices as a ctypes int array and their count
    (``(None, -1)`` for the direct DFT), then ``m_pad`` and Bluestein's two
    tables' device pointers (0 and two nulls for a plan or the direct
    stage)."""
    if isinstance(stage, fft_plan.Bluestein):
        table, bhat = _bluestein_consts(n_fft, stage.m_pad, device)
        return (*_cuda.plan_args(stage.radices), stage.m_pad,
                table.data_ptr(), bhat.data_ptr())
    return (*_cuda.plan_args(stage), 0, None, None)


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, device: torch.device):
    c, s = _bases_np(n_fft)
    return torch.tensor(c, device=device), torch.tensor(s, device=device)


@functools.lru_cache(maxsize=8)
def _fb(g: Geom, device: torch.device) -> torch.Tensor:
    return torch.tensor(_fb_ranges_np(g.n_fft, g.n_mels, g.sample_rate,
                                      g.f_min, g.f_max)[0], device=device)


def spectra_plain(x2: torch.Tensor, window: torch.Tensor, g: Geom):
    """``(re, im)``, each ``(B, n_frames, n_bins)``: the real DFT of the
    windowed frames of ``x2`` (B, T), ``window`` (n_fft,)."""
    fw = frame_signal(x2, g.n_fft, g.hop_length) * window
    c, s = _bases(g.n_fft, x2.device)
    return fw @ c, fw @ s


def mel_plain(x2: torch.Tensor, window: torch.Tensor,
              g: Geom) -> torch.Tensor:
    """Plain mel power ``(B, n_mels, n_frames)`` of ``x2`` (B, T) in
    float32: frames, window, real DFT, power, mel.  Differentiable in
    ``x2`` and ``window``; no geometry guard."""
    re, im = spectra_plain(x2, window, g)
    mel = (re * re + im * im) @ _fb(g, x2.device)
    return mel.transpose(1, 2)


def _check(x, window, n_fft, hop_length, n_mels):
    if window.shape[-1] != n_fft:
        raise ValueError("framed kernel requires win_length == n_fft")
    if not supported(n_fft, hop_length, n_mels):
        raise ValueError("unsupported (n_fft, hop, n_mels) for the framed "
                         "kernel; gate with framed.supported")
    if window.device != x.device:
        raise ValueError(f"window on {window.device}, signal on {x.device}")


def framed_mel_power_plain(x: torch.Tensor, window: torch.Tensor, *,
                           n_fft: int, hop_length: int, n_mels: int,
                           sample_rate: int, f_min: float = 0.0,
                           f_max: float | None = None) -> torch.Tensor:
    """Plain PyTorch framed mel power ``(..., n_mels, n_frames)`` in
    float32, differentiable in ``x`` and ``window``; the same guard and
    contract as :func:`framed_mel_power`."""
    if f_max is None:
        f_max = sample_rate // 2
    _check(x, window, n_fft, hop_length, n_mels)
    lead = x.shape[:-1]
    g = Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
             float(f_max))
    mel = mel_plain(x.reshape(-1, x.shape[-1]).to(torch.float32),
                    window.to(torch.float32), g)
    return mel.reshape(lead + mel.shape[-2:])


def fwd_plain(x2: torch.Tensor, window: torch.Tensor, g: Geom):
    """The forward kernel's plain version in its buffer layout: ``(out,
    reim)``, ``out`` (B, n_mels, n_frames) and ``reim`` the ``(B n_frames,
    2 kp)`` residual, Re in columns ``[0, n_bins)``, Im in ``[kp, kp +
    n_bins)``, zero elsewhere, row ``b n_frames + t``."""
    b, t = x2.shape
    rows = b * num_frames(t, g.hop_length)
    n_bins, kp = g.n_fft // 2 + 1, kp_of(g.n_fft)
    re, im = spectra_plain(x2, window, g)
    reim = x2.new_zeros((rows, 2 * kp))
    reim[:, :n_bins] = re.reshape(rows, n_bins)
    reim[:, kp:kp + n_bins] = im.reshape(rows, n_bins)
    mel = (re * re + im * im) @ _fb(g, x2.device)
    return mel.transpose(1, 2).contiguous(), reim


#: the C types of :func:`_stage_args`
_STAGE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def _fwd_lib() -> ctypes.CDLL:
    """The forward library with its C signatures declared: pointers and
    the stream as ``c_void_p`` (ctypes would pass a bare Python int as a
    32-bit int), sizes as ``c_int``."""
    lib = _cuda.load("framed_fwd").cdll
    for entry in (lib.framed_fwd, lib.fused_fwd):
        entry.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                          + _STAGE_ARGTYPES + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
    lib.framed_fwd_error_string.argtypes = [ctypes.c_int]
    lib.framed_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    """The backward library (K4, K6) with its C signatures declared (as
    :func:`_fwd_lib`)."""
    lib = _cuda.load("framed_bwd").cdll
    for entry in (lib.framed_bwd, lib.fused_bwd):
        entry.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                          + _STAGE_ARGTYPES + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
    lib.framed_bwd_partial_blocks.argtypes = [ctypes.c_int] * 4
    lib.framed_bwd_partial_blocks.restype = ctypes.c_int
    lib.framed_bwd_error_string.argtypes = [ctypes.c_int]
    lib.framed_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name: str, device: torch.device, *tensors):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operand on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 operands")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous operands")


def _pack_rows(name: str, x2: torch.Tensor, windows: torch.Tensor,
               n_fft: int) -> tuple[int, int]:
    """``(trials, rows of one trial)`` of a launch: ``windows`` ``(n_fft,)``
    is one trial, ``(K, n_fft)`` a pack of K whose trial k owns rows
    ``k B .. (k + 1) B - 1`` of ``x2`` (K B, T); ``ValueError`` otherwise."""
    trials = 1 if windows.dim() == 1 else windows.shape[0]
    if (x2.dim() != 2 or windows.shape[-1] != n_fft or windows.dim() > 2
            or trials < 1 or x2.shape[0] % trials):
        raise ValueError(f"{name}: x (K B, T) and windows (n_fft,) or (K, "
                         f"{n_fft}), got {tuple(x2.shape)} and "
                         f"{tuple(windows.shape)}")
    return trials, x2.shape[0] // trials


def launch_fwd(entry: str, x2: torch.Tensor, window: torch.Tensor,
               g: Geom, stage=None):
    """Launch the forward kernel's entry point ``entry`` (``"framed_fwd"``
    for K3, ``"fused_fwd"`` for K5) on the current stream, without
    synchronising: ``(out, reim)`` as :func:`fwd_plain` gives them.
    ``window`` ``(K, n_fft)`` launches a pack of K trials in one grid
    (:func:`_pack_rows`): trial k's rows and outputs are those of a launch
    on its rows alone.  ``stage`` is the spectra stage: the FFT of a
    plan's radices (:func:`fft_plan.plan`), a :class:`fft_plan.Bluestein`
    stage (``"fused_fwd"`` only, :func:`fft_plan.fused_stage`) or ``None``
    for the direct DFT.  Checks device, dtype, shape and contiguity; a
    failed build or launch (a stage that is not one of n_fft included)
    raises.  The caller counts the launch."""
    _check_operands(entry, x2.device, x2, window)
    trials, b = _pack_rows(entry, x2, window, g.n_fft)
    t = x2.shape[1]
    nfr = num_frames(t, g.hop_length)
    n_bins, kp = g.n_fft // 2 + 1, kp_of(g.n_fft)
    with torch.cuda.device(x2.device):
        c = _kernel_consts(g, x2.device)
        reim = torch.empty((trials * b * nfr, 2 * kp), dtype=torch.float32,
                           device=x2.device)
        out = torch.empty((trials * b, g.n_mels, nfr), dtype=torch.float32,
                          device=x2.device)
        lib = _fwd_lib()
        args = (x2.data_ptr(), window.data_ptr(), c.table.data_ptr(),
                c.fb.data_ptr(), c.fb_t.data_ptr(), c.mel_lo.data_ptr(),
                c.mel_hi.data_ptr(), reim.data_ptr(), out.data_ptr(), b,
                trials, t, nfr, g.hop_length, g.n_fft, kp, n_bins, g.n_mels)
        rc = getattr(lib, entry)(
            *args, *_stage_args(stage, g.n_fft, x2.device),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.framed_fwd_error_string(rc).decode())
    return out, reim


def framed_fwd(x2: torch.Tensor, window: torch.Tensor, g: Geom):
    """K3's wrapper: ``(out, reim)`` as :func:`fwd_plain` gives them.
    CPU tensors take :func:`fwd_plain`; CUDA tensors launch
    ``csrc/framed_fwd.cu`` (entry ``framed_fwd``) with the spectra stage
    :func:`fft_plan.plan` picks for n_fft, and add one to
    ``framed_mel_power.launches`` and, on the FFT stage, to
    ``framed_mel_power.fft_launches``."""
    if x2.device.type == "cpu":
        return fwd_plain(x2, window, g)
    radices = fft_plan.plan(g.n_fft)
    res = launch_fwd("framed_fwd", x2, window, g, radices)
    framed_mel_power.launches += 1
    if radices is not None:
        framed_mel_power.fft_launches += 1
    return res


def framed_dwindow_plain(x2: torch.Tensor, reim: torch.Tensor,
                         dmel: torch.Tensor, g: Geom) -> torch.Tensor:
    """K4's plain version: the gradient ``(n_fft,)`` in the window of
    the mel power, from the signal ``x2`` (B, T), the forward's Re|Im
    residual ``reim`` (rows, 2 kp) and the cotangent ``dmel`` (B, n_mels,
    n_frames).  The adjoint chain of the JAX package's ``_dmel_bwd``:
    ``dP = g fb^T``, ``dRe = 2 Re dP``, ``dIm = 2 Im dP``, ``dfw = dRe
    C^T + dIm S^T``, ``dw = sum_rows frames dfw``."""
    rows = reim.shape[0]
    n_bins, kp = g.n_fft // 2 + 1, kp_of(g.n_fft)
    fb = _fb(g, reim.device)
    dp = dmel.transpose(1, 2).reshape(rows, g.n_mels) @ fb.T
    dre = 2.0 * reim[:, :n_bins] * dp
    dim = 2.0 * reim[:, kp:kp + n_bins] * dp
    c, s = _bases(g.n_fft, reim.device)
    dfw = dre @ c.T + dim @ s.T                         # (rows, n_fft)
    frames = frame_signal(x2, g.n_fft, g.hop_length)    # (B, nfr, n_fft)
    return (frames * dfw.reshape(frames.shape)).sum((0, 1))


def launch_bwd(entry: str, x2: torch.Tensor, reim: torch.Tensor,
               dmel: torch.Tensor, g: Geom, stage=None,
               trials: int = 1) -> torch.Tensor:
    """Launch the backward kernels' entry point ``entry`` (``"framed_bwd"``
    for K4, ``"fused_bwd"`` for K6) on the current stream, without
    synchronising: the window's gradient ``(n_fft,)`` as
    :func:`framed_dwindow_plain` defines it; with ``trials`` K > 1 the
    rows of ``x2`` are a pack of K trials (as :func:`launch_fwd`'s) and
    the result is ``(K, n_fft)``, trial k's bit for bit a launch's on its
    rows alone.  ``stage`` is the stage that computes dfw, as
    :func:`launch_fwd`'s: the inverse FFT of a plan's radices, a
    :class:`fft_plan.Bluestein` stage (``"fused_bwd"`` only) or ``None``
    for the direct adjoint DFT.  Checks device, dtype, shape and
    contiguity; a failed build or launch (a stage that is not one of n_fft
    included) raises.  The caller counts the launch."""
    _check_operands(entry, x2.device, x2, reim, dmel)
    bk, t = x2.shape
    if trials < 1 or bk % trials:
        raise ValueError(f"{entry}: {bk} rows are no pack of {trials}")
    b = bk // trials
    nfr = num_frames(t, g.hop_length)
    n_bins, kp = g.n_fft // 2 + 1, kp_of(g.n_fft)
    rows = b * nfr
    if (reim.shape != (trials * rows, 2 * kp)
            or dmel.shape != (bk, g.n_mels, nfr)):
        raise ValueError(
            f"{entry}: inconsistent shapes x {tuple(x2.shape)}, "
            f"reim {tuple(reim.shape)}, dmel {tuple(dmel.shape)}")
    with torch.cuda.device(x2.device):
        c = _kernel_consts(g, x2.device)
        lib = _bwd_lib()
        stage_args = _stage_args(stage, g.n_fft, x2.device)
        n_blocks = lib.framed_bwd_partial_blocks(rows, g.n_fft,
                                                 *stage_args[1:3])
        # dRe|dIm scratch: the direct stage's only
        dreim = torch.empty_like(reim) if stage is None else None
        partials = torch.empty((trials, g.n_fft, n_blocks),
                               dtype=torch.float32, device=x2.device)
        dw = torch.empty((trials, g.n_fft) if trials > 1 else (g.n_fft,),
                         dtype=torch.float32, device=x2.device)
        rc = getattr(lib, entry)(
            x2.data_ptr(), reim.data_ptr(), c.table.data_ptr(),
            c.fb.data_ptr(), c.fb_t.data_ptr(), c.bin_lo.data_ptr(),
            c.bin_hi.data_ptr(), dmel.data_ptr(),
            None if dreim is None else dreim.data_ptr(),
            partials.data_ptr(), dw.data_ptr(), b, trials, t, nfr,
            g.hop_length, g.n_fft, kp, n_bins, g.n_mels, *stage_args,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.framed_bwd_error_string(rc).decode())
    return dw


def dwindow_radices(n_fft: int) -> tuple[int, ...] | None:
    """K4's stage at ``n_fft``: the radices of the inverse real FFT
    (:func:`fft_plan.plan`; every framed n_fft but 896 = 2^7 7), or
    ``None`` for the direct adjoint DFT."""
    return fft_plan.plan(n_fft)


def framed_dwindow(x2: torch.Tensor, reim: torch.Tensor, dmel: torch.Tensor,
                   g: Geom) -> torch.Tensor:
    """K4's wrapper: the window's gradient ``(n_fft,)`` as
    :func:`framed_dwindow_plain` defines it.  CPU tensors take
    :func:`framed_dwindow_plain`; CUDA tensors launch
    ``csrc/framed_bwd.cu`` (entry ``framed_bwd``) with the stage
    :func:`dwindow_radices` picks, and add one to
    ``framed_dwindow.launches`` and, on the inverse-FFT stage, to
    ``framed_dwindow.fft_launches``."""
    if x2.device.type == "cpu":
        return framed_dwindow_plain(x2, reim, dmel, g)
    radices = dwindow_radices(g.n_fft)
    dw = launch_bwd("framed_bwd", x2, reim, dmel, g, radices)
    framed_dwindow.launches += 1
    if radices is not None:
        framed_dwindow.fft_launches += 1
    return dw


framed_dwindow.launches = 0
framed_dwindow.fft_launches = 0


def dx_plain(x2: torch.Tensor, window: torch.Tensor, dmel: torch.Tensor,
             g: Geom) -> torch.Tensor:
    """The signal's gradient: a vjp through the plain rebuild, outside
    any kernel (the JAX package's XLA adjoint)."""
    with torch.enable_grad():
        xv = x2.detach().requires_grad_()
        dx, = torch.autograd.grad(mel_plain(xv, window.detach(), g), xv,
                                  dmel)
    return dx


def _trial_rows(t: torch.Tensor, trials: int) -> list[torch.Tensor]:
    """The rows of ``t`` split into ``trials`` equal parts, one a trial."""
    return list(t.chunk(trials)) if trials > 1 else [t]


def _looped_fwd(fwd, x2: torch.Tensor, windows: torch.Tensor, g: Geom):
    """A forward wrapper's plain version on a pack: ``fwd`` on each
    trial's rows and window, the outputs and residuals concatenated."""
    outs = [fwd(xk, wk, g) for xk, wk in zip(_trial_rows(x2, len(windows)),
                                               windows)]
    return torch.cat([o for o, _ in outs]), torch.cat([r for _, r in outs])


def _looped_dwindow(dwindow, x2: torch.Tensor, reim: torch.Tensor,
                    dmel: torch.Tensor, g: Geom,
                    trials: int) -> torch.Tensor:
    """A window gradient's plain version on a pack: ``dwindow`` on each
    trial's rows, stacked to ``(trials, n_fft)``."""
    return torch.stack([dwindow(*parts, g) for parts in zip(
        _trial_rows(x2, trials), _trial_rows(reim, trials),
        _trial_rows(dmel, trials))])


def framed_fwd_packed(x2: torch.Tensor, windows: torch.Tensor, g: Geom):
    """K3's wrapper on a pack of K trials: ``x2`` (K B, T), trial k's rows
    ``k B ..``, ``windows`` (K, n_fft); ``(out, reim)`` as
    :func:`framed_fwd` gives them on each trial's rows, concatenated.
    CPU tensors take :func:`fwd_plain` on each trial; CUDA tensors launch
    ``csrc/framed_fwd.cu`` (entry ``framed_fwd``) once for the pack, and
    add one to ``framed_fwd_packed.launches``."""
    if x2.device.type == "cpu":
        return _looped_fwd(fwd_plain, x2, windows, g)
    res = launch_fwd("framed_fwd", x2, windows, g, fft_plan.plan(g.n_fft))
    framed_fwd_packed.launches += 1
    return res


framed_fwd_packed.launches = 0


def framed_dwindow_packed(x2: torch.Tensor, reim: torch.Tensor,
                          dmel: torch.Tensor, g: Geom,
                          trials: int) -> torch.Tensor:
    """K4's wrapper on a pack of ``trials`` trials (rows as
    :func:`framed_fwd_packed`'s): the windows' gradients ``(trials,
    n_fft)``.  CPU tensors take :func:`framed_dwindow_plain` on each
    trial; CUDA tensors launch ``csrc/framed_bwd.cu`` (entry
    ``framed_bwd``) once for the pack, and add one to
    ``framed_dwindow_packed.launches``."""
    if x2.device.type == "cpu":
        return _looped_dwindow(framed_dwindow_plain, x2, reim, dmel, g,
                               trials)
    dw = launch_bwd("framed_bwd", x2, reim, dmel, g,
                    dwindow_radices(g.n_fft), trials)
    framed_dwindow_packed.launches += 1
    return dw.reshape(trials, g.n_fft)


framed_dwindow_packed.launches = 0


def framed_dwindow_plain_packed(x2: torch.Tensor, reim: torch.Tensor,
                                dmel: torch.Tensor, g: Geom,
                                trials: int) -> torch.Tensor:
    """The torch adjoint :func:`framed_dwindow_plain` on each trial of a
    pack, ``(trials, n_fft)``: the fused route's default backward."""
    return _looped_dwindow(framed_dwindow_plain, x2, reim, dmel, g, trials)


def dx_plain_packed(x2: torch.Tensor, windows: torch.Tensor,
                    dmel: torch.Tensor, g: Geom) -> torch.Tensor:
    """:func:`dx_plain` on each trial of a pack, concatenated."""
    trials = len(windows)
    return torch.cat([dx_plain(xk, wk, dk, g) for xk, wk, dk in zip(
        _trial_rows(x2, trials), windows, _trial_rows(dmel, trials))])


class WindowedMel(torch.autograd.Function):
    """``(x2, window) -> mel`` through the forward wrapper ``fwd``, which
    keeps the Re|Im residual, with the window's gradient from
    ``dwindow(x2, reim, dmel, g)``: K3 and K4 on the framed route (the
    JAX package's ``_framed_mel`` custom vjp), K5 and the torch adjoint
    :func:`framed_dwindow_plain` (or K6 under ``fused.USE_FUSED_BWD``) on
    the fused route (its ``_dmel_from_window``).  ``dx`` is computed only
    when ``x2`` needs a gradient."""

    @staticmethod
    def forward(ctx, x2, window, g: Geom, fwd, dwindow):
        out, reim = fwd(x2, window, g)
        ctx.g, ctx.dwindow = g, dwindow
        ctx.save_for_backward(x2, window, reim)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, window, reim = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = ctx.dwindow(x2, reim, dout, ctx.g)
        if ctx.needs_input_grad[0]:
            dx = dx_plain(x2, window, dout, ctx.g)
        return dx, dw, None, None, None


class WindowedMelPacked(torch.autograd.Function):
    """:class:`WindowedMel` on a pack of K trials: ``x2`` (K B, T), trial
    k's rows ``k B ..``, ``windows`` (K, n_fft); ``fwd`` and ``dwindow``
    are packed wrappers (``framed_fwd_packed``, ``fused_fwd_packed``,
    ...), so the pack takes one launch of each kernel.  Returns the mel
    of all K B rows; the windows' gradient is ``(K, n_fft)``."""

    @staticmethod
    def forward(ctx, x2, windows, g: Geom, fwd, dwindow):
        out, reim = fwd(x2, windows, g)
        ctx.g, ctx.dwindow = g, dwindow
        ctx.save_for_backward(x2, windows, reim)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, windows, reim = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = ctx.dwindow(x2, reim, dout, ctx.g, len(windows))
        if ctx.needs_input_grad[0]:
            dx = dx_plain_packed(x2, windows, dout, ctx.g)
        return dx, dw, None, None, None


def framed_mel_power(x: torch.Tensor, window: torch.Tensor, *, n_fft: int,
                     hop_length: int, n_mels: int, sample_rate: int,
                     f_min: float = 0.0,
                     f_max: float | None = None) -> torch.Tensor:
    """Framed mel power ``(..., n_mels, n_frames)``, no log (the contract
    of the JAX package's ``framed_mel_power``).

    Raises ``ValueError`` where ``win_length != n_fft`` or the geometry
    fails :func:`supported`.  CUDA tensors launch K3 (adding one to
    ``framed_mel_power.launches``, and to ``framed_mel_power.fft_launches``
    where n_fft takes the FFT stage) on the current stream and without
    synchronising, and take the window's gradient from K4; CPU tensors
    run the same autograd function over the plain versions.  Float32
    only on CUDA (``TypeError`` otherwise).

    ``window`` ``(K, n_fft)`` is a pack of K trials: ``x`` (K, ..., T),
    trial k's rows analysed with window k, the result ``(K, ...,
    n_mels, n_frames)``; CUDA tensors launch K3 and K4 once for the pack
    (:func:`framed_fwd_packed`, :func:`framed_dwindow_packed`).
    """
    if f_max is None:
        f_max = sample_rate // 2
    _check(x, window, n_fft, hop_length, n_mels)
    if x.device.type == "cuda" and (x.dtype != torch.float32
                                    or window.dtype != torch.float32):
        raise TypeError("the framed kernel takes float32 signals and "
                        "windows")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    g = Geom(n_fft, hop_length, n_mels, sample_rate, float(f_min),
             float(f_max))
    window = window.to(torch.float32).contiguous()
    if window.dim() == 2:
        out = WindowedMelPacked.apply(x2, window, g, framed_fwd_packed,
                                      framed_dwindow_packed)
    else:
        out = WindowedMel.apply(x2, window, g, framed_fwd, framed_dwindow)
    return out.reshape(lead + out.shape[-2:])


framed_mel_power.launches = 0
framed_mel_power.fft_launches = 0
