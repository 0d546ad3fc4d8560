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
  :func:`framed_fwd`) and K4 (``csrc/framed_bwd.cu``, wrapped by
  :func:`framed_dwindow`).  CUDA tensors launch them; CPU tensors take
  the plain versions;
- :func:`framed_mel_power`, the public function: :class:`WindowedMel`,
  an autograd function, over K3 and K4.

The fused route (:mod:`dmel_tpu_torch.ops.fused`) runs K3's kernel
through its second entry point.
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
def _table_np(n_fft: int) -> np.ndarray:
    """``(2, n_fft)``: ``cos`` and ``-sin`` of ``2 pi i / n_fft``, built
    in float64 and rounded once to float32."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tab = np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)
    tab.flags.writeable = False
    return tab


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
    mel_lo: torch.Tensor      # (n_mels,) int32
    mel_hi: torch.Tensor
    bin_lo: torch.Tensor      # (n_bins,) int32
    bin_hi: torch.Tensor


@functools.lru_cache(maxsize=8)
def _kernel_consts(g: Geom, device: torch.device) -> _Consts:
    fb, mel_lo, mel_hi, bin_lo, bin_hi = _fb_ranges_np(
        g.n_fft, g.n_mels, g.sample_rate, g.f_min, g.f_max)
    return _Consts(*(torch.tensor(a, device=device) for a in
                     (_table_np(g.n_fft), fb, mel_lo, mel_hi, bin_lo,
                      bin_hi)))


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


def _fwd_lib() -> ctypes.CDLL:
    """The forward library with its C signatures declared: pointers and
    the stream as ``c_void_p`` (ctypes would pass a bare Python int as a
    32-bit int), sizes as ``c_int``."""
    lib = _cuda.load("framed_fwd").cdll
    for entry in (lib.framed_fwd, lib.fused_fwd):
        entry.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
    lib.framed_fwd_error_string.argtypes = [ctypes.c_int]
    lib.framed_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    """K4's library with its C signatures declared (as :func:`_fwd_lib`)."""
    lib = _cuda.load("framed_bwd").cdll
    lib.framed_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                               + [ctypes.c_void_p])
    lib.framed_bwd.restype = ctypes.c_int
    lib.framed_bwd_rows_per_block.argtypes = []
    lib.framed_bwd_rows_per_block.restype = ctypes.c_int
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


def launch_fwd(entry: str, x2: torch.Tensor, window: torch.Tensor,
               g: Geom):
    """Launch the forward kernel's entry point ``entry`` (``"framed_fwd"``
    for K3, ``"fused_fwd"`` for K5) on the current stream, without
    synchronising: ``(out, reim)`` as :func:`fwd_plain` gives them.
    Checks device, dtype, shape and contiguity; a failed build or launch
    raises.  The caller counts the launch."""
    _check_operands(entry, x2.device, x2, window)
    if x2.dim() != 2 or window.shape != (g.n_fft,):
        raise ValueError(f"{entry}: x (B, T) and window ({g.n_fft},), got "
                         f"{tuple(x2.shape)} and {tuple(window.shape)}")
    b, t = x2.shape
    nfr = num_frames(t, g.hop_length)
    n_bins, kp = g.n_fft // 2 + 1, kp_of(g.n_fft)
    with torch.cuda.device(x2.device):
        c = _kernel_consts(g, x2.device)
        reim = torch.empty((b * nfr, 2 * kp), dtype=torch.float32,
                           device=x2.device)
        out = torch.empty((b, g.n_mels, nfr), dtype=torch.float32,
                          device=x2.device)
        lib = _fwd_lib()
        rc = getattr(lib, entry)(
            x2.data_ptr(), window.data_ptr(), c.table.data_ptr(),
            c.fb.data_ptr(), c.mel_lo.data_ptr(), c.mel_hi.data_ptr(),
            reim.data_ptr(), out.data_ptr(), b, t, nfr, g.hop_length,
            g.n_fft, kp, n_bins, g.n_mels,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.framed_fwd_error_string(rc).decode())
    return out, reim


def framed_fwd(x2: torch.Tensor, window: torch.Tensor, g: Geom):
    """K3's wrapper: ``(out, reim)`` as :func:`fwd_plain` gives them.
    CPU tensors take :func:`fwd_plain`; CUDA tensors launch
    ``csrc/framed_fwd.cu`` (entry ``framed_fwd``) and add one to
    ``framed_mel_power.launches``."""
    if x2.device.type == "cpu":
        return fwd_plain(x2, window, g)
    res = launch_fwd("framed_fwd", x2, window, g)
    framed_mel_power.launches += 1
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


def framed_dwindow(x2: torch.Tensor, reim: torch.Tensor, dmel: torch.Tensor,
                   g: Geom) -> torch.Tensor:
    """K4's wrapper: the window's gradient ``(n_fft,)`` as
    :func:`framed_dwindow_plain` defines it.

    CPU tensors take :func:`framed_dwindow_plain`.  CUDA tensors launch
    ``csrc/framed_bwd.cu`` on the current stream, without synchronising,
    after checking device, dtype, shape and contiguity; a failed build or
    launch raises.  Each launch adds one to ``framed_dwindow.launches``.
    """
    if x2.device.type == "cpu":
        return framed_dwindow_plain(x2, reim, dmel, g)
    _check_operands("framed_dwindow", x2.device, x2, reim, dmel)
    b, t = x2.shape
    nfr = num_frames(t, g.hop_length)
    n_bins, kp = g.n_fft // 2 + 1, kp_of(g.n_fft)
    rows = b * nfr
    if (reim.shape != (rows, 2 * kp)
            or dmel.shape != (b, g.n_mels, nfr)):
        raise ValueError(
            f"framed_dwindow: inconsistent shapes x {tuple(x2.shape)}, "
            f"reim {tuple(reim.shape)}, dmel {tuple(dmel.shape)}")
    with torch.cuda.device(x2.device):
        c = _kernel_consts(g, x2.device)
        lib = _bwd_lib()
        n_blocks = -(-rows // lib.framed_bwd_rows_per_block())
        dreim = torch.empty_like(reim)
        partials = torch.empty((g.n_fft, n_blocks), dtype=torch.float32,
                               device=x2.device)
        dw = torch.empty(g.n_fft, dtype=torch.float32, device=x2.device)
        rc = lib.framed_bwd(
            x2.data_ptr(), reim.data_ptr(), c.table.data_ptr(),
            c.fb.data_ptr(), c.bin_lo.data_ptr(), c.bin_hi.data_ptr(),
            dmel.data_ptr(), dreim.data_ptr(), partials.data_ptr(),
            dw.data_ptr(), b, t, nfr, g.hop_length, g.n_fft, kp, n_bins,
            g.n_mels, torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("framed_bwd launch failed: "
                           + lib.framed_bwd_error_string(rc).decode())
    framed_dwindow.launches += 1
    return dw


framed_dwindow.launches = 0


def dx_plain(x2: torch.Tensor, window: torch.Tensor, dmel: torch.Tensor,
             g: Geom) -> torch.Tensor:
    """The signal's gradient: a vjp through the plain rebuild, outside
    any kernel (the JAX package's XLA adjoint)."""
    with torch.enable_grad():
        xv = x2.detach().requires_grad_()
        dx, = torch.autograd.grad(mel_plain(xv, window.detach(), g), xv,
                                  dmel)
    return dx


class WindowedMel(torch.autograd.Function):
    """``(x2, window) -> mel`` through the forward wrapper ``fwd``, which
    keeps the Re|Im residual, with the window's gradient from
    ``dwindow(x2, reim, dmel, g)``: K3 and K4 on the framed route (the
    JAX package's ``_framed_mel`` custom vjp), K5 and the torch adjoint
    :func:`framed_dwindow_plain` on the fused route (its
    ``_dmel_from_window``).  ``dx`` is computed only when ``x2`` needs a
    gradient."""

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


def framed_mel_power(x: torch.Tensor, window: torch.Tensor, *, n_fft: int,
                     hop_length: int, n_mels: int, sample_rate: int,
                     f_min: float = 0.0,
                     f_max: float | None = None) -> torch.Tensor:
    """Framed mel power ``(..., n_mels, n_frames)``, no log (the contract
    of the JAX package's ``framed_mel_power``).

    Raises ``ValueError`` where ``win_length != n_fft`` or the geometry
    fails :func:`supported`.  CUDA tensors launch K3 (adding one to
    ``framed_mel_power.launches``) on the current stream and without
    synchronising, and take the window's gradient from K4; CPU tensors
    run the same autograd function over the plain versions.  Float32
    only on CUDA (``TypeError`` otherwise).
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
    out = WindowedMel.apply(x2, window.to(torch.float32).contiguous(), g,
                            framed_fwd, framed_dwindow)
    return out.reshape(lead + out.shape[-2:])


framed_mel_power.launches = 0
