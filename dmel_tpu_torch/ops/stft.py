"""Centred STFT power and the specband dispatch guards (counterpart of
``dmel_tpu/ops/stft.py``).

The exact route is ``torch.stft`` with ``center=True`` and constant
padding, the semantics the JAX package re-implements.  It plays the
part XLA's FFT plays there: the exact path outside any kernel.

The guards and constants below decide, on the host, whether a static
lambda hint may take the specband kernel and with how many taps.  They
are copied verbatim from the JAX package so that both packages
dispatch alike; their measured justifications live there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def num_frames(signal_length: int, hop_length: int) -> int:
    """Frame count of a centred STFT with even n_fft:
    ``1 + signal_length // hop_length``."""
    return 1 + signal_length // hop_length


def frame_signal(x: torch.Tensor, n_fft: int,
                 hop_length: int) -> torch.Tensor:
    """Slice ``x`` (..., T), zero-padded by ``n_fft // 2`` on both
    sides, into overlapping frames (..., n_frames, n_fft)."""
    t = x.shape[-1]
    pad = n_fft // 2
    n = num_frames(t, hop_length)
    need = (n - 1) * hop_length + n_fft
    x = F.pad(x, (pad, max(0, need - pad - t)))
    return x.unfold(-1, n_fft, hop_length)[..., :n, :]


def stft_power(x: torch.Tensor, window: torch.Tensor, n_fft: int,
               hop_length: int) -> torch.Tensor:
    """``|STFT|^2`` of ``x`` (..., T): ``(..., n_fft//2 + 1, n_frames)``.

    ``window`` has ``win_length <= n_fft`` samples and is centre-padded
    to ``n_fft``, as ``torch.stft`` does.
    """
    lead = x.shape[:-1]
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft=n_fft,
                      hop_length=hop_length, win_length=window.shape[-1],
                      window=window, center=True, pad_mode="constant",
                      normalized=False, onesided=True, return_complex=True)
    power = torch.view_as_real(spec).square().sum(-1)
    return power.reshape(lead + power.shape[-2:])


def stft_power_packed(x: torch.Tensor, windows: torch.Tensor, n_fft: int,
                      hop_length: int) -> torch.Tensor:
    """:func:`stft_power` of a pack of K trials, each with its own
    window: ``x`` (K, ..., T) and ``windows`` (K, win_length) give ``(K,
    ..., n_fft//2 + 1, n_frames)``.

    ``torch.stft`` takes one window, so this frames ``x``
    (:func:`frame_signal`), multiplies each trial's frames by its window
    centre-padded to ``n_fft`` and takes ``torch.fft.rfft``: the steps
    ``torch.stft`` takes, and on the CPU its result bit for bit.
    """
    win = windows.shape[-1]
    left = (n_fft - win) // 2
    w = F.pad(windows, (left, n_fft - win - left))
    w = w.reshape(w.shape[:1] + (1,) * (x.dim() - 1) + w.shape[1:])
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop_length) * w, dim=-1)
    return torch.view_as_real(spec).square().sum(-1).transpose(-1, -2)


# --- host-side dispatch guards, verbatim from the JAX package ---------

#: default half-support (in bins) of the truncated window spectrum.
SPECGEMM_J_TAPS = 24

#: n_fft from which the JAX package's auto dispatch considers its
#: fused kernels; below it the exact path serves.
PALLAS_AUTO_MIN_NFFT = 1024

#: small-n_fft buckets certified for specband below the floor (none).
SPECBAND_HIPREC_NFFTS: tuple = ()

#: small-n_fft buckets served by the framed kernel for non-deep-fade
#: hints.
FRAMED_AUTO_NFFTS: tuple = (512,)

#: small-n_fft buckets whose deep-fade hints take the full-f32 framed
#: variant.
FRAMED_HIPREC_NFFTS: tuple = (512,)

#: adaptive tap-count ladder of the specband kernel.
SPECBAND_J_LADDER = (12, 16, SPECGEMM_J_TAPS)

#: upper-lambda cutoff for the reduced-J rungs.
_SPECBAND_SIDELOBE_MAX_LAMBDA_FRAC = 1.0 / 9.6

#: lambda/n_fft threshold of the deep-fade ("low-bin") region.
LOWBIN_FIX_MAX_LAMBDA_FRAC = 1.0 / 12.0


def specband_ok(lambd_value: float, window_length: int, n_fft: int,
                hop_length: int = 1,
                j_taps: int = SPECGEMM_J_TAPS) -> bool:
    """Lambda-validity guard of the specband kernel: the two-sided
    truncation window ``8 |lambd| <= win`` and
    ``2 pi |lambd| J >= 5 n_fft``, for ``n_fft`` up to
    ``SPECBAND_MAX_NFFT``."""
    if window_length != n_fft:
        return False
    from dmel_tpu_torch.ops.specband import SPECBAND_MAX_NFFT
    if n_fft > SPECBAND_MAX_NFFT:
        return False
    lam = abs(float(lambd_value))
    return (8.0 * lam <= window_length
            and 2.0 * math.pi * lam * j_taps >= 5.0 * n_fft)


def lowbin_fix_needed(lambd_value: float, n_fft: int) -> bool:
    """Whether the hint lies in the deep-fade region
    ``|lambd| < n_fft / 12``."""
    return abs(float(lambd_value)) < LOWBIN_FIX_MAX_LAMBDA_FRAC * n_fft


def specband_j_taps(lambd_value: float, n_fft: int) -> int | None:
    """Smallest tap count on the ladder that keeps the J-truncated
    window spectrum inside the parity budget, or None if even the
    largest J fails the coverage rule."""
    lam = abs(float(lambd_value))
    sidelobe_safe = lam <= _SPECBAND_SIDELOBE_MAX_LAMBDA_FRAC * n_fft
    for j in SPECBAND_J_LADDER[:-1]:
        if sidelobe_safe and 2.0 * math.pi * lam * j >= 5.0 * n_fft:
            return j
    j = SPECBAND_J_LADDER[-1]
    if 2.0 * math.pi * lam * j >= 5.0 * n_fft:
        return j
    return None


def specband_compile_hint(lambd_value: float, n_fft: int,
                          hop_length: int) -> float | None:
    """Canonical static hint for the specband dispatch: a
    representative lambda with the same tap count and the same
    deep-fade flag as the actual one, or None outside the truncation
    window."""
    if not specband_ok(lambd_value, n_fft, n_fft, hop_length):
        return None
    j = specband_j_taps(lambd_value, n_fft)
    lb = lowbin_fix_needed(lambd_value, n_fft)
    if lb:
        hint = 1.001 * 5.0 * n_fft / (2.0 * math.pi * j)
    elif abs(float(lambd_value)) > _SPECBAND_SIDELOBE_MAX_LAMBDA_FRAC * n_fft:
        hint = 1.001 * _SPECBAND_SIDELOBE_MAX_LAMBDA_FRAC * n_fft
    else:
        hint = 1.001 * LOWBIN_FIX_MAX_LAMBDA_FRAC * n_fft
    if (specband_j_taps(hint, n_fft) != j
            or lowbin_fix_needed(hint, n_fft) != lb
            or not specband_ok(hint, n_fft, n_fft, hop_length)):
        hint = abs(float(lambd_value))
    return hint


def pallas_compile_hint(lambd_value: float, n_fft: int,
                        hop_length: int) -> float | None:
    """Canonical static hint for the full auto dispatch: the specband
    representative where the specband window applies, else the framed
    small-bucket representative for ``FRAMED_AUTO_NFFTS``.  None keeps
    the exact path."""
    lam = abs(float(lambd_value))
    if (n_fft < PALLAS_AUTO_MIN_NFFT and n_fft in FRAMED_AUTO_NFFTS
            and n_fft not in SPECBAND_HIPREC_NFFTS):
        if not lowbin_fix_needed(lam, n_fft) and lam <= n_fft / 6.0:
            return 1.001 * n_fft / 12.0
        if n_fft in FRAMED_HIPREC_NFFTS and lowbin_fix_needed(lam, n_fft):
            return 0.999 * n_fft / 12.0
        return None
    return specband_compile_hint(lambd_value, n_fft, hop_length)
