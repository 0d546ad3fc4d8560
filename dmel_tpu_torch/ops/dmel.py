"""DMEL, the differentiable (log-)mel spectrogram (counterpart of
``dmel_tpu/ops/dmel.py``): mean subtraction, Gaussian-windowed power
spectrum with ``|lambd|``, mel projection, optional log.

``impl`` picks the route:

- ``"exact"``: ``torch.stft`` and a mel matmul, autograd throughout;
- ``"specband"``: the specband kernel (:mod:`dmel_tpu_torch.ops.specband`);
- ``"auto"``: the route the JAX package's auto dispatch
  (``impl="pallas"``) takes for the same static ``lambd_hint``.  Where
  it would take a kernel that is not ported yet, this raises
  ``NotImplementedError``; it never substitutes another route.
"""

from __future__ import annotations

from math import gcd

import torch

from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.ops import specband, stft
from dmel_tpu_torch.ops.mel import melscale_fbanks
from dmel_tpu_torch.ops.specband import LOG_EPS
from dmel_tpu_torch.ops.spectrogram import spectrogram
from dmel_tpu_torch.ops.window import gaussian_window

#: kernels of the JAX package that the auto dispatch can pick but the
#: port does not have yet
_NOT_PORTED = {
    "framed": "framed (dmel_tpu/ops/pallas/framed_dmel.py)",
    "fused": "fused (dmel_tpu/ops/pallas/fused_dmel.py)",
}
#: the JAX package's framed-kernel geometry guard and fused-kernel cap,
#: which its auto dispatch consults
_FRAMED_MAX_NFFT = 1024
_FUSED_MAX_NFFT = 4096


def _framed_supported(n_fft: int, hop_length: int, n_mels: int) -> bool:
    g = specband.LANE // gcd(hop_length, specband.LANE)
    return (n_fft % specband.LANE == 0 and g <= 16
            and n_mels <= specband.MEL_PAD and n_fft <= _FRAMED_MAX_NFFT)


def auto_route(*, signal_length: int, hop_length: int, n_mels: int,
               optimized: bool, window_length: int | None,
               lambd_hint: float | None) -> tuple[str, int | None]:
    """``(route, j_taps)`` that the JAX package's auto dispatch takes:
    route is ``"specband"``, ``"framed"``, ``"fused"`` or ``"exact"``;
    ``j_taps`` is set for ``"specband"``."""
    if optimized:
        if window_length is None:
            raise ValueError("optimized mode needs static window_length")
        win_length = n_fft = int(window_length)
    else:
        win_length, n_fft = signal_length, 2 * signal_length
    lb_fix = (stft.lowbin_fix_needed(lambd_hint, n_fft)
              if lambd_hint is not None else True)
    geom_ok = (win_length == n_fft
               and specband.supported(n_fft, hop_length, n_mels))
    hiprec_small = (n_fft < stft.PALLAS_AUTO_MIN_NFFT
                    and n_fft in stft.SPECBAND_HIPREC_NFFTS)
    if (geom_ok and lambd_hint is not None
            and (n_fft >= stft.PALLAS_AUTO_MIN_NFFT or hiprec_small)
            and stft.specband_ok(lambd_hint, win_length, n_fft, hop_length)
            and not (n_fft > 1024 and lb_fix)):
        j = stft.specband_j_taps(lambd_hint, n_fft)
        return "specband", stft.SPECGEMM_J_TAPS if j is None else j
    small = n_fft < stft.PALLAS_AUTO_MIN_NFFT
    framed_small = (small and n_fft in stft.FRAMED_AUTO_NFFTS
                    and lambd_hint is not None
                    and not stft.lowbin_fix_needed(lambd_hint, n_fft)
                    and abs(float(lambd_hint)) <= n_fft / 6.0)
    framed_hiprec = (small and n_fft in stft.FRAMED_HIPREC_NFFTS
                     and lambd_hint is not None
                     and stft.lowbin_fix_needed(lambd_hint, n_fft))
    auto_ok = not small or framed_small or framed_hiprec
    if (auto_ok and win_length == n_fft
            and _framed_supported(n_fft, hop_length, n_mels)):
        return "framed", None
    if (n_fft > _FUSED_MAX_NFFT or not auto_ok
            or ((framed_small or framed_hiprec) and small)):
        return "exact", None
    return "fused", None


def mel_spectrogram(x, lambd, *, n_mels: int, sample_rate: int,
                    hop_length: int = 1, f_min: float = 0.0,
                    f_max: float | None = None, optimized: bool = False,
                    window_length: int | None = None,
                    normalize_window: bool = False,
                    subtract_mean: bool = True, abs_lambd: bool = True,
                    impl: str = "exact", lambd_hint: float | None = None,
                    log_output: bool = False, device=None) -> torch.Tensor:
    """Batched differentiable mel power spectrogram
    ``(..., n_mels, T // hop_length + 1)`` of ``x`` (..., T).

    Runs on ``device`` (default ``cuda``; ``x`` and ``lambd`` are moved
    there).  ``lambd_hint`` is the static lambda magnitude the
    ``"auto"`` dispatch decides from, as in the JAX package;
    ``"specband"`` takes its tap count from it too (24 without one).
    ``log_output=True`` returns ``log(mel + 1e-10)``, fused into the
    kernel on the specband route.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    lambd = torch.as_tensor(lambd, dtype=x.dtype).to(dev)
    if f_max is None:
        f_max = sample_rate // 2
    if subtract_mean:
        x = x - x.mean(dim=-1, keepdim=True)
    if abs_lambd:
        lambd = lambd.abs()

    if impl == "auto":
        route, j_taps = auto_route(
            signal_length=x.shape[-1], hop_length=hop_length, n_mels=n_mels,
            optimized=optimized, window_length=window_length,
            lambd_hint=lambd_hint)
        if route in _NOT_PORTED:
            raise NotImplementedError(
                f"the auto dispatch picks the {_NOT_PORTED[route]} kernel "
                "here, which is not ported yet")
    elif impl == "specband":
        if not optimized or window_length is None:
            raise ValueError("the specband route needs optimized mode "
                             "with a static window_length")
        if not specband.supported(int(window_length), hop_length, n_mels):
            raise ValueError("geometry unsupported by the specband kernel; "
                             "see specband.supported")
        route = "specband"
        j_taps = (stft.specband_j_taps(lambd_hint, int(window_length))
                  if lambd_hint is not None else None)
        if j_taps is None:
            j_taps = stft.SPECGEMM_J_TAPS
    elif impl == "exact":
        route = "exact"
    else:
        raise ValueError(f"unknown impl {impl!r}: exact, specband or auto")

    if route == "specband":
        n_fft = int(window_length)
        w = gaussian_window(lambd, n_fft, norm=normalize_window,
                            dtype=x.dtype)
        return specband.specband_mel_power(
            x, w, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            sample_rate=sample_rate, f_min=f_min, f_max=f_max,
            j_taps=j_taps, log_epilogue=log_output)

    s = spectrogram(x, lambd, optimized=optimized, hop_length=hop_length,
                    norm=normalize_window, window_length=window_length)
    fb = melscale_fbanks(s.shape[-2], f_min, f_max, n_mels, sample_rate,
                         dtype=s.dtype, device=dev)
    mel = (s.transpose(-1, -2) @ fb).transpose(-1, -2)
    if log_output:
        mel = torch.log(mel + LOG_EPS)
    return mel


def log_mel_spectrogram(x, lambd, **kwargs) -> torch.Tensor:
    """``log(mel_spectrogram(x, lambd) + 1e-10)``; the log is fused into
    the kernel on the specband route."""
    return mel_spectrogram(x, lambd, log_output=True, **kwargs)
