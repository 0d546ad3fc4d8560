"""DMEL, the differentiable (log-)mel spectrogram (counterpart of
``dmel_tpu/ops/dmel.py``): mean subtraction, Gaussian-windowed power
spectrum with ``|lambd|``, mel projection, optional log.

``impl`` picks the route:

- ``"exact"``: ``torch.stft`` and a mel matmul, autograd throughout;
- ``"specband"``: the specband kernels (:mod:`dmel_tpu_torch.ops.specband`),
  K1 forward and K2 for the gradient in ``lambd``;
- ``"framed"``: the framed kernels (:mod:`dmel_tpu_torch.ops.framed`), K3
  forward and K4 for the window's gradient; ``win_length == n_fft`` and
  ``framed.supported``, else ``ValueError``, as in the JAX package;
- ``"fused"``: the fused kernel (:mod:`dmel_tpu_torch.ops.fused`), K5
  forward with the torch adjoint backward, for ``n_fft <= 4096``; above
  that the exact route, as the JAX package's ``pallas_fused`` does;
- ``"auto"``: the route the JAX package's auto dispatch
  (``impl="pallas"``) takes for the same static ``lambd_hint``.

The framed and fused routes have no log epilogue: ``log_output`` takes
the log outside the kernel, as the JAX package does.

:func:`multi_sigma_mel_spectrogram` gives each group of mel bands its
own window (a vector ``lambds``); its ``"auto"`` route is the
multi-sigma specband kernel pair where the JAX package takes
``specband_mel_power_multi``, and the exact route everywhere else.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.ops import framed, fused, specband, stft
from dmel_tpu_torch.ops.mel import device_fbanks, melscale_fbanks_np
from dmel_tpu_torch.ops.specband import LOG_EPS
from dmel_tpu_torch.ops.spectrogram import spectrogram
from dmel_tpu_torch.ops.window import gaussian_window

def _lengths(signal_length: int, optimized: bool,
             window_length: int | None) -> tuple[int, int]:
    """``(win_length, n_fft)``: the static bucket in optimized mode,
    ``(T, 2 T)`` in faithful mode."""
    if optimized:
        if window_length is None:
            raise ValueError("optimized mode needs static window_length")
        return int(window_length), int(window_length)
    return signal_length, 2 * signal_length


def auto_route(*, signal_length: int, hop_length: int, n_mels: int,
               optimized: bool, window_length: int | None,
               lambd_hint: float | None) -> tuple[str, int | None]:
    """``(route, j_taps)`` that the JAX package's auto dispatch takes:
    route is ``"specband"``, ``"framed"``, ``"fused"`` or ``"exact"``;
    ``j_taps`` is set for ``"specband"``."""
    win_length, n_fft = _lengths(signal_length, optimized, window_length)
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
            and framed.supported(n_fft, hop_length, n_mels)):
        return "framed", None
    if (n_fft > fused.MAX_N_FFT or not auto_ok
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
    kernel on the specband route.  ``impl`` is one of ``"exact"``,
    ``"specband"``, ``"framed"``, ``"fused"`` and ``"auto"`` (see the
    module docstring).

    A vector ``lambd`` (K,) is a pack of K trials (the JAX package's
    function under ``jax.vmap``): ``x`` (K, ..., T), trial k's rows
    analysed with ``lambd[k]``'s window, the result ``(K, ..., n_mels,
    n_frames)``.  Every trial takes the route the one static hint gives;
    the kernels run once for the pack (the packed entries of
    :mod:`~dmel_tpu_torch.ops.specband`, :mod:`~dmel_tpu_torch.ops.framed`
    and :mod:`~dmel_tpu_torch.ops.fused`), and the exact route frames,
    multiplies each trial's window and takes ``rfft``
    (:func:`~dmel_tpu_torch.ops.stft.stft_power_packed`).
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
    elif impl in ("framed", "fused", "exact"):
        route = impl
        if (impl == "fused" and _lengths(x.shape[-1], optimized,
                                         window_length)[1] > fused.MAX_N_FFT):
            route = "exact"
    else:
        raise ValueError(f"unknown impl {impl!r}: exact, specband, framed, "
                         "fused or auto")

    if lambd.dim() > 1 or (lambd.dim() == 1 and x.dim() < 2):
        raise ValueError("lambd is a scalar, or a vector (K,) with x (K, "
                         f"..., T); got {tuple(lambd.shape)} and "
                         f"{tuple(x.shape)}")
    if route == "specband":
        n_fft = int(window_length)
        w = gaussian_window(lambd, n_fft, norm=normalize_window,
                            dtype=x.dtype)
        return specband.specband_mel_power(
            x, w, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            sample_rate=sample_rate, f_min=f_min, f_max=f_max,
            j_taps=j_taps, log_epilogue=log_output)
    if route in ("framed", "fused"):
        win_length, n_fft = _lengths(x.shape[-1], optimized, window_length)
        kw = dict(n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
                  sample_rate=sample_rate, f_min=f_min, f_max=f_max)
        if route == "framed":
            w = gaussian_window(lambd, win_length, norm=normalize_window,
                                dtype=x.dtype)
            mel = framed.framed_mel_power(x, w, **kw)
        else:
            mel = fused.dmel_power(x, lambd, win_length=win_length,
                                   normalize_window=normalize_window, **kw)
        return torch.log(mel + LOG_EPS) if log_output else mel

    s = spectrogram(x, lambd, optimized=optimized, hop_length=hop_length,
                    norm=normalize_window, window_length=window_length)
    fb = device_fbanks(s.shape[-2], f_min, f_max, n_mels, sample_rate,
                       dtype=s.dtype, device=dev)
    mel = (s.transpose(-1, -2) @ fb).transpose(-1, -2)
    if log_output:
        mel = torch.log(mel + LOG_EPS)
    return mel


def default_band_map(n_mels: int, n_sigma: int) -> np.ndarray:
    """Contiguous assignment of mel bands to sigma groups: band ``j``
    uses sigma ``j * n_sigma // n_mels``.  A static numpy array, as in
    the JAX package."""
    return (np.arange(n_mels) * n_sigma) // n_mels


def multi_sigma_route(*, hop_length: int, n_mels: int, optimized: bool,
                      window_length: int | None, lambd_hint,
                      impl: str = "auto") -> tuple[str, int | None]:
    """``(route, j_taps)`` of :func:`multi_sigma_mel_spectrogram`: the
    JAX package's condition for its multi-sigma kernel.  ``"specband"``
    (with ``j_taps`` the largest tap count the hints need: one tap width
    serves every group) when ``impl="auto"``, optimized mode with a
    static ``window_length >= PALLAS_AUTO_MIN_NFFT`` that
    ``specband.supported`` takes, and a static ``lambd_hint`` (a scalar
    or one a sigma) every value of which passes ``specband_ok``; else
    ``"exact"``.  Every other ``impl`` takes the exact route, as the
    JAX package's non-``"pallas"`` impls do."""
    if impl not in ("exact", "specband", "framed", "fused", "auto"):
        raise ValueError(f"unknown impl {impl!r}: exact, specband, framed, "
                         "fused or auto")
    if impl == "auto" and optimized and window_length is not None:
        wl = int(window_length)
        hints = (None if lambd_hint is None else
                 [float(h) for h in np.atleast_1d(
                     np.asarray(lambd_hint, dtype=np.float32))])
        if (hints is not None and wl >= stft.PALLAS_AUTO_MIN_NFFT
                and specband.supported(wl, hop_length, n_mels)
                and all(stft.specband_ok(h, wl, wl, hop_length)
                        for h in hints)):
            return "specband", max(stft.specband_j_taps(h, wl)
                                   for h in hints)
    return "exact", None


def multi_sigma_mel_spectrogram(
        x, lambds, *, n_mels: int, sample_rate: int, hop_length: int = 1,
        f_min: float = 0.0, f_max: float | None = None,
        optimized: bool = False, window_length: int | None = None,
        normalize_window: bool = False, subtract_mean: bool = True,
        abs_lambd: bool = True, band_map=None, impl: str = "exact",
        lambd_hint=None, device=None) -> torch.Tensor:
    """Multi-sigma DMEL ``(..., n_mels, T // hop_length + 1)``, mel
    power with no log: a vector of K window parameters ``lambds``, mel
    band ``j`` computed from the spectrogram analysed with window
    ``lambds[band_map[j]]`` (default :func:`default_band_map`).  With
    K == 1 this is :func:`mel_spectrogram`.  Differentiable in every
    ``lambds[k]``; runs on ``device`` (default ``cuda``).  ``lambds`` (P,
    K) is a pack of P trials, each with its K sigmas: ``x`` (P, ..., T),
    the result ``(P, ..., n_mels, n_frames)``, the specband kernels run
    once for the pack.

    The route is :func:`multi_sigma_route`'s: ``impl="auto"`` takes the
    specband kernels at ``k_sig = K`` (one shared spectra pass) where
    the JAX package's ``"pallas"`` takes its multi-sigma kernel; the
    exact route runs K ``torch.stft`` power spectrograms and one
    contraction with the band-masked filterbank ``(K, F, n_mels)``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    lambds = torch.atleast_1d(torch.as_tensor(lambds, dtype=x.dtype)).to(dev)
    packed = lambds.dim() == 2
    k = lambds.shape[-1]
    if band_map is None:
        band_map = default_band_map(n_mels, k)
    if f_max is None:
        f_max = sample_rate // 2
    if subtract_mean:
        x = x - x.mean(dim=-1, keepdim=True)
    if abs_lambd:
        lambds = lambds.abs()
    route, j_taps = multi_sigma_route(
        hop_length=hop_length, n_mels=n_mels, optimized=optimized,
        window_length=window_length, lambd_hint=lambd_hint, impl=impl)
    if route == "specband":
        wl = int(window_length)
        windows = (gaussian_window(lambds, wl, norm=normalize_window,
                                   dtype=x.dtype) if packed else
                   torch.stack([gaussian_window(lam, wl,
                                                norm=normalize_window,
                                                dtype=x.dtype)
                                for lam in lambds]))
        return specband.specband_mel_power_multi(
            x, windows, band_map, n_fft=wl, hop_length=hop_length,
            n_mels=n_mels, sample_rate=sample_rate, f_min=f_min,
            f_max=f_max, j_taps=j_taps)
    bm = specband.check_band_map(band_map, n_mels, k)
    ps = torch.stack([spectrogram(x, lam, optimized=optimized,
                                  hop_length=hop_length,
                                  norm=normalize_window,
                                  window_length=window_length)
                      for lam in lambds.unbind(-1)])       # (K, ..., F, Tt)
    fb_k = _masked_fbanks(ps.shape[-2], float(f_min), float(f_max), n_mels,
                          sample_rate, bm, k, ps.dtype, dev)
    return torch.einsum("k...ft,kfm->...mt", ps, fb_k)


@functools.lru_cache(maxsize=16)
def _masked_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, band_map: tuple, k_sig: int,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``(K, F, n_mels)``: the mel filterbank with sigma ``s``'s copy
    keeping only the bands ``band_map`` gives it, copied to ``device``
    once (a copy from host memory on every call would make the host
    wait for the stream)."""
    fb = melscale_fbanks_np(n_freqs, f_min, f_max, n_mels, sample_rate)
    sel = np.eye(k_sig, dtype=np.float32)[list(band_map)]   # (n_mels, K)
    return torch.tensor(fb[None] * sel.T[:, None, :], dtype=dtype,
                        device=device)


def log_mel_spectrogram(x, lambd, **kwargs) -> torch.Tensor:
    """``log(mel_spectrogram(x, lambd) + 1e-10)``; the log is fused into
    the kernel on the specband route."""
    return mel_spectrogram(x, lambd, log_output=True, **kwargs)
