"""Mel filterbanks with torchaudio semantics (counterpart of
``dmel_tpu/ops/mel.py``): HTK or Slaney scale, no normalisation by
default, built in float64 with numpy and cast to float32."""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(freq, mel_scale: str = "htk"):
    """Convert Hz to mels (HTK formula by default, like torchaudio)."""
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "slaney":
        f_min, f_sp = 0.0, 200.0 / 3
        mels = (freq - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(freq >= min_log_hz,
                        min_log_mel + np.log(freq / min_log_hz) / logstep,
                        mels)
    raise ValueError(f"unknown mel_scale: {mel_scale!r}")


def mel_to_hz(mels, mel_scale: str = "htk"):
    """Convert mels to Hz (inverse of :func:`hz_to_mel`)."""
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale == "slaney":
        f_min, f_sp = 0.0, 200.0 / 3
        freqs = f_min + f_sp * mels
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(mels >= min_log_mel,
                        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                        freqs)
    raise ValueError(f"unknown mel_scale: {mel_scale!r}")


@functools.lru_cache(maxsize=64)
def _melscale_fbanks_np(n_freqs: int, f_min: float, f_max: float,
                        n_mels: int, sample_rate: int, norm,
                        mel_scale: str) -> np.ndarray:
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, mel_scale),
                        hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    fb = fb.astype(np.float32)
    fb.flags.writeable = False          # shared by every caller
    return fb


def melscale_fbanks_np(n_freqs: int, f_min: float, f_max: float,
                       n_mels: int, sample_rate: int, norm=None,
                       mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank ``(n_freqs, n_mels)`` as a read-only
    float32 numpy array."""
    return _melscale_fbanks_np(int(n_freqs), float(f_min), float(f_max),
                               int(n_mels), int(sample_rate), norm,
                               mel_scale)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, norm=None, mel_scale: str = "htk",
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Triangular mel filterbank of shape ``(n_freqs, n_mels)``:
    ``mel = power.T @ fb`` projects ``(n_freqs, n_frames)`` power onto
    ``n_mels`` bands."""
    fb = melscale_fbanks_np(n_freqs, f_min, f_max, n_mels, sample_rate,
                            norm, mel_scale)
    return torch.tensor(fb, dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _fbanks_on(n_freqs: int, f_min: float, f_max: float, n_mels: int,
               sample_rate: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return torch.tensor(melscale_fbanks_np(n_freqs, f_min, f_max, n_mels,
                                           sample_rate),
                        dtype=dtype, device=device)


def device_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                  sample_rate: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """:func:`melscale_fbanks` (HTK, no norm) copied to ``device`` once
    and shared by every caller, read-only: a copy from host memory on
    every call would make the host wait for the stream."""
    return _fbanks_on(int(n_freqs), float(f_min), float(f_max), int(n_mels),
                      int(sample_rate), dtype, torch.device(device or "cpu"))
