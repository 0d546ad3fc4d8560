"""Synthetic Gauss-pulse datasets (a numpy-only copy of
``dmel_tpu/data/synthetic.py``, so the port needs nothing of the JAX
package): the three-class ``time_frequency`` task
(:func:`make_gauss_pulse_dataset`) and the ESC-50-shaped 10-class task
(:func:`make_esc50_synth_dataset`).  Same seed, same clips, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def fmconst_np(n_points: int, fnorm, phase) -> np.ndarray:
    """Constant-frequency sinusoid, amplitude-normalized; vectorized
    over leading dims of fnorm/phase."""
    ts = np.arange(n_points, dtype=np.float64)
    fnorm = np.asarray(fnorm, dtype=np.float64)[..., None]
    phase = np.asarray(phase, dtype=np.float64)[..., None]
    y = np.sin(2.0 * np.pi * fnorm * ts + phase)
    return y / np.max(y, axis=-1, keepdims=True)


def gauss_window_np(sigma, tc, n_points: int) -> np.ndarray:
    """Amplitude-normalized translated Gaussian, vectorized over
    leading dims of sigma/tc."""
    ts = np.arange(n_points, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)[..., None]
    tc = np.asarray(tc, dtype=np.float64)[..., None]
    w = np.exp(-0.5 * ((ts - tc) / (sigma + 1e-15)) ** 2)
    return w / np.max(w, axis=-1, keepdims=True)


def gauss_pulse_np(t_loc, f_loc, sigma, phase, n_points: int) -> np.ndarray:
    """Gaussian-envelope constant-FM pulse, mean-subtracted."""
    gp = gauss_window_np(sigma, t_loc, n_points) * fmconst_np(
        n_points, f_loc, phase)
    return gp - np.mean(gp, axis=-1, keepdims=True)


@dataclasses.dataclass
class GaussPulseDataset:
    """Arrays: ``xs (n, n_points) float32``, ``ys (n,) int32``,
    ``locs (n, 4) float32`` (ground-truth bookkeeping for sanity
    checks)."""

    xs: np.ndarray
    ys: np.ndarray
    locs: np.ndarray
    sigma: float
    n_points: int

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, idx):
        return self.xs[idx], self.ys[idx]


def make_gauss_pulse_dataset(sigma: float, n_points: int, noise_std: float,
                             n_samples: int = 10000,
                             f_center_max_offset: float = 0.0,
                             t_center_max_offset: float = 0.0,
                             demo: bool = False,
                             seed: int | None = None) -> GaussPulseDataset:
    """The three-class Gauss-pulse time-frequency task: class 0 a single
    pulse with its sigma scaled in time or in frequency, class 1 two
    pulses apart in time, class 2 two pulses apart in frequency, with
    uniform noise and amplitude jitter, mean-subtracted.

    ``f_center_max_offset``/``t_center_max_offset`` jitter the pattern's
    centre; ``demo`` fixes the offsets, scales and amplitudes.
    ``seed=None`` draws fresh entropy (the original code never seeds);
    an int reproduces the JAX package's clips bit for bit."""
    rng = np.random.default_rng(seed)
    n = n_samples
    u = lambda lo, hi, size=n: rng.uniform(lo, hi, size)  # noqa: E731

    # displacement limits
    t_max = n_points / 5
    f_max = 0.5 / 5
    t_min = sigma
    f_min = 0.5 * (t_min / n_points)
    sigma_scale_max = (2 * t_max) / (6 * sigma) + 1
    sigma_scale_min = 1 / sigma_scale_max

    if demo:
        f_center_offset = np.zeros(n)
        t_center_offset = np.zeros(n)
        f_offset = np.full(n, 0.5 * f_max)
        t_offset = np.full(n, 0.5 * t_max)
    else:
        f_center_offset = u(-f_center_max_offset, f_center_max_offset)
        t_center_offset = u(-t_center_max_offset, t_center_max_offset)
        f_offset = u(f_min, f_max)
        t_offset = u(t_min, t_max)

    t_center = t_center_offset + n_points / 2
    f_center = f_center_offset + 0.25

    ys = rng.integers(0, 3, n)

    # class 0: sigma scaled up (time-spread) or down (frequency-spread)
    spread_time = rng.integers(0, 2, n).astype(bool)
    sigma_scale = np.where(spread_time, u(1.0, sigma_scale_max),
                           u(sigma_scale_min, 1.0))
    if demo:
        sigma_scale = np.ones(n)

    phases = rng.uniform(0, 2 * np.pi, (4, n))

    # every class's pulses for every clip, then selected by class
    x0 = gauss_pulse_np(t_center, f_center, sigma * sigma_scale, phases[0],
                        n_points)
    x1 = (gauss_pulse_np(t_center - t_offset, f_center, sigma, phases[1],
                         n_points)
          + gauss_pulse_np(t_center + t_offset, f_center, sigma, phases[2],
                           n_points))
    x2 = (gauss_pulse_np(t_center, f_center - f_offset, sigma, phases[1],
                         n_points)
          + gauss_pulse_np(t_center, f_center + f_offset, sigma, phases[2],
                           n_points))
    x = np.where((ys == 0)[:, None], x0,
                 np.where((ys == 1)[:, None], x1, x2))

    locs = np.zeros((n, 4), dtype=np.float64)
    locs[ys == 0] = np.stack([t_center, f_center, spread_time.astype(float),
                              sigma_scale], 1)[ys == 0]
    locs[ys == 1] = np.stack([t_center - t_offset, f_center,
                              t_center + t_offset, f_center], 1)[ys == 1]
    locs[ys == 2] = np.stack([t_center, f_center - f_offset,
                              t_center, f_center + f_offset], 1)[ys == 2]

    # variability: uniform noise and amplitude jitter
    noise = noise_std * rng.uniform(0, 1, (n, n_points))
    amplitude = np.ones(n) if demo else u(0.5, 1.0)
    x = x * amplitude[:, None] + noise
    x = x - x.mean(axis=-1, keepdims=True)

    return GaussPulseDataset(xs=x.astype(np.float32),
                             ys=ys.astype(np.int32),
                             locs=locs.astype(np.float32),
                             sigma=sigma, n_points=n_points)


def make_esc50_synth_dataset(sigma: float = 8000 * 0.035 / 6,
                             n_points: int = 40000,
                             noise_std: float = 0.05,
                             n_samples: int = 2000,
                             seed: int | None = 0,
                             hard: bool = False) -> GaussPulseDataset:
    """Learnable ESC-50-*shaped* synthetic task.

    10 classes of Gauss-pulse composites at the esc50 geometry (5 s @
    8 kHz): classes 0-8 are the lambda-sensitive three-pattern
    construction of the ``time_frequency`` task (single spread pulse /
    time pair / freq pair) replicated at three carriers; class 9 is
    a diagonal (time+freq) pair.  Pulse-pair separations sit at the
    sigma_ref resolution limit, so classification accuracy depends on
    the spectrogram's window length — a trainable lambda starting from
    a bad init must move toward sigma_ref to resolve the patterns.

    Pulses are synthesized inside a ±2048-sample window and
    scatter-added into the (zero + noise) clip — the dense 40000-point
    per-pulse synthesis of the small task would waste ~20x memory for
    envelopes that are ~1e-40 outside the window.
    """
    rng = np.random.default_rng(seed)
    n = n_samples
    win = 4096                               # pulse-pattern support
    half = win // 2
    carriers = np.array([0.15, 0.25, 0.35])
    sigma_f = 1.0 / (2 * np.pi * sigma)      # pulse frequency std

    ys = rng.integers(0, 10, n)
    pattern = np.where(ys == 9, 3, ys % 3)   # 0 single, 1 tpair, 2 fpair
    carrier = carriers[np.where(ys == 9, rng.integers(0, 3, n), ys // 3)]
    carrier = carrier + rng.uniform(-0.01, 0.01, n)   # carrier jitter

    # separations at the resolution limit.  hard mode pushes the pairs
    # INSIDE the wrong-window blur radius (2-3.5 sigma instead of 3-6)
    # and widens the single-pulse spread so pattern classes overlap
    # unless the window length is right.
    lo, hi = (2.0, 3.5) if hard else (3.0, 6.0)
    t_off = rng.uniform(lo * sigma, hi * sigma, n)
    f_off = rng.uniform(lo * sigma_f, hi * sigma_f, n)
    spread_time = rng.integers(0, 2, n).astype(bool)
    scale_hi = 4.0 if hard else 3.0
    sigma_scale = np.where(spread_time, rng.uniform(1.5, scale_hi, n),
                           rng.uniform(1 / scale_hi, 1 / 1.5, n))
    phases = rng.uniform(0, 2 * np.pi, (2, n))

    tc = np.full(n, float(half))             # pattern window center
    patt = np.zeros((n, win), dtype=np.float64)
    for p in range(4):
        m = pattern == p
        if not m.any():
            continue
        if p == 0:
            patt[m] = gauss_pulse_np(tc[m], carrier[m],
                                     sigma * sigma_scale[m],
                                     phases[0, m], win)
        elif p == 1:
            patt[m] = (gauss_pulse_np(tc[m] - t_off[m], carrier[m], sigma,
                                      phases[0, m], win)
                       + gauss_pulse_np(tc[m] + t_off[m], carrier[m],
                                        sigma, phases[1, m], win))
        elif p == 2:
            patt[m] = (gauss_pulse_np(tc[m], carrier[m] - f_off[m], sigma,
                                      phases[0, m], win)
                       + gauss_pulse_np(tc[m], carrier[m] + f_off[m],
                                        sigma, phases[1, m], win))
        else:                                # diagonal pair
            patt[m] = (gauss_pulse_np(tc[m] - t_off[m],
                                      carrier[m] - f_off[m], sigma,
                                      phases[0, m], win)
                       + gauss_pulse_np(tc[m] + t_off[m],
                                        carrier[m] + f_off[m], sigma,
                                        phases[1, m], win))

    amplitude = rng.uniform(0.5, 1.0, n)
    patt *= amplitude[:, None]

    x = (noise_std * rng.uniform(0, 1, (n, n_points))).astype(np.float32)
    start = rng.integers(0, n_points - win + 1, n)
    idx = start[:, None] + np.arange(win)[None, :]
    np.put_along_axis(
        x, idx, np.take_along_axis(x, idx, axis=1) + patt.astype(np.float32),
        axis=1)
    x -= x.mean(axis=-1, keepdims=True)

    locs = np.stack([start + half, carrier, t_off, f_off], 1)
    return GaussPulseDataset(xs=x, ys=ys.astype(np.int32),
                             locs=locs.astype(np.float32),
                             sigma=sigma, n_points=n_points)
