"""Real audio datasets: AudioMNIST and ESC-50 (a numpy copy of
``dmel_tpu/data/audio.py``, so the arrays are the JAX package's, bit for
bit).

WAV files are decoded with the standard library's ``wave`` module
(PCM8/16/32 to float32 in [-1, 1], multi-channel files mixed to mono).
ESC-50 is resampled with scipy's polyphase filter to the target rate
and cached beside the data as ``{rate}_xs.npy`` / ``{rate}_ys.npy``.
scipy is imported where it is needed: without it ``resample`` raises
``ImportError``; there is no other resampler to fall back on.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import os
import wave
from math import gcd

import numpy as np


def load_wav(path: str):
    """``(samples, rate)`` of a PCM wav: float32 in [-1, 1] (what
    ``librosa.load(sr=None)`` gives for PCM16/PCM32), mono."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


@functools.lru_cache(maxsize=16)
def _kaiser_fast_fir(up: int, down: int):
    """The FIR of librosa/resampy's ``kaiser_fast`` design (16 zero
    crossings, Kaiser beta 8.555504, rolloff 0.85) for a polyphase
    ``up``/``down`` stage."""
    from scipy.signal import firwin
    num_zeros, beta, rolloff = 16, 8.555504, 0.85
    max_rate = max(up, down)
    half_len = num_zeros * max_rate
    return firwin(2 * half_len + 1, rolloff / max_rate,
                  window=("kaiser", beta))


def resample(x: np.ndarray, sr: int, target_sr: int,
             quality: str = "kaiser_fast") -> np.ndarray:
    """Polyphase resampling of ``x`` from ``sr`` to ``target_sr``, as
    float32.  ``quality="kaiser_fast"`` filters with
    :func:`_kaiser_fast_fir`; ``"polyphase"`` with scipy's default
    filter."""
    if sr == target_sr:
        return x.astype(np.float32)
    from scipy.signal import resample_poly
    g = gcd(sr, target_sr)
    up, down = target_sr // g, sr // g
    if quality == "kaiser_fast":
        h = _kaiser_fast_fir(up, down)
        return resample_poly(x, up, down, window=h).astype(np.float32)
    if quality == "polyphase":
        return resample_poly(x, up, down).astype(np.float32)
    raise ValueError(f"unknown resample quality: {quality!r}")


@dataclasses.dataclass
class ArrayDataset:
    """In-memory ``(xs, ys)`` arrays at one sample rate."""

    xs: np.ndarray
    ys: np.ndarray
    sample_rate: int

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, idx):
        return self.xs[idx], self.ys[idx]


def audio_mnist_big(wav_paths) -> ArrayDataset:
    """AudioMNIST clips at 8 kHz, zero-padded on both sides to 8000
    samples; the label is the leading digit of the file name.  Asserts
    10 classes and a uniform 8 kHz rate."""
    xs, ys, rates = [], [], []
    for p in wav_paths:
        audio, sr = load_wav(p)
        rates.append(sr)
        target = int(os.path.basename(p).split("_")[0])
        x = np.pad(audio, 1 + (8000 - len(audio)) // 2)[:8000]
        xs.append(x)
        ys.append(target)
    assert len(set(ys)) == 10, "expected 10 AudioMNIST classes"
    assert len(set(rates)) == 1 and rates[0] == 8000, "expected uniform 8 kHz"
    return ArrayDataset(np.asarray(xs, dtype=np.float32),
                        np.asarray(ys, dtype=np.int32), 8000)


def audio_mnist_legacy(source_dir: str) -> ArrayDataset:
    """The legacy AudioMNIST layout (``recordings/*.wav``): clips of
    1500 to 5500 samples, zero-padded at the end to 5500."""
    xs, ys, rates = [], [], []
    for p in glob.glob(os.path.join(source_dir, "recordings", "*.wav")):
        audio, sr = load_wav(p)
        rates.append(sr)
        if 1500 <= len(audio) <= 5500:
            x = np.zeros(5500, dtype=np.float32)
            x[:len(audio)] = audio
            xs.append(x)
            ys.append(int(os.path.basename(p).split("_")[0]))
    assert len(set(ys)) == 10
    assert len(set(rates)) == 1 and rates[0] == 8000
    return ArrayDataset(np.asarray(xs, dtype=np.float32),
                        np.asarray(ys, dtype=np.int32), 8000)


def parse_esc50_csv(csv_file: str):
    """``meta/esc50.csv`` rows as ``(filename, fold, target, category)``."""
    with open(csv_file) as f:
        lines = f.readlines()
    meta = []
    for line in lines[1:]:
        row = line.rstrip().split(",")
        meta.append((row[0], int(row[1]), int(row[2]), row[3]))
    return meta


def esc50(source_dir: str, resample_rate: int = 8000) -> ArrayDataset:
    """ESC-50 resampled to ``resample_rate``, read from (or written to)
    the cache ``{rate}_xs.npy`` / ``{rate}_ys.npy`` in ``source_dir``."""
    xs_path = os.path.join(source_dir, f"{resample_rate}_xs.npy")
    ys_path = os.path.join(source_dir, f"{resample_rate}_ys.npy")
    if os.path.exists(xs_path) and os.path.exists(ys_path):
        return ArrayDataset(np.load(xs_path), np.load(ys_path),
                            resample_rate)
    meta = parse_esc50_csv(os.path.join(source_dir, "meta", "esc50.csv"))
    xs, ys = [], []
    for filename, fold, target, category in meta:
        audio, sr = load_wav(os.path.join(source_dir, "audio", filename))
        xs.append(resample(audio, sr, resample_rate))
        ys.append(target)
    xs = np.asarray(xs, dtype=np.float32)
    ys = np.asarray(ys, dtype=np.int32)
    np.save(xs_path, xs)
    np.save(ys_path, ys)
    return ArrayDataset(xs, ys, resample_rate)
