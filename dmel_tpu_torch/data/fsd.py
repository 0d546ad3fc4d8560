"""FSD50K: multi-label environmental sounds over 200 classes (a numpy
copy of ``dmel_tpu/data/fsd.py``, so the arrays are the JAX package's,
bit for bit).  The official layout:

    <root>/FSD50K.ground_truth/dev.csv        fname,labels,mids,split
    <root>/FSD50K.ground_truth/eval.csv       fname,labels,mids
    <root>/FSD50K.ground_truth/vocabulary.csv index,label,mid
    <root>/FSD50K.dev_audio/<fname>.wav
    <root>/FSD50K.eval_audio/<fname>.wav

Clips are resampled to ``resample_rate``, center-cropped or centered in
zeros to ``n_points`` samples, and their labels become multi-hot
float32 vectors.  Each split is cached beside the data as
``{rate}_{n_points}_{split}_{xs,ys}.npy``.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from dmel_tpu_torch.data.audio import ArrayDataset, load_wav, resample


def load_vocabulary(root: str) -> dict:
    """Label string -> class index (``vocabulary.csv``)."""
    path = os.path.join(root, "FSD50K.ground_truth", "vocabulary.csv")
    vocab = {}
    with open(path) as f:
        for row in csv.reader(f):
            vocab[row[1]] = int(row[0])
    return vocab


def _fix_length(x: np.ndarray, n_points: int) -> np.ndarray:
    """The middle ``n_points`` samples of ``x``, or ``x`` centered in
    zeros where it is shorter."""
    if len(x) >= n_points:
        start = (len(x) - n_points) // 2
        return x[start:start + n_points]
    out = np.zeros(n_points, dtype=np.float32)
    ofs = (n_points - len(x)) // 2
    out[ofs:ofs + len(x)] = x
    return out


def _load_split(root: str, csv_name: str, audio_dir: str, vocab: dict,
                resample_rate: int, n_points: int,
                split_filter: str | None = None):
    """``(xs, ys)`` of the rows of ``csv_name`` (those whose ``split``
    is ``split_filter``, where one is given), in file order."""
    xs, ys = [], []
    with open(os.path.join(root, "FSD50K.ground_truth", csv_name)) as f:
        for row in csv.DictReader(f):
            if split_filter is not None and row.get("split") != split_filter:
                continue
            path = os.path.join(root, audio_dir, row["fname"] + ".wav")
            audio, sr = load_wav(path)
            xs.append(_fix_length(resample(audio, sr, resample_rate),
                                  n_points))
            y = np.zeros(len(vocab), dtype=np.float32)
            for label in row["labels"].split(","):
                y[vocab[label]] = 1.0
            ys.append(y)
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def fsd50k(root: str, resample_rate: int = 8000, n_points: int = 40000):
    """``(train, valid, test)`` datasets with multi-hot float32 labels:
    the rows of ``dev.csv`` marked ``train`` and ``val``, and
    ``eval.csv``; each read from its cache where both files exist, else
    loaded and cached."""
    vocab = load_vocabulary(root)
    out = []
    cache_key = f"{resample_rate}_{n_points}"
    for name, csv_name, audio_dir, filt in [
            ("train", "dev.csv", "FSD50K.dev_audio", "train"),
            ("val", "dev.csv", "FSD50K.dev_audio", "val"),
            ("test", "eval.csv", "FSD50K.eval_audio", None)]:
        xs_p = os.path.join(root, f"{cache_key}_{name}_xs.npy")
        ys_p = os.path.join(root, f"{cache_key}_{name}_ys.npy")
        if os.path.exists(xs_p) and os.path.exists(ys_p):
            xs, ys = np.load(xs_p), np.load(ys_p)
        else:
            xs, ys = _load_split(root, csv_name, audio_dir, vocab,
                                 resample_rate, n_points, filt)
            np.save(xs_p, xs)
            np.save(ys_p, ys)
        out.append(ArrayDataset(xs, ys, resample_rate))
    return tuple(out)
