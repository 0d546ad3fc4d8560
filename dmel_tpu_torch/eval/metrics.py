"""Evaluation metrics for multi-label audio tagging (FSD/PANNs style): a
numpy copy of ``dmel_tpu/eval/metrics.py``."""

from __future__ import annotations

import numpy as np


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP for one class: area under the precision-recall curve
    (step-wise, sklearn-compatible); NaN for a class with no positive."""
    order = np.argsort(-y_score)
    y = y_true[order]
    n_pos = y.sum()
    if n_pos == 0:
        return np.nan
    tp = np.cumsum(y)
    precision = tp / np.arange(1, len(y) + 1)
    return float((precision * y).sum() / n_pos)


def mean_average_precision(y_true: np.ndarray,
                           y_score: np.ndarray) -> float:
    """Macro mAP over the classes that have a positive (the PANNs
    headline metric).

    Args:
      y_true: (N, C) multi-hot ground truth.
      y_score: (N, C) scores/probabilities.
    """
    aps = [average_precision(y_true[:, c], y_score[:, c])
           for c in range(y_true.shape[1])]
    aps = [a for a in aps if not np.isnan(a)]
    return float(np.mean(aps)) if aps else 0.0


def top1_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Fraction of samples whose top-scoring class is a true label."""
    pred = np.argmax(y_score, axis=-1)
    return float(np.mean(y_true[np.arange(len(pred)), pred]))
