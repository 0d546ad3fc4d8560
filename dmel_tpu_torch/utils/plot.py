"""Spectrogram plotting (counterpart of ``dmel_tpu/utils/plot.py``).

The caller passes the matplotlib axes, so this module imports no
matplotlib.
"""

from __future__ import annotations

import numpy as np
import torch


def plot_spectrogram(s, ax, decorate_axes: bool = True):
    """Draw a (freq, time) spectrogram ``s`` (a numpy array or a CPU
    tensor) on ``ax`` with frequency increasing upward and
    normalized-frequency ticks."""
    if isinstance(s, torch.Tensor):
        s = s.detach().numpy()
    s = np.asarray(s)
    ax.imshow(np.flip(s, axis=0), aspect="auto")
    if decorate_axes:
        ax.set_xlabel("time")
        ax.set_ylabel("normalized frequency")
    fbins, _ = s.shape
    yticks = list(np.linspace(0, fbins - 1, 5))
    ax.set_yticks(yticks)
    ax.set_yticklabels([str(v) for v in np.linspace(0.5, 0, 5)])
