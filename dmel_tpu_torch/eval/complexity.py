"""Analytic complexity model: one DMEL training against a bank of ``D``
fixed-window baselines (a numpy copy of ``cost_ratio`` from
``dmel_tpu/eval/complexity.py``).

The ratio ``C_DMEL / C_baseline`` as a function of ``D``, with the cost
split between the FFT (weight ``c1``) and the network (``1 - c1``), and
its two-panel plot (:func:`produce_complexity_plot`, which imports
matplotlib when called).
"""

from __future__ import annotations

import numpy as np


def cost_ratio(d_values, c1: float, init_mi: float, *, fs: int = 8000,
               seconds: int = 5, n_mels: int = 128, hop_s: float = 0.010,
               lr: float = 0.001, opt_mi: float = 0.035) -> np.ndarray:
    """``C_DMEL / C_baseline`` for each baseline-bank size in
    ``d_values``.

    Args:
      d_values: iterable of baseline-bank sizes D.
      c1: FFT-cost weight in [0, 1]; the network's weight is ``1 - c1``.
      init_mi: initial window length (seconds).
    """
    c2 = 1.0 - c1
    n = fs * seconds
    c = hop_s * fs
    b = int(np.abs(init_mi - opt_mi) / lr)  # number of training passes

    out = np.zeros(len(d_values))
    for i, d in enumerate(d_values):
        base_mi = np.linspace(c * 2, 0.3 * fs, d)
        ours_mi = np.linspace(init_mi * fs, opt_mi * fs, b)

        cost_base = (b * c1 * np.sum(n * np.log(base_mi))
                     + b * c2 * np.sum(2 * n_mels * n / base_mi))
        cost_ours = (c1 * n / c * np.sum(ours_mi * np.log(ours_mi))
                     + b * c2 * n_mels * n / c)
        out[i] = cost_ours / cost_base
    return out


def produce_complexity_plot(out_path: str = "time_complexity.png") -> str:
    """Two-panel plot of :func:`cost_ratio` over D = 1..59 (cost
    dominated by the network, then by the FFT) for initial window
    lengths of 20 and 300 ms, with the ratio 1 dashed; saved to
    ``out_path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ds = np.arange(1, 60)
    init_mis = [0.02, 0.3]
    labels = [r"$l_{\lambda_{init}} = 20$ ms",
              r"$l_{\lambda_{init}} = 300$ ms"]
    c1s = [0.0001, 0.9999]
    titles = ["Cost dominated by NN", "Cost dominated by FFT"]

    fig, ax = plt.subplots(1, 2, figsize=(8, 3))
    for init_mi, label in zip(init_mis, labels):
        for j, c1 in enumerate(c1s):
            ax[j].plot(ds, cost_ratio(ds, c1, init_mi), label=label)
            ax[j].set_title(titles[j])
            ax[j].set_xlabel("D")
            ax[j].set_ylim([0, 2.0])
    for a in ax:
        a.axhline(1, color="purple", linestyle="dashed", label="reference")
        a.legend()
    ax[0].set_ylabel(r"$C_{DMEL} / C_{baseline}$")
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    produce_complexity_plot()
