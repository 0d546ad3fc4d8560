"""The paper's figures (counterpart of ``dmel_tpu/eval/figures.py``),
split into data and drawing.

- :func:`data_example_spectrograms` computes the demo spectrograms of
  the three Gauss-pulse classes at lambda scales 1, 0.2 and 5, and
  :func:`produce_data_example_plot` draws them in a 3 x 3 grid;
- :func:`accuracy_curves` computes, from a sweep's rows, the accuracy
  and lambda_est against lambda_init with the trainable flag as hue,
  and :func:`produce_accuracy_plot` draws them in a 2 x n_models grid.

The data half needs numpy and torch only, so it runs where matplotlib
is not installed; the drawing half imports matplotlib (with the Agg
backend) inside the functions.  Neither imports pandas or seaborn.

One deliberate difference: the JAX package draws each curve with
seaborn's ``lineplot``, whose shaded 95 % band is a bootstrap with an
unseeded ``n_boot``; here the band is not drawn.  At the published
grids, one trial per (lambda_init, trainable), that band has zero
width.  The lines, markers, hue order, legends, limits and labels are
the JAX package's.

    python -m dmel_tpu_torch.eval.figures --sweep_dir SWEEP [--split test]
        [--out_dir DIR] [--device cpu]
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from dmel_tpu_torch.data.synthetic import make_gauss_pulse_dataset
from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.eval.tables import MODEL_TITLES
from dmel_tpu_torch.experiments.runner import load_results, read_rows
from dmel_tpu_torch.ops.spectrogram import spectrogram
from dmel_tpu_torch.utils.plot import plot_spectrogram

#: expected valid-accuracy bands, the y-limits of the accuracy row
ACC_BANDS = {
    "time_frequency": (0.95, 1.00),
    "audio_mnist": (0.75, 0.96),
    "esc50": (0.65, 0.90),
}

#: per-dataset model columns, in order
DATASET_MODELS = {
    "audio_mnist": ["mel_linear_net", "mel_conv_net"],
    "esc50": ["panns_cnn6"],
    "time_frequency": ["linear_net", "conv_net"],
}

#: the data example's lambda scales, one a column
SCALES = (1.0, 0.2, 5.0)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def data_example_spectrograms(sigma_ref: float = 6.38, n_points: int = 128,
                              *, device=None) -> np.ndarray:
    """``(3, 3, F, T)`` power spectrograms: the first demo clip of each
    Gauss-pulse class (rows) at lambda ``sigma_ref`` times 1, 0.2 and 5
    (columns), in faithful mode at hop 1 (``n_fft = 2 n_points``),
    computed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ds = make_gauss_pulse_dataset(sigma=sigma_ref, n_points=n_points,
                                  noise_std=0.0, n_samples=64, demo=True,
                                  seed=0)
    rows = []
    for cls in range(3):
        idx = int(np.nonzero(ds.ys == cls)[0][0])
        x = torch.as_tensor(ds.xs[idx]).to(dev)
        rows.append([spectrogram(x - x.mean(), sigma_ref * scale,
                                 hop_length=1).cpu().numpy()
                     for scale in SCALES])
    return np.asarray(rows)


def produce_data_example_plot(out_path: str, sigma_ref: float = 6.38,
                              n_points: int = 128, *, device=None) -> str:
    """Draw :func:`data_example_spectrograms` in a 3 x 3 grid, one class
    a row and one lambda scale a column, and save it to ``out_path``."""
    specs = data_example_spectrograms(sigma_ref, n_points, device=device)
    plt = _pyplot()
    fig, ax = plt.subplots(3, 3, figsize=(8, 8))
    for row in range(3):
        for col, scale in enumerate(SCALES):
            plot_spectrogram(specs[row, col], ax[row, col],
                             decorate_axes=False)
            if row == 0:
                ax[row, col].set_title(
                    rf"$\lambda = {sigma_ref * scale:.1f}$")
        ax[row, 0].set_ylabel("normalized frequency")
    for col in range(3):
        ax[2, col].set_xlabel("time")
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _hue(v) -> str:
    """The trainable flag as the hue's category (pandas' ``astype(str)``
    of the cell)."""
    return "nan" if _missing(v) else str(v)


def _mean_curves(rows, ycol):
    """``{hue: (x, y)}``, hues in order of first appearance: the sorted
    distinct ``init_lambd`` values of the hue's rows and the mean of
    ``ycol`` at each, rows missing either value left out."""
    points = {}
    for r in rows:
        x, y = r.get("config/init_lambd"), r.get(ycol)
        hue = _hue(r.get("config/trainable"))
        if _missing(x) or _missing(y):
            continue
        points.setdefault(hue, {}).setdefault(float(x), []).append(float(y))
    curves = {}
    for hue, by_x in points.items():
        xs = np.array(sorted(by_x))
        curves[hue] = (xs, np.array([np.mean(by_x[x]) for x in xs]))
    return curves


def accuracy_curves(rows, dataset_name: str, split: str = "valid") -> dict:
    """What the accuracy figure plots, from a sweep's rows: those of
    ``load_results`` for ``split="valid"``, those of the sweep's
    ``{dataset_name}.csv`` (``read_rows``) for ``split="test"``.

    Returns a dict: ``models`` (the column order: ``DATASET_MODELS``'
    entry filtered by the models present, else the models present),
    ``titles``, ``ycol`` and ``ylabel`` (the accuracy row), ``lcol``
    (``best_lambd_est`` where the rows carry it, else ``lambd_est``),
    ``band`` (the accuracy row's y-limits or None), ``sigma_ref`` (of
    the first row, or None) and ``curves``: ``curves[model][col]`` is
    ``{hue: (x, y)}`` for ``col`` ``ycol`` and ``lcol``, hues (the
    trainable flag as a string) in order of first appearance, x the
    sorted ``init_lambd`` values and y the mean at each.
    """
    rows = list(rows)
    if split == "test":
        ycol, ylabel = "test_accuracy", "Test accuracy"
    else:
        ycol, ylabel = "best_valid_acc", "Validation accuracy"
    present = list(dict.fromkeys(str(r["config/model_name"]) for r in rows))
    models = [m for m in DATASET_MODELS.get(dataset_name, present)
              if m in present] or present
    lcol = ("best_lambd_est" if any("best_lambd_est" in r for r in rows)
            else "lambd_est")
    curves = {}
    for m in models:
        rm = [r for r in rows if str(r["config/model_name"]) == m]
        curves[m] = {ycol: _mean_curves(rm, ycol),
                     lcol: _mean_curves(rm, lcol)}
    sigma_ref = rows[0].get("config/sigma_ref") if rows else None
    return dict(models=models,
                titles=[MODEL_TITLES.get(m, m) for m in models],
                ycol=ycol, ylabel=ylabel, lcol=lcol,
                band=ACC_BANDS.get(dataset_name),
                sigma_ref=None if _missing(sigma_ref) else float(sigma_ref),
                curves=curves)


def _lineplot(ax, curves: dict, legend_loc: str):
    """One line with ``"o"`` markers a hue, in the default colour cycle,
    and a legend titled "Trainable"."""
    for i, (hue, (x, y)) in enumerate(curves.items()):
        ax.plot(x, y, marker="o", color=f"C{i}", label=hue)
    ax.legend(loc=legend_loc, title="Trainable")


def produce_accuracy_plot(sweep_dir: str, out_path: str | None = None,
                          split: str = "valid") -> str:
    """The per-dataset accuracy and lambda_est figure of a sweep: a 2 x
    n_models grid, one titled column a model, row 0 the accuracy (valid
    or test) against lambda_init, row 1 lambda_est against lambda_init,
    the trainable flag as hue, ``ACC_BANDS``' y-limits, y-labels on the
    first column and x-labels on the bottom row, and the dashed
    sigma_ref line where the sweep has one.  Saved to ``out_path``
    (default ``{sweep_dir}/{split}_{dataset}.pdf``).

    The JAX package's shaded bootstrap band around each line is not
    drawn (see the module docstring)."""
    rows = load_results(sweep_dir)
    dataset_name = str(rows[0]["config/dataset_name"])
    if split == "test":
        rows = read_rows(os.path.join(sweep_dir, f"{dataset_name}.csv"))
    c = accuracy_curves(rows, dataset_name, split)
    plt = _pyplot()
    n = len(c["models"])
    column_width, figure_height = 4, 3
    fig, ax = plt.subplots(2, n, figsize=(column_width * n,
                                          figure_height * 2),
                           squeeze=False)
    for col, (model, title) in enumerate(zip(c["models"], c["titles"])):
        ax[0, col].set_title(title)
        _lineplot(ax[0, col], c["curves"][model][c["ycol"]], "lower center")
        _lineplot(ax[1, col], c["curves"][model][c["lcol"]], "upper left")
        if c["band"]:
            ax[0, col].set_ylim(c["band"])
        ax[0, col].set_ylabel(c["ylabel"] if col == 0 else "")
        ax[0, col].set_xlabel("")
        ax[1, col].set_ylabel(r"$\lambda_{est}$" if col == 0 else "")
        ax[1, col].set_xlabel(r"$\lambda_{init}$")
        if c["sigma_ref"] is not None:
            ax[1, col].axhline(c["sigma_ref"], linestyle="dashed",
                               color="purple", label=r"$\sigma_{ref}$")
            ax[1, col].legend(loc="upper left")
    fig.tight_layout()
    if out_path is None:
        out_path = os.path.join(sweep_dir, f"{split}_{dataset_name}.pdf")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Produce figures.")
    parser.add_argument("--sweep_dir", required=True, type=str)
    parser.add_argument("--split", default="valid",
                        choices=["valid", "test"])
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="where the data example's spectrograms are "
                             "computed (default cuda)")
    args = parser.parse_args(argv)
    out_dir = args.out_dir or args.sweep_dir
    os.makedirs(out_dir, exist_ok=True)
    produce_data_example_plot(os.path.join(out_dir, "data_example.png"),
                              device=args.device)
    produce_accuracy_plot(args.sweep_dir,
                          os.path.join(out_dir, "accuracy.png"),
                          split=args.split)


if __name__ == "__main__":
    main()
