"""LaTeX results tables (counterpart of ``dmel_tpu/eval/tables.py``).

Table 1 (AudioMNIST, ESC-50: one block per initial window length in ms)
and Table 2 (time_frequency: one block per initial lambda) give the mean
and standard deviation of the test accuracy of the trainable front end
(DMEL, or DSPEC on the synthetic task) and of the fixed baseline, and
the (min, max) learned lambda, in ms through ``lambda * 6 / sr`` in
Table 1.

The JAX package computes them with pandas on the sweep's
``{dataset}.csv``; here the rows come from the ``csv`` module
(:func:`~dmel_tpu_torch.experiments.runner.read_rows`) and the
statistics from numpy with pandas' rules: empty cells are skipped, the
standard deviation is the sample one (``ddof=1``), and an empty group
gives ``nan``.  The strings equal the JAX package's, character for
character.

    python -m dmel_tpu_torch.eval.tables --results_dir RESULTS
"""

from __future__ import annotations

import math
import os

import numpy as np

from dmel_tpu_torch.experiments.runner import read_rows

MODEL_TITLES = {
    "conv_net": "ConvNet",
    "linear_net": "LinearNet",
    "mel_linear_net": "MelLinearNet",
    "mel_conv_net": "MelConvNet",
    "mel_mlp_net": "MelMlpNet",
    "panns_cnn6": "PANNs CNN6",
}


def get_model_title(model_name: str) -> str:
    try:
        return MODEL_TITLES[model_name]
    except KeyError:
        raise ValueError(f"model_name: {model_name} is not defined.")


def _values(rows, key) -> np.ndarray:
    """The column's numbers, empty cells left out (pandas' skipna)."""
    vals = [float(r[key]) for r in rows if r.get(key) is not None]
    return np.asarray([v for v in vals if not math.isnan(v)], np.float64)


def _mean(rows, key) -> float:
    v = _values(rows, key)
    return float(v.mean()) if len(v) else float("nan")


def _std(rows, key) -> float:
    """The sample standard deviation (pandas' ``std``, ddof 1)."""
    v = _values(rows, key)
    return float(v.std(ddof=1)) if len(v) > 1 else float("nan")


def _trainable(row) -> bool:
    t = row["config/trainable"]
    return t if isinstance(t, bool) else str(t) == "True"


def _split(rows):
    return ([r for r in rows if _trainable(r)],
            [r for r in rows if not _trainable(r)])


def window_length_results(rows, window_length: float, sr: int = 8000):
    """The rows whose initial lambda is that of a window of
    ``window_length`` seconds (``lambda = window_length / 6 * sr``)."""
    init_lambd = window_length / 6 * sr
    eps = 1e-5
    return [r for r in rows if init_lambd - eps
            < float(r["config/init_lambd"]) < init_lambd + eps]


def _rows(sweep_dir: str, dataset_name: str):
    return read_rows(os.path.join(sweep_dir, f"{dataset_name}.csv"))


def produce_table_1(sweep_dir: str, dataset_name: str,
                    window_lengths=(0.010, 0.035, 0.300), sr: int = 8000,
                    model_title: str = "LNet") -> str:
    """DMEL against the baseline per initial window length; printed and
    returned."""
    df_train, df_fixed = _split(_rows(sweep_dir, dataset_name))
    lines = ["Model & $l_{\\lambda_{init}}$ & $l_{\\lambda_{est}}$ & "
             "Method & Accuracy \\\\", "\\hline \\hline"]
    for wlen in window_lengths:
        dtr = window_length_results(df_train, wlen, sr)
        dfx = window_length_results(df_fixed, wlen, sr)
        est = np.abs(_values(dtr, "best_lambd_est")) * 6 / sr
        lines.append(
            "{} & {} ms & ({}, {}) ms & DMEL & ${:.1f} \\pm {:.1f}$ \\\\"
            .format(model_title, int(wlen * 1000),
                    int(est.min() * 1000) if len(dtr) else "-",
                    int(est.max() * 1000) if len(dtr) else "-",
                    _mean(dtr, "test_accuracy") * 100,
                    _std(dtr, "test_accuracy") * 100))
        lines.append(
            "{} & {} ms & {} ms & baseline & ${:.1f} \\pm {:.1f}$ \\\\"
            .format(model_title, int(wlen * 1000), int(wlen * 1000),
                    _mean(dfx, "test_accuracy") * 100,
                    _std(dfx, "test_accuracy") * 100))
        lines.append("\\hline")
    table = "\n".join(lines)
    print(table)
    return table


def produce_table_2(sweep_dir: str, dataset_name: str = "time_frequency",
                    sigma_ref: float = 6.38,
                    scales=(0.2, 1.0, 5.0)) -> str:
    """DSPEC against the baseline per initial lambda on the synthetic
    task; printed and returned."""
    df_train, df_fixed = _split(_rows(sweep_dir, dataset_name))

    def at(rows, lam0):
        return [r for r in rows
                if abs(float(r["config/init_lambd"]) - lam0) < 1e-9]

    lines = ["Model & $\\lambda_{init}$ & $\\lambda_{est}$ & Method & "
             "Accuracy \\\\", "\\hline \\hline"]
    for scale in scales:
        lam0 = sigma_ref * scale
        dtr, dfx = at(df_train, lam0), at(df_fixed, lam0)
        est = np.abs(_values(dtr, "best_lambd_est"))
        lines.append(
            "LinearNet & {:.1f} & ({:.1f}, {:.1f}) & DSPEC & "
            "${:.1f} \\pm {:.1f}$ \\\\".format(
                lam0, est.min() if len(dtr) else float("nan"),
                est.max() if len(dtr) else float("nan"),
                _mean(dtr, "test_accuracy") * 100,
                _std(dtr, "test_accuracy") * 100))
        lines.append(
            "LinearNet & {:.1f} & {:.1f} & baseline & "
            "${:.1f} \\pm {:.1f}$ \\\\".format(
                lam0, lam0,
                _mean(dfx, "test_accuracy") * 100,
                _std(dfx, "test_accuracy") * 100))
        lines.append("\\hline")
    table = "\n".join(lines)
    print(table)
    return table


def produce_result_table(sweep_dir: str, dataset_name: str,
                         init_lambd: float | None = None) -> str:
    """Trainable against fixed test accuracy per model; printed and
    returned."""
    model_names = {"audio_mnist": ["mel_conv_net", "mel_linear_net"],
                   "esc50": ["panns_cnn6"],
                   "fsd": ["panns_cnn6"]}.get(dataset_name, [])
    rows = [r for r in _rows(sweep_dir, dataset_name)
            if r["config/dataset_name"] == dataset_name]
    if init_lambd is not None:
        rows = [r for r in rows
                if abs(float(r["config/init_lambd"]) - init_lambd) < 1e-6]

    lines = ["Trainable & True & False \\\\"]
    for model_name in model_names:
        dm = [r for r in rows if r["config/model_name"] == model_name]
        if not dm:
            continue
        dtr, dfx = _split(dm)
        lines.append(
            "{} & ${:.2f} \\pm {:.2f}$ & ${:.2f} \\pm {:.2f}$ \\\\".format(
                get_model_title(model_name),
                _mean(dtr, "test_accuracy"), _std(dtr, "test_accuracy"),
                _mean(dfx, "test_accuracy"), _std(dfx, "test_accuracy")))
    table = "\n".join(lines)
    print(table)
    return table


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Produce LaTeX tables.")
    parser.add_argument("--results_dir", required=True, type=str)
    args = parser.parse_args(argv)
    for name in ("esc50", "audio_mnist"):
        path = os.path.join(args.results_dir, name)
        if os.path.exists(os.path.join(path, f"{name}.csv")):
            print(name.upper())
            produce_table_1(path, name)
            print()
    tf_path = os.path.join(args.results_dir, "time_frequency")
    if os.path.exists(os.path.join(tf_path, "time_frequency.csv")):
        print("time-frequency")
        produce_table_2(tf_path)


if __name__ == "__main__":
    main()
