"""The port's figures against dmel_tpu's, on the CPU.

The figures are captured by patching ``plt.close`` (both packages close
each figure they save) and compared by structure, never by pixels:

- ``data_example_spectrograms(device="cpu")`` against dmel_tpu's
  ``spectrogram`` on the same clips (1e-4 of the largest entry), and the
  3 x 3 figure's images, titles, labels and ticks;
- the accuracy figure of the tracked sweeps ``results/time_frequency``,
  ``esc50_synth``, ``audio_mnist`` and ``esc50``, valid and test split
  (the sweep's ``{dataset}.csv``): titles, axis labels, row 0's
  y-limits (every axis's where each point is one trial, so seaborn's
  band has zero width), legend titles, texts and places, each line's
  points (within 1e-12 of seaborn's, hue by hue) and colours, and the
  dashed sigma_ref line;
- ``produce_complexity_plot``'s four curves and its labels;
- ``main`` writing its two files;
- ``import dmel_tpu_torch`` with matplotlib, pandas and seaborn absent,
  and the figures drawn with pandas and seaborn absent.

The sweeps' csv files are copied under ``tmp_path`` first, so nothing is
written under ``results/``.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from dmel_tpu.data.synthetic import \
    make_gauss_pulse_dataset as jax_gauss_pulse  # noqa: E402
from dmel_tpu.eval import complexity as jcomplexity  # noqa: E402
from dmel_tpu.eval import figures as jfigures  # noqa: E402
from dmel_tpu.ops import spectrogram as jax_spectrogram  # noqa: E402
from dmel_tpu.utils import plot as jplot  # noqa: E402
from dmel_tpu_torch.eval import complexity as tcomplexity  # noqa: E402
from dmel_tpu_torch.eval import figures as tfigures  # noqa: E402
from dmel_tpu_torch.experiments.runner import read_rows  # noqa: E402
from dmel_tpu_torch.utils import plot as tplot  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")
SWEEPS = ["time_frequency", "esc50_synth", "audio_mnist", "esc50"]
#: spectrograms: max |error| over the largest entry
SPEC_GATE = 1e-4
#: plotted points: max |error| against seaborn's
POINT_GATE = 1e-12


@pytest.fixture
def captured(monkeypatch):
    """The figures the modules under test close, in order."""
    figs = []
    real_close = plt.close
    for mod in (jfigures.plt, plt):
        monkeypatch.setattr(mod, "close", figs.append)
    yield figs
    for fig in figs:
        real_close(fig)


def _sweep_copy(tmp_path, name):
    """A folder under ``tmp_path`` holding the tracked sweep's
    ``results.csv`` and ``{name}.csv``."""
    out = tmp_path / name
    out.mkdir()
    for f in ("results.csv", f"{name}.csv"):
        shutil.copy(os.path.join(RESULTS, name, f), out)
    return str(out)


def test_data_example_spectrograms_match_jax():
    got = tfigures.data_example_spectrograms(device="cpu")
    ds = jax_gauss_pulse(sigma=6.38, n_points=128, noise_std=0.0,
                         n_samples=64, demo=True, seed=0)
    want = np.zeros_like(got)
    for cls in range(3):
        x = jnp.asarray(ds.xs[int(np.nonzero(ds.ys == cls)[0][0])])
        for col, scale in enumerate(tfigures.SCALES):
            want[cls, col] = np.asarray(jax_spectrogram(
                x - x.mean(), 6.38 * scale, hop_length=1))
    assert got.shape == (3, 3, 129, 129)
    assert np.isfinite(got).all()
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    assert err <= SPEC_GATE, err


def test_plot_spectrogram_matches_jax():
    s = np.random.default_rng(0).random((9, 7)).astype(np.float32)
    figs = [plt.subplots()[1] for _ in range(3)]
    jplot.plot_spectrogram(s, figs[0])
    tplot.plot_spectrogram(s, figs[1])
    tplot.plot_spectrogram(torch.from_numpy(s), figs[2],
                           decorate_axes=True)
    want = figs[0]
    for ax in figs[1:]:
        np.testing.assert_array_equal(ax.images[0].get_array(),
                                      want.images[0].get_array())
        assert list(ax.get_yticks()) == list(want.get_yticks())
        assert ([t.get_text() for t in ax.get_yticklabels()]
                == [t.get_text() for t in want.get_yticklabels()])
        assert (ax.get_xlabel(), ax.get_ylabel()) == (
            want.get_xlabel(), want.get_ylabel()) == (
                "time", "normalized frequency")
    plt.close("all")


def _labels(ax):
    return ax.get_title(), ax.get_xlabel(), ax.get_ylabel()


def test_data_example_plot_matches_jax(tmp_path, captured):
    tfigures.produce_data_example_plot(str(tmp_path / "port.png"),
                                       device="cpu")
    jfigures.produce_data_example_plot(str(tmp_path / "jax.png"))
    got, want = captured
    assert (tmp_path / "port.png").is_file()
    assert len(got.axes) == len(want.axes) == 9
    for a, b in zip(got.axes, want.axes):
        assert _labels(a) == _labels(b)
        img, ref = a.images[0].get_array(), b.images[0].get_array()
        assert img.shape == ref.shape == (129, 129)
        err = float(np.max(np.abs(img - ref)) / np.max(np.abs(ref)))
        assert err <= SPEC_GATE, err
        assert list(a.get_yticks()) == list(b.get_yticks())
    assert got.axes[0].get_title() == r"$\lambda = 6.4$"


def _data_lines(ax):
    """The curves: lines with points and markers (seaborn's legend
    proxies have no points)."""
    return [ln for ln in ax.lines
            if len(ln.get_xydata()) and ln.get_marker() == "o"]


def _sigma_lines(ax):
    return [ln for ln in ax.lines if ln.get_label() == r"$\sigma_{ref}$"]


def _legend(ax):
    leg = ax.get_legend()
    return (leg.get_title().get_text(), [t.get_text() for t in
                                         leg.get_texts()], leg._loc)


def _one_trial_per_point(rows):
    keys = [(r["config/model_name"], str(r["config/trainable"]),
             float(r["config/init_lambd"])) for r in rows]
    return len(keys) == len(set(keys))


@pytest.mark.parametrize("split", ["valid", "test"])
@pytest.mark.parametrize("name", SWEEPS)
def test_accuracy_plot_matches_jax(tmp_path, captured, name, split):
    sweep = _sweep_copy(tmp_path, name)
    tfigures.produce_accuracy_plot(sweep, str(tmp_path / "port.pdf"),
                                   split=split)
    jfigures.produce_accuracy_plot(sweep, str(tmp_path / "jax.pdf"),
                                   split=split)
    got, want = captured
    assert (tmp_path / "port.pdf").is_file()
    assert sorted(os.listdir(sweep)) == sorted(["results.csv",
                                                f"{name}.csv"])
    n = len(want.axes) // 2
    assert len(got.axes) == len(want.axes) and n >= 1
    same_limits = _one_trial_per_point(read_rows(
        os.path.join(sweep, f"{name}.csv" if split == "test"
                     else "results.csv")))
    for i, (a, b) in enumerate(zip(got.axes, want.axes)):
        assert _labels(a) == _labels(b), i
        if (i < n and name in tfigures.ACC_BANDS) or same_limits:
            assert a.get_ylim() == pytest.approx(b.get_ylim(), abs=1e-12), i
        assert _legend(a) == _legend(b), i
        lines, ref = _data_lines(a), _data_lines(b)
        assert len(lines) == len(ref) == 2, i
        for ln, rf in zip(lines, ref):
            xy, want_xy = ln.get_xydata(), rf.get_xydata()
            assert xy.shape == want_xy.shape
            assert float(np.max(np.abs(xy - want_xy))) <= POINT_GATE, i
            assert matplotlib.colors.to_rgb(ln.get_color()) == \
                pytest.approx(matplotlib.colors.to_rgb(rf.get_color()))
        sig, sig_ref = _sigma_lines(a), _sigma_lines(b)
        assert len(sig) == len(sig_ref), i
        for ln, rf in zip(sig, sig_ref):
            # pandas parses the csv's floats to within an ulp of Python
            assert float(np.max(np.abs(ln.get_xydata() - rf.get_xydata()))
                         ) <= POINT_GATE, i
            assert (ln.get_linestyle(), ln.get_color()) == (
                rf.get_linestyle(), rf.get_color()) == ("--", "purple")
    assert bool(_sigma_lines(got.axes[n])) == (
        name in ("time_frequency", "esc50_synth"))


def test_accuracy_curves_time_frequency():
    rows = read_rows(os.path.join(RESULTS, "time_frequency",
                                  "results.csv"))
    c = tfigures.accuracy_curves(rows, "time_frequency")
    assert c["models"] == ["linear_net"] and c["titles"] == ["LinearNet"]
    assert (c["ycol"], c["lcol"]) == ("best_valid_acc", "best_lambd_est")
    assert c["band"] == (0.95, 1.00) and c["sigma_ref"] == 6.38
    acc = c["curves"]["linear_net"]["best_valid_acc"]
    assert list(acc) == ["True", "False"]
    np.testing.assert_array_equal(acc["True"][0], [1.276, 6.38, 31.9])
    assert acc["True"][1][0] == 0.990234375
    test = tfigures.accuracy_curves(
        read_rows(os.path.join(RESULTS, "time_frequency",
                               "time_frequency.csv")),
        "time_frequency", split="test")
    assert (test["ycol"], test["ylabel"]) == ("test_accuracy",
                                              "Test accuracy")


def test_accuracy_plot_default_path(tmp_path, captured):
    sweep = _sweep_copy(tmp_path, "audio_mnist")
    out = tfigures.produce_accuracy_plot(sweep, split="test")
    assert out == os.path.join(sweep, "test_audio_mnist.pdf")
    assert os.path.isfile(out)


def test_complexity_plot_matches_jax(tmp_path, captured):
    tcomplexity.produce_complexity_plot(str(tmp_path / "port.png"))
    jcomplexity.produce_complexity_plot(str(tmp_path / "jax.png"))
    got, want = captured
    assert (tmp_path / "port.png").is_file()
    assert len(got.axes) == len(want.axes) == 2
    curves = 0
    for a, b in zip(got.axes, want.axes):
        assert _labels(a) == _labels(b)
        assert a.get_ylim() == b.get_ylim() == (0.0, 2.0)
        assert ([t.get_text() for t in a.get_legend().get_texts()]
                == [t.get_text() for t in b.get_legend().get_texts()])
        assert len(a.lines) == len(b.lines) == 3
        for ln, rf in zip(a.lines, b.lines):
            assert ln.get_label() == rf.get_label()
            np.testing.assert_array_equal(ln.get_xydata(), rf.get_xydata())
        curves += 2
    assert curves == 4


def test_main_writes_two_files(tmp_path, captured):
    sweep = _sweep_copy(tmp_path, "time_frequency")
    out = tmp_path / "figs"
    tfigures.main(["--sweep_dir", sweep, "--out_dir", str(out),
                   "--split", "test", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["accuracy.png", "data_example.png"]
    assert len(captured) == 2
    assert captured[1].axes[0].get_ylabel() == "Test accuracy"


def _run(code):
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_imports_and_data_without_matplotlib():
    out = _run(f"""
        import sys
        for m in ("matplotlib", "pandas", "seaborn", "jax"):
            sys.modules[m] = None
        import dmel_tpu_torch, dmel_tpu_torch.eval, dmel_tpu_torch.utils
        from dmel_tpu_torch.eval import figures
        from dmel_tpu_torch.experiments.runner import load_results
        s = figures.data_example_spectrograms(device="cpu")
        c = figures.accuracy_curves(
            load_results({os.path.join(RESULTS, "esc50")!r}), "esc50")
        print(s.shape, c["models"])
        """)
    assert out.split() == ["(3,", "3,", "129,", "129)", "['panns_cnn6']"]


def test_figures_drawn_without_pandas_or_seaborn(tmp_path):
    sweep = _sweep_copy(tmp_path, "esc50_synth")
    _run(f"""
        import sys
        for m in ("pandas", "seaborn", "jax"):
            sys.modules[m] = None
        from dmel_tpu_torch.eval import (produce_accuracy_plot,
                                         produce_complexity_plot,
                                         produce_data_example_plot)
        produce_accuracy_plot({sweep!r}, {str(tmp_path / "a.pdf")!r})
        produce_data_example_plot({str(tmp_path / "d.png")!r},
                                  device="cpu")
        produce_complexity_plot({str(tmp_path / "c.png")!r})
        """)
    assert all((tmp_path / f).is_file() for f in ("a.pdf", "d.png",
                                                  "c.png"))
