"""The port's tables, complexity model and a time_frequency sweep from
its CLI, against dmel_tpu's, on the CPU.

- ``produce_table_1`` (AudioMNIST, ESC-50), ``produce_table_2``
  (time_frequency), ``produce_result_table`` and ``main`` on the tracked
  ``results/*/`` csv files, and on a hand-made one with an empty group,
  a group of one and a missing accuracy: the strings equal dmel_tpu's,
  character for character (dmel_tpu computes them with pandas);
- ``cost_ratio`` within 1e-12;
- ``cli.main --name time_frequency`` on the space shrunk to 120 clips of
  64 samples: its ``results.csv`` columns equal those of dmel_tpu's
  ``run_sweep`` on the same space; then ``predict_test`` and
  ``tables.main`` run on the port's sweep.
"""

import contextlib
import csv
import io
import os

import numpy as np
import pytest

from dmel_tpu.eval import complexity as jcomplexity
from dmel_tpu.eval import tables as jtables
from dmel_tpu.experiments import runner as jrunner
from dmel_tpu_torch.eval import cost_ratio, predict_test
from dmel_tpu_torch.eval import tables as ttables
from dmel_tpu_torch.experiments import cli as tcli
from dmel_tpu_torch.experiments import configs as tconfigs
from dmel_tpu_torch.experiments import runner as trunner
from tests.test_experiments import tiny_space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")


def _quiet(fn, *args, **kwargs):
    """``fn``'s return value and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _both(name, *args, **kwargs):
    got, got_out = _quiet(getattr(ttables, name), *args, **kwargs)
    want, want_out = _quiet(getattr(jtables, name), *args, **kwargs)
    return got, want, got_out, want_out


@pytest.mark.parametrize("dataset,fn,kwargs", [
    ("audio_mnist", "produce_table_1", {}),
    ("esc50", "produce_table_1", {}),
    ("esc50", "produce_table_1", dict(model_title="CNN6")),
    ("time_frequency", "produce_table_2", {}),
    ("audio_mnist", "produce_result_table", {}),
    ("audio_mnist", "produce_result_table", dict(init_lambd=8000 * 0.035
                                                 / 6)),
    ("esc50", "produce_result_table", {}),
    ("time_frequency", "produce_result_table", {})])
def test_tables_match_jax(dataset, fn, kwargs):
    got, want, got_out, want_out = _both(
        fn, os.path.join(RESULTS, dataset), dataset, **kwargs)
    assert got == want
    assert got_out == want_out == want + "\n"


def test_table_1_shape():
    table = _quiet(ttables.produce_table_1,
                   os.path.join(RESULTS, "audio_mnist"), "audio_mnist")[0]
    lines = table.split("\n")
    assert len(lines) == 2 + 3 * 3
    assert lines[2].startswith("LNet & 10 ms & (")
    assert lines[3].startswith("LNet & 10 ms & 10 ms & baseline & $")


def test_main_matches_jax():
    _, got = _quiet(ttables.main, ["--results_dir", RESULTS])
    _, want = _quiet(jtables.main, ["--results_dir", RESULTS])
    assert got == want
    assert got.startswith("ESC50\n") and "AUDIO_MNIST\n" in got
    assert "time-frequency\n" in got


def _write(path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def test_edge_cases_match_jax(tmp_path):
    """A 10 ms group with one trainable trial of no accuracy (a diverged
    trial) and two fixed ones, a 35 ms group of one trial each, no 300 ms
    trial; DSPEC rows at two of the three lambdas: ``nan`` and ``-``
    where pandas gives them."""
    rows = []
    for lam, trainable, acc, est in (
            (13.333333333333334, True, "", 20.0),
            (13.333333333333334, True, 0.5, 30.0),
            (13.333333333333334, False, 0.25, 13.3),
            (13.333333333333334, False, 0.75, 13.3),
            (46.666666666666664, True, 0.6, 50.0),
            (46.666666666666664, False, 0.4, 46.7)):
        rows.append({"best_lambd_est": est, "test_accuracy": acc,
                     "config/model_name": "mel_linear_net",
                     "config/dataset_name": "audio_mnist",
                     "config/trainable": trainable,
                     "config/init_lambd": lam})
    _write(tmp_path / "audio_mnist.csv", rows)
    got, want, _, _ = _both("produce_table_1", str(tmp_path), "audio_mnist")
    assert got == want
    assert "(-, -) ms" in got and "\\pm nan" in got
    got, want, _, _ = _both("produce_result_table", str(tmp_path),
                            "audio_mnist")
    assert got == want

    tf_rows = [dict(r, **{"config/init_lambd": lam, "config/model_name":
                          "linear_net", "config/dataset_name":
                          "time_frequency"})
               for r, lam in zip(rows, (1.276, 1.276, 1.276, 6.38, 6.38,
                                        6.38))]
    _write(tmp_path / "time_frequency.csv", tf_rows)
    got, want, _, _ = _both("produce_table_2", str(tmp_path))
    assert got == want
    assert "(nan, nan)" in got


def test_model_titles_match_jax():
    assert ttables.MODEL_TITLES == jtables.MODEL_TITLES
    assert ttables.get_model_title("panns_cnn6") == "PANNs CNN6"
    with pytest.raises(ValueError):
        ttables.get_model_title("resnet")


@pytest.mark.parametrize("c1", [0.0001, 0.5, 0.9999])
@pytest.mark.parametrize("init_mi", [0.01, 0.02, 0.3])
def test_cost_ratio_matches_jax(c1, init_mi):
    ds = np.arange(1, 60)
    got = cost_ratio(ds, c1, init_mi)
    want = jcomplexity.cost_ratio(ds, c1, init_mi)
    assert got.shape == (59,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _port_tiny_space(max_epochs=1):
    """dmel_tpu's tiny time_frequency space with the port's grid axes."""
    return {k: (tconfigs.grid_search(v.values)
                if type(v).__name__ == "grid_search" else v)
            for k, v in tiny_space(max_epochs).items()}


def test_time_frequency_sweep_from_the_cli(tmp_path, monkeypatch):
    """The published time_frequency space, shrunk (120 clips of 64
    samples, lambda 1.276 and 6.38, trainable or not, one epoch), through
    the port's CLI and dmel_tpu's ``run_sweep``: the same results.csv
    columns; then the port's ``predict_test`` (four rows of 24 test
    predictions) and ``tables.main`` (Table 2, equal to dmel_tpu's
    table of the port's csv)."""
    monkeypatch.setitem(tconfigs.SEARCH_SPACES, "time_frequency",
                        _port_tiny_space)
    out, data = str(tmp_path / "out"), str(tmp_path / "data")
    tcli.main(["--name", "time_frequency", "--num_samples", "1",
               "--max_epochs", "1", "--output_dir", out,
               "--data_dir", data, "--verbose", "0", "--device", "cpu"])
    jsweep = _quiet(jrunner.run_sweep, "time_frequency", 1, 1,
                    str(tmp_path / "jax"), data, space=tiny_space(1))[0]
    tsweep = os.path.join(out, "time_frequency")

    def header(sweep):
        with open(os.path.join(sweep, "results.csv"), newline="") as f:
            return next(csv.reader(f))

    assert header(tsweep) == header(jsweep)
    rows = trunner.load_results(tsweep)
    assert [r["config/model_name"] for r in rows] == ["linear_net"] * 4

    scored = predict_test(tsweep, data, verbose=0, device="cpu")
    preds = np.load(os.path.join(tsweep, "time_frequency_predictionss.npy"))
    assert preds.shape == (4, 24)
    assert all(0.0 <= r["test_accuracy"] <= 1.0 for r in scored)
    _, got = _quiet(ttables.main, ["--results_dir", out])
    _, want = _quiet(jtables.main, ["--results_dir", out])
    assert got == want and got.startswith("time-frequency\n")
    assert got.count("DSPEC") == 3
