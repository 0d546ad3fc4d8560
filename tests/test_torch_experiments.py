"""The port's experiment layer against dmel_tpu's, on the CPU: the
search spaces, the sweep runner's layout and its CSV round trip, the
manifest skip, the CLI's flags and ``predict_test`` on a port sweep.

dmel_tpu runs its sweep on ``tests/test_experiments.py``'s
``tiny_space`` (a linear probe on Gauss pulses, which the port does not
have yet); the port runs the same 2 x 2 grid shape on esc50_synth with
bf16 CNN6 at full widths on 4096-sample clips.  Layouts, file names,
the ``config.json`` round trip and the ``results.csv`` columns other
than the config's must agree.
"""

import csv
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from dmel_tpu import experiments as jexperiments
from dmel_tpu.experiments import cli as jcli
from dmel_tpu.experiments import runner as jrunner
from dmel_tpu_torch import experiments as texperiments
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.eval import predict_test
from dmel_tpu_torch.experiments import cli as tcli
from dmel_tpu_torch.experiments import configs as tconfigs
from dmel_tpu_torch.experiments import runner as trunner
from dmel_tpu_torch.parallel import mesh as tmesh
from dmel_tpu_torch.training import load_checkpoint

from tests.test_experiments import tiny_space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_space(max_epochs=1):
    """The port's tiny sweep: esc50_synth's space cut to 12 clips of
    4096 samples and one epoch, over a 2 x 2 grid (trainable, and lambda
    on the specband and framed routes)."""
    space = texperiments.get_search_space("esc50_synth", max_epochs)
    space.update(n_points=4096, n_samples=12, batch_size=4,
                 init_lambd=texperiments.grid_search([128.0, 46.7]))
    return space


# --- search spaces -----------------------------------------------------

def _plain(space):
    return {k: (("grid", v.values) if type(v).__name__ == "grid_search"
                else v) for k, v in space.items()}


@pytest.mark.parametrize("name", ["esc50", "audio_mnist", "time_frequency",
                                  "fsd", "esc50_synth"])
def test_spaces_match_jax(name):
    """Every published space, key for key and grid for grid, and its
    expansion in the same order."""
    got = texperiments.get_search_space(name, 7)
    want = jexperiments.get_search_space(name, 7)
    assert list(got) == list(want)
    assert _plain(got) == _plain(want)
    assert texperiments.expand_grid(got) == jexperiments.expand_grid(want)


def test_space_dispatch_matches_jax():
    from dmel_tpu.experiments import configs as jconfigs
    assert list(tconfigs.SEARCH_SPACES) == list(jconfigs.SEARCH_SPACES)
    for name in ("my_esc50_run", "esc50_synth_hard", "fsd_x",
                 "tf_time_frequency"):
        assert (texperiments.get_search_space(name, 3)["dataset_name"]
                == jexperiments.get_search_space(name, 3)["dataset_name"])
    with pytest.raises(ValueError):
        texperiments.get_search_space("unknown", 5)


# --- the sweep ---------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """dmel_tpu's sweep of ``tiny_space`` and the port's of
    :func:`port_space`, each run once."""
    out = tmp_path_factory.mktemp("sweeps")
    jsweep = jrunner.run_sweep("tiny", num_samples=1, max_epochs=1,
                               output_dir=str(out / "jax"),
                               data_dir="/nonexistent", space=tiny_space())
    tsweep = trunner.run_sweep("tiny", num_samples=1, max_epochs=1,
                               output_dir=str(out / "torch"),
                               data_dir="/nonexistent", space=port_space(),
                               device="cpu")
    return jsweep, tsweep


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out += [os.path.normpath(os.path.join(rel, f)) for f in files]
    return sorted(out)


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_sweep_layout_matches_jax(sweeps):
    """The same files in the sweep and in every trial (config.json,
    progress.csv, result.json, the best model and its sidecar; no live
    state), the manifest marking every trial done."""
    jsweep, tsweep = sweeps
    assert _tree(tsweep) == _tree(jsweep)
    assert "trial_00003/checkpoint_000000/best_model.meta.json" in _tree(
        tsweep)
    for sweep in (jsweep, tsweep):
        with open(os.path.join(sweep, "manifest.json")) as f:
            assert json.load(f) == {f"trial_{i:05d}": "done"
                                    for i in range(4)}


def test_config_json_round_trips(sweeps):
    """Each trial's config.json is its grid point plus ``trial_repeat``,
    in both packages."""
    jsweep, tsweep = sweeps
    for sweep, grid in (
            (jsweep, jexperiments.expand_grid(tiny_space())),
            (tsweep, texperiments.expand_grid(port_space()))):
        for i, cfg in enumerate(grid):
            with open(os.path.join(sweep, f"trial_{i:05d}",
                                   "config.json")) as f:
                assert json.load(f) == dict(cfg, trial_repeat=0)


def test_results_columns_match_jax(sweeps):
    """results.csv and progress.csv: the metric columns of dmel_tpu's,
    in its order, then ``config/<key>`` for every config key (and
    ``logdir`` last in results.csv)."""
    jsweep, tsweep = sweeps
    jcols = _header(os.path.join(jsweep, "results.csv"))
    tcols = _header(os.path.join(tsweep, "results.csv"))
    metrics = [c for c in jcols if not c.startswith("config/")]
    assert [c for c in tcols if not c.startswith("config/")] == metrics
    assert metrics[-1] == "logdir"
    config = texperiments.expand_grid(port_space())[0]
    want = ["config/" + k for k in list(config) + ["trial_repeat"]]
    assert [c for c in tcols if c.startswith("config/")] == want
    jprog = _header(os.path.join(jsweep, "trial_00000", "progress.csv"))
    tprog = _header(os.path.join(tsweep, "trial_00000", "progress.csv"))
    assert ([c for c in tprog if not c.startswith("config/")]
            == [c for c in jprog if not c.startswith("config/")])
    rows = trunner.load_results(tsweep)
    assert len(rows) == 4
    assert [r["config/init_lambd"] for r in rows] == [128.0, 46.7] * 2
    assert [r["config/trainable"] for r in rows] == [True, True, False,
                                                     False]
    assert trunner.get_config_by_row(rows[0])["dataset_name"] == "esc50_synth"


def test_load_results_reads_what_pandas_reads():
    """The port's ``load_results`` on the JAX sweeps' own results.csv
    gives every cell the type and value dmel_tpu's pandas
    ``load_results`` gives it; floats to within relative 1e-14 (pandas'
    default parser can miss the last few bits; the port's floats are
    the written decimals read exactly)."""
    for sweep in ("esc50_synth", "esc50_synth_hard"):
        path = os.path.join(ROOT, "results", sweep)
        got = trunner.load_results(path)
        want = jrunner.load_results(path).to_dict("records")
        with open(os.path.join(path, "results.csv"), newline="") as f:
            raw = list(csv.DictReader(f))
        assert len(got) == len(want) == len(raw)
        for g, w, text in zip(got, want, raw):
            assert list(g) == list(w)
            for k, v in w.items():
                if isinstance(v, float) and np.isnan(v):
                    assert g[k] is None, k
                elif isinstance(v, float):
                    assert type(g[k]) is float and g[k] == float(text[k]), k
                    assert abs(g[k] - v) <= 1e-14 * abs(v), k
                else:
                    assert g[k] == v and type(g[k]) is type(
                        v.item() if hasattr(v, "item") else v), k


def test_resume_skips_finished(sweeps, capsys):
    """A second run skips all four trials and keeps their results; with
    ``resume=False`` it runs them again."""
    _, tsweep = sweeps
    before = os.path.getmtime(os.path.join(tsweep, "trial_00000",
                                           "result.json"))
    trunner.run_sweep("tiny", num_samples=1, max_epochs=1,
                      output_dir=os.path.dirname(tsweep),
                      data_dir="/nonexistent", space=port_space(),
                      verbose=1, device="cpu")
    assert capsys.readouterr().out.count("skip finished") == 4
    assert os.path.getmtime(os.path.join(tsweep, "trial_00000",
                                         "result.json")) == before


def test_run_trial_resumes_its_live_state(tmp_path):
    """``run_trial`` resumes a live state left by a killed run, and
    ``fresh=True`` (``--no_resume``) discards it."""
    config = dict(texperiments.expand_grid(port_space(2))[0],
                  trial_repeat=0)
    trial = tmp_path / "trial_00000"
    _, ref = trunner.run_trial(config, "/nonexistent", str(trial),
                               device="cpu")
    live = trial / "checkpoint_000000" / "live_state"
    assert not live.exists()
    # plant a live state at epoch 0 of a finished copy: the next run
    # resumes from it and reruns epoch 1 only
    copy = tmp_path / "copy"
    shutil.copytree(trial, copy)
    import torch
    from dmel_tpu_torch.training import fit
    trainset, validset, _ = get_dataset_by_config(config)
    state, hist = fit(dict(config, max_epochs=1), trainset, validset,
                      device="cpu")
    torch.save({"model": state["model"].state_dict(),
                "optimizer": state["optimizer"].state_dict(),
                "generator": torch.Generator().manual_seed(0).get_state(),
                "meta": dict(epoch=0, patience_count=0,
                             best_valid_acc=hist["best_valid_acc"],
                             best_valid_loss=hist["best_valid_loss"],
                             best_lambd_est=hist["records"][0][
                                 "best_lambd_est"],
                             records=hist["records"])},
               copy / "checkpoint_000000" / "live_state")
    _, resumed = trunner.run_trial(config, "/nonexistent", str(copy),
                                   device="cpu")
    assert resumed["records"][0] == ref["records"][0]
    assert len(resumed["records"]) == 2
    assert not (copy / "checkpoint_000000" / "live_state").exists()
    # a live state without the loop's bookkeeping cannot be resumed ...
    shutil.copy(copy / "checkpoint_000000" / "best_model",
                copy / "checkpoint_000000" / "live_state")
    with pytest.raises(KeyError):
        trunner.run_trial(config, "/nonexistent", str(copy), device="cpu")
    # ... and fresh=True discards it
    _, fresh = trunner.run_trial(config, "/nonexistent", str(copy),
                                 device="cpu", fresh=True)
    assert fresh["records"] == ref["records"]


def test_predict_test_on_port_sweep(sweeps, tmp_path):
    """``predict_test`` over the port's sweep: accuracies in [0, 1], the
    prediction and label stacks of shape (4, n_test), the per-dataset
    CSV; a trial without a checkpoint gets NaN and an empty row."""
    _, tsweep = sweeps
    rows = predict_test(tsweep, "/nonexistent", verbose=0, device="cpu")
    _, _, testset = get_dataset_by_config(port_space())
    n_test = len(testset)
    preds = np.load(os.path.join(tsweep, "esc50_synth_predictionss.npy"))
    labels = np.load(os.path.join(tsweep, "esc50_synth_labelss.npy"))
    assert preds.shape == labels.shape == (4, n_test)
    assert all(0.0 <= r["test_accuracy"] <= 1.0 for r in rows)
    assert "test_mAP" not in rows[0]
    for i, r in enumerate(rows):
        assert r["test_accuracy"] == float(np.mean(preds[i] == labels[i]))
    header = _header(os.path.join(tsweep, "esc50_synth.csv"))
    assert header[-1] == "test_accuracy"

    sweep = str(tmp_path / "sweep")
    shutil.copytree(tsweep, sweep)
    rows = trunner.load_results(sweep)
    for r in rows:
        r["logdir"] = os.path.join(sweep, os.path.basename(r["logdir"]))
    trunner._write_csv(os.path.join(sweep, "results.csv"), rows)
    shutil.rmtree(os.path.join(sweep, "trial_00000", "checkpoint_000000"))
    out = predict_test(sweep, "/nonexistent", verbose=0, device="cpu")
    assert np.isnan(out[0]["test_accuracy"])
    assert np.isfinite([r["test_accuracy"] for r in out[1:]]).all()
    ragged = np.load(os.path.join(sweep, "esc50_synth_predictionss.npy"),
                     allow_pickle=True)
    assert ragged[0].size == 0 and ragged[1].size == n_test


def test_best_checkpoint_holds_model_and_optimizer(sweeps):
    _, tsweep = sweeps
    ckpt = load_checkpoint(os.path.join(tsweep, "trial_00000",
                                        "checkpoint_000000", "best_model"))
    assert sorted(ckpt) == ["model", "optimizer"]
    assert "spectrogram_model.conv_block1.bn1.running_var" in ckpt["model"]
    assert len(ckpt["optimizer"]["param_groups"]) == 2


# --- the CLI -----------------------------------------------------------

def _flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"--\w+", capsys.readouterr().out))


def test_cli_flags_match_jax(capsys):
    """Every flag of dmel_tpu's CLI, and ``--device`` besides."""
    want = _flags(jcli.main, capsys)
    assert _flags(tcli.main, capsys) == want | {"--device"}


def test_cli_refuses_pack(tmp_path, monkeypatch):
    """``--pack`` runs on the card: without one, and without ``--device
    cpu``, it raises before it builds anything; so does a ``mesh`` whose
    ranks do not split the grid's six trials (``ValueError``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--name", "esc50_synth", "--num_samples", "1",
                   "--max_epochs", "1", "--output_dir", str(tmp_path),
                   "--data_dir", "/nonexistent", "--pack"])
    with pytest.raises(ValueError, match="6 trials do not split over 4"):
        trunner.run_sweep_packed("esc50_synth", 1, 1, str(tmp_path),
                                 "/nonexistent", mesh=tmesh.Mesh(
                                     ("data",), 0, 4, torch.device("cpu")),
                                 device="cpu")
    assert not os.listdir(tmp_path)


def test_cli_runs_sweep(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(tconfigs.SEARCH_SPACES, "tiny",
                        lambda me: dict(port_space(me), trainable=False,
                                        init_lambd=128.0))
    tcli.main(["--name", "tiny", "--num_samples", "1", "--max_epochs", "1",
               "--output_dir", str(tmp_path), "--data_dir", "/nonexistent",
               "--verbose", "0", "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith(
        os.path.join(str(tmp_path), "tiny"))
    rows = trunner.load_results(str(tmp_path / "tiny"))
    assert len(rows) == 1 and rows[0]["config/model_dtype"] == "bfloat16"
