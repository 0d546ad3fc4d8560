"""The port's checkpoints, resume, per-step bucket re-selection and
``training.predict``, on the CPU, against dmel_tpu where both packages
can run the same thing.

``fit`` runs MelPANNsNet at the published CNN6 widths on short clips.
The kill-and-resume test runs in bf16, the esc50_synth space's
``model_dtype``, with dropout on, so that it holds the dropout
generator's state as well as the weights, the optimizer, the batch-norm
statistics and the loader's shuffle stream.
"""

import csv
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from dmel_tpu.data.audio import ArrayDataset
from dmel_tpu.data.loader import BatchLoader as JBatchLoader
from dmel_tpu.training import checkpoint as jckpt
from dmel_tpu.training import train as jtrain
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch.data import BatchLoader, get_dataset_by_config
from dmel_tpu_torch.eval import predict as predict_arrays
from dmel_tpu_torch.models import layers as tlayers
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.training import (fit, load_checkpoint, predict,
                                     save_checkpoint)
from dmel_tpu_torch.training import train as ttrain

#: esc50_synth at 4096 samples (window 1024, the specband route at
#: lambda 128), bf16, three epochs of 3 steps
FIT_CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                  init_lambd=128.0, n_points=4096, hop_length=80,
                  optimized=True, normalize_window=False, n_mels=64,
                  resample_rate=8000, energy_normalize=True, impl="pallas",
                  model_dtype="bfloat16", optimizer_name="adam",
                  lr_model=1e-4, lr_tf=1.0, trainable=True, batch_size=4,
                  max_epochs=3, patience=100, n_samples=16, data_seed=0,
                  sigma_ref=8000 * 0.035 / 6, noise_std=0.05)


class _Arrays:
    def __init__(self, xs, ys):
        self.xs, self.ys = xs, ys

    def __len__(self):
        return len(self.xs)


class Kill(Exception):
    pass


# --- the loader -------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_set_epoch_matches_jax(shuffle, epoch):
    """After ``set_epoch(epoch)`` (then once more, backwards, which
    changes nothing) the next two epochs' batches equal dmel_tpu's
    loader's, bit for bit."""
    rng = np.random.default_rng(epoch)
    data = _Arrays(rng.standard_normal((23, 3)).astype(np.float32),
                   rng.integers(0, 10, 23).astype(np.int32))
    got = BatchLoader(data, 5, shuffle=shuffle, seed=7)
    want = JBatchLoader(data, 5, shuffle=shuffle, seed=7)
    for loader in (got, want):
        loader.set_epoch(epoch)
        loader.set_epoch(0)
    for _ in range(2):
        for (xs, ys, m), (wxs, wys, wm) in zip(got, want, strict=True):
            np.testing.assert_array_equal(xs, wxs)
            np.testing.assert_array_equal(ys, wys)
            np.testing.assert_array_equal(m, wm)
    assert got._epoch == want._epoch == epoch + 2


# --- checkpoints ------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """A model and an Adam state written and read back: every tensor
    equal, nothing left beside the file, no pickled objects needed."""
    model = tmodels.get_model_by_config(FIT_CONFIG, 1024, device="cpu",
                                        seed=2)
    opt = torch.optim.Adam(model.parameters())
    model.spectrogram_model.fc_esc50.weight.grad = torch.ones(10, 512)
    opt.step()
    path = tmp_path / "sub" / "best_model"
    save_checkpoint(str(path), {"model": model.state_dict(),
                                "optimizer": opt.state_dict(),
                                "meta": {"epoch": 3, "hint": None}})
    assert sorted(os.listdir(tmp_path / "sub")) == ["best_model"]
    back = load_checkpoint(str(path))
    sd = model.state_dict()
    assert sorted(back["model"]) == sorted(sd)
    assert all(torch.equal(back["model"][k], v) for k, v in sd.items())
    assert back["meta"] == {"epoch": 3, "hint": None}
    opt2 = torch.optim.Adam(model.parameters())
    opt2.load_state_dict(back["optimizer"])
    state = opt2.state_dict()["state"]
    for i, s in opt.state_dict()["state"].items():
        assert all(torch.equal(s[k], state[i][k]) for k in s)


# --- the best model and its sidecar against dmel_tpu -------------------

#: a config both packages train quickly on the CPU: CNN6 over 16 mels of
#: 2048-sample clips, lambda moving fast enough to change bucket
SIDECAR_CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                      init_lambd=80.0, n_points=2048, hop_length=32,
                      optimized=True, normalize_window=False, n_mels=16,
                      resample_rate=8000, energy_normalize=True,
                      impl="pallas", model_dtype="float32",
                      optimizer_name="adam", lr_model=1e-3, lr_tf=8.0,
                      trainable=True, batch_size=8, max_epochs=3,
                      patience=100)


def _best_epochs(records):
    """The epochs at which the valid loss reached a new minimum."""
    best, out = np.inf, []
    for r in records:
        if r["valid_loss"] < best:
            best = r["valid_loss"]
            out.append(r["epoch"])
    return out


def _start_geometry(config, records, epoch, hint_for):
    lam = (float(config["init_lambd"]) if epoch == 0
           else records[epoch - 1]["lambd_est"])
    wl = bucketed_window_length(lam, config["n_points"])
    return {"window_length": wl, "lambd_hint": hint_for(config, wl, lam),
            "epoch": epoch}


def test_best_model_and_sidecar_match_jax(tmp_path, monkeypatch):
    """Both packages' ``fit`` on the same config and data: ``best_model``
    is written at exactly the epochs where the valid loss improves, and
    the sidecar holds the same keys, the last such epoch and the bucket
    and hint that epoch started at."""
    from dmel_tpu.models.registry import dispatch_hint_for as jax_hint
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((24, 2048)).astype(np.float32)
    ys = rng.integers(0, 10, 24).astype(np.int32)

    written = {"jax": [], "torch": []}
    jsave = jckpt.save_checkpoint
    monkeypatch.setattr(jckpt, "save_checkpoint", lambda path, state: (
        written["jax"].append(os.path.basename(path)), jsave(path, state)))
    tsave = ttrain.save_checkpoint
    monkeypatch.setattr(ttrain, "save_checkpoint", lambda path, state: (
        written["torch"].append(os.path.basename(path)), tsave(path, state)))

    ds = ArrayDataset(xs, ys, 8000)
    _, jhist = jtrain.fit(SIDECAR_CONFIG, ds, ds,
                          checkpoint_dir=str(tmp_path / "jax"))
    _, thist = fit(SIDECAR_CONFIG, _Arrays(xs, ys), _Arrays(xs, ys),
                   device="cpu", checkpoint_dir=str(tmp_path / "torch"))
    for name, hist, hint_for in (
            ("jax", jhist, jax_hint),
            ("torch", thist, tmodels.dispatch_hint_for)):
        records = hist["records"]
        best = _best_epochs(records)
        assert len(records) == SIDECAR_CONFIG["max_epochs"]
        assert written[name].count("best_model") == len(best), name
        with open(tmp_path / name / "best_model.meta.json") as f:
            meta = json.load(f)
        assert meta == _start_geometry(SIDECAR_CONFIG, records, best[-1],
                                       hint_for), name
        assert sorted(os.listdir(tmp_path / name)) == [
            "best_model", "best_model.meta.json"], name
    with open(tmp_path / "jax" / "best_model.meta.json") as f:
        jmeta = json.load(f)
    assert sorted(meta) == sorted(jmeta)
    # the geometry moved over the run, so the sidecar's is not the first
    geometries = {(_start_geometry(SIDECAR_CONFIG, thist["records"], e,
                                   tmodels.dispatch_hint_for)
                   ["window_length"]) for e in range(3)}
    assert len(geometries) > 1


# --- kill and resume ---------------------------------------------------

@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    ckpt = tmp_path_factory.mktemp("ref")
    state, history = fit(FIT_CONFIG, trainset, validset, seed=3,
                         device="cpu", checkpoint_dir=str(ckpt))
    return state, history, ckpt


def test_kill_and_resume_is_bit_identical(uninterrupted, tmp_path):
    """A bf16 trial killed after epoch 1's report resumes from the live
    state of epoch 0 and ends with the records, weights, batch-norm
    statistics, optimizer state and best model of the uninterrupted
    run, to the bit; the live state is gone at the end of both.  Its
    ``init_lambd`` is the lambda it resumed at, epoch 0's."""
    state_ref, hist_ref, ckpt_ref = uninterrupted
    assert not os.path.exists(ckpt_ref / "live_state")

    def killer(record):
        if record["epoch"] == 1:
            raise Kill

    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    with pytest.raises(Kill):
        fit(FIT_CONFIG, trainset, validset, seed=3, device="cpu",
            checkpoint_dir=str(tmp_path), report_fn=killer)
    live = load_checkpoint(str(tmp_path / "live_state"))
    assert live["meta"]["epoch"] == 0
    assert sorted(live) == ["generator", "meta", "model", "optimizer"]

    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    resumed = []
    state, hist = fit(FIT_CONFIG, trainset, validset, seed=3, device="cpu",
                      checkpoint_dir=str(tmp_path), report_fn=resumed.append)
    assert [r["epoch"] for r in resumed] == [1, 2]
    assert hist["init_lambd"] == hist_ref["records"][0]["lambd_est"]
    assert hist_ref["init_lambd"] == float(torch.tensor(
        FIT_CONFIG["init_lambd"]))
    assert ({k: v for k, v in hist.items() if k != "init_lambd"}
            == {k: v for k, v in hist_ref.items() if k != "init_lambd"})
    sd, sd_ref = state["model"].state_dict(), state_ref["model"].state_dict()
    assert all(torch.equal(v, sd_ref[k]) for k, v in sd.items())
    opt, opt_ref = (state["optimizer"].state_dict()["state"],
                    state_ref["optimizer"].state_dict()["state"])
    assert all(torch.equal(v, opt_ref[i][k])
               for i, s in opt.items() for k, v in s.items())
    best = load_checkpoint(str(tmp_path / "best_model"))["model"]
    best_ref = load_checkpoint(str(ckpt_ref / "best_model"))["model"]
    assert all(torch.equal(v, best_ref[k]) for k, v in best.items())
    assert not os.path.exists(tmp_path / "live_state")
    assert (state["window_length"], state["lambd_hint"]) == (
        state_ref["window_length"], state_ref["lambd_hint"])


def test_live_state_every_second_epoch(tmp_path, monkeypatch):
    """``live_checkpoint_every=2`` writes the live state after epochs 1,
    3, ...: killed at epoch 2's report, the trial resumes at epoch 2."""
    config = dict(FIT_CONFIG, live_checkpoint_every=2, model_dtype="float32")
    saved = []
    tsave = ttrain.save_checkpoint
    monkeypatch.setattr(ttrain, "save_checkpoint", lambda path, state: (
        saved.append((os.path.basename(path), state.get("meta", {})
                      .get("epoch"))), tsave(path, state)))

    def killer(record):
        if record["epoch"] == 2:
            raise Kill

    trainset, validset, _ = get_dataset_by_config(config)
    with pytest.raises(Kill):
        fit(config, trainset, validset, device="cpu",
            checkpoint_dir=str(tmp_path), report_fn=killer)
    assert [e for name, e in saved if name == "live_state"] == [1]
    resumed = []
    fit(config, trainset, validset, device="cpu",
        checkpoint_dir=str(tmp_path), report_fn=resumed.append)
    assert [r["epoch"] for r in resumed] == [2]
    assert not os.path.exists(tmp_path / "live_state")


# --- bucket_update="step" ---------------------------------------------

def test_bucket_update_step_reselects_at_the_crossing(monkeypatch):
    """With ``bucket_update="step"`` the bucket and hint are re-selected
    before the step whose starting lambda lies in another bucket (or
    hint region), and only then; with ``"epoch"`` only at epoch starts.
    Lambda is set after each step to a scripted value that crosses the
    1024 bucket's edges both ways."""
    script = iter([128.0, 200.0, 60.0, 61.0, 128.0, 127.5])
    step = ttrain.train_step

    def scripted(model, *args, **kwargs):
        out = step(model, *args, **kwargs)
        with torch.no_grad():
            model.spectrogram_layer.lambd.fill_(next(script))
        return out

    calls = []
    set_geometry = tlayers.MelSpectrogramLayer.set_geometry

    def spy(self, window_length, lambd_hint):
        calls.append((window_length, lambd_hint))
        set_geometry(self, window_length, lambd_hint)

    monkeypatch.setattr(ttrain, "train_step", scripted)
    monkeypatch.setattr(tlayers.MelSpectrogramLayer, "set_geometry", spy)
    config = dict(FIT_CONFIG, model_dtype="float32", max_epochs=2,
                  bucket_update="step")
    trainset, validset, _ = get_dataset_by_config(config)
    _, history = fit(config, trainset, validset, device="cpu")

    def geometry(lam):
        wl = bucketed_window_length(lam, config["n_points"])
        return wl, tmodels.dispatch_hint_for(config, wl, lam)

    # lambda before each of the 6 steps (3 an epoch)
    before = [128.0, 128.0, 200.0, 60.0, 61.0, 128.0]
    want, current = [], None
    for i, lam in enumerate(before):
        g = geometry(lam)
        if i % 3 == 0:
            want.append(g)              # the epoch boundary sets it
        elif g != current:
            want.append(g)              # the step re-selects it
        current = g
    assert calls == want
    assert {g[0] for g in calls} == {512, 1024, 2048}
    assert history["records"][-1]["lambd_est"] == 127.5


# --- training.predict ----------------------------------------------------

def test_predict_uses_the_state_geometry(uninterrupted, monkeypatch):
    """``training.predict`` builds the model at the state's recorded
    geometry, even with lambda moved to another bucket, and equals
    ``eval.predict`` of that model; without the keys it derives both
    from lambda."""
    state, _, _ = uninterrupted
    _, _, testset = get_dataset_by_config(FIT_CONFIG)
    built = []
    real = ttrain.get_model_by_config

    def spy(config, window_length=None, lambd_hint=None, **kwargs):
        built.append((window_length, lambd_hint))
        return real(config, window_length, lambd_hint, **kwargs)

    monkeypatch.setattr(ttrain, "get_model_by_config", spy)
    model = state["model"]
    labels, preds = predict(FIT_CONFIG, state, testset, batch_size=3,
                            device="cpu")
    assert built == [(state["window_length"], state["lambd_hint"])]
    np.testing.assert_array_equal(labels, testset.ys)
    want, _ = predict_arrays(model, testset.xs, device="cpu")
    np.testing.assert_array_equal(preds, want)

    moved = real(FIT_CONFIG, 1024, device="cpu")
    moved.load_state_dict(model.state_dict())
    with torch.no_grad():
        moved.spectrogram_layer.lambd.fill_(400.0)
    predict(FIT_CONFIG, {"model": moved}, testset, device="cpu")
    wl = bucketed_window_length(400.0, FIT_CONFIG["n_points"])
    assert built[-1] == (wl, tmodels.dispatch_hint_for(FIT_CONFIG, wl,
                                                       400.0))
    assert jax.devices()[0].platform == "cpu"


# --- the resumed trial's init_lambd against dmel_tpu -----------------------

#: the time_frequency space cut to 120 clips of 64 samples, 3 epochs of 3
#: SGD steps, lambda trainable from 5 sigma_ref
TF_CONFIG = dict(model_name="linear_net", dataset_name="time_frequency",
                 hop_length=1, optimized=False, normalize_window=False,
                 optimizer_name="sgd", lr_model=1e-3, lr_tf=1.0,
                 batch_size=32, max_epochs=3, patience=100, n_points=64,
                 noise_std=0.5, n_samples=120, sigma_ref=6.38,
                 center_offset=False, data_seed=0, trainable=True,
                 init_lambd=31.9, trial_repeat=0)


def _killed_and_resumed(runner, tmp_path, kill_fit, **kwargs):
    """``runner.run_trial`` (with ``kwargs``) killed after epoch 1's
    report (``fit`` replaced by ``kill_fit``), then run again; the
    resumed history and the sweep's results.csv rows."""
    trial = str(tmp_path / "trial_00000")
    real = runner.fit
    runner.fit = kill_fit
    try:
        with pytest.raises(Kill):
            runner.run_trial(TF_CONFIG, str(tmp_path), trial, **kwargs)
    finally:
        runner.fit = real
    assert os.path.exists(os.path.join(trial, "checkpoint_000000",
                                       "live_state"))
    _, history = runner.run_trial(TF_CONFIG, str(tmp_path), trial,
                                  **kwargs)
    runner.collect_results(str(tmp_path))
    with open(tmp_path / "results.csv", newline="") as f:
        return history, list(csv.DictReader(f))


def test_resumed_init_lambd_matches_jax(tmp_path, monkeypatch):
    """Both packages' trial (the same initial weights, data and batches)
    killed at epoch 1's report and resumed from epoch 0's live state:
    ``history["init_lambd"]`` is the lambda it resumed at (epoch 0's),
    in both, within 1e-3 relative of
    each other, and so is the ``init_lambd`` of results.csv, whose
    columns are the same in both."""
    from dmel_tpu.experiments import runner as jrunner
    from dmel_tpu.models import registry as jregistry
    from dmel_tpu_torch import from_jax_variables
    from dmel_tpu_torch.experiments import runner as trunner

    jmodel = jregistry.get_model_by_config(TF_CONFIG)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(3),
                                           jax.numpy.zeros((32, 64))))
    real_j = jtrain.get_model_by_config

    def jax_model(*args, **kwargs):
        model = real_j(*args, **kwargs)
        object.__setattr__(model, "init", lambda *a, **k: variables)
        return model

    real_t = ttrain.get_model_by_config

    def port_model(*args, **kwargs):
        model = real_t(*args, **kwargs)
        model.load_state_dict(from_jax_variables(variables["params"]))
        return model

    monkeypatch.setattr(jtrain, "get_model_by_config", jax_model)
    monkeypatch.setattr(ttrain, "get_model_by_config", port_model)

    def killer(record):
        if record["epoch"] == 1:
            raise Kill

    out = {}
    for name, runner, kwargs in (("jax", jrunner, {}),
                                 ("torch", trunner, {"device": "cpu"})):
        out[name] = _killed_and_resumed(
            runner, tmp_path / name,
            functools.partial(runner.fit, report_fn=killer), **kwargs)
    (jhist, jrows), (thist, trows) = out["jax"], out["torch"]
    for hist in (jhist, thist):
        assert [r["epoch"] for r in hist["records"]] == [0, 1, 2]
        assert hist["init_lambd"] == hist["records"][0]["lambd_est"]
        assert abs(hist["init_lambd"] - TF_CONFIG["init_lambd"]) > 1e-3
    assert abs(thist["init_lambd"] / jhist["init_lambd"] - 1) <= 1e-3
    assert list(trows[0]) == list(jrows[0])
    for rows, hist in ((jrows, jhist), (trows, thist)):
        assert len(rows) == 1
        assert float(rows[0]["init_lambd"]) == pytest.approx(
            hist["init_lambd"], rel=1e-7)
    assert float(trows[0]["init_lambd"]) == pytest.approx(
        float(jrows[0]["init_lambd"]), rel=1e-3)


# --- the prefetching feed ----------------------------------------------------

def test_fit_prefetch_is_bit_identical():
    """``fit`` of a mel probe with dropout (2 epochs of 5 steps) with
    ``prefetch`` 0 (placed in the loop), 1 and 2 (a background thread):
    the same records and weights, to the bit."""
    config = dict(model_name="mel_linear_net", dataset_name="esc50_synth",
                  init_lambd=46.7, n_points=4096, hop_length=80,
                  optimized=True, normalize_window=False, n_mels=64,
                  resample_rate=8000, energy_normalize=True, impl="pallas",
                  optimizer_name="adam", lr_model=1e-3, lr_tf=1.0,
                  trainable=True, batch_size=8, max_epochs=2, patience=100,
                  n_samples=56, data_seed=0, sigma_ref=8000 * 0.035 / 6,
                  noise_std=0.05)
    trainset, validset, _ = get_dataset_by_config(config)
    runs = [fit(dict(config, prefetch=p), trainset, validset, seed=1,
                device="cpu") for p in (0, 1, 2)]
    (state0, hist0), rest = runs[0], runs[1:]
    assert hist0["records"][-1]["lambd_est"] != 46.7
    sd0 = state0["model"].state_dict()
    for state, hist in rest:
        assert hist == hist0
        sd = state["model"].state_dict()
        assert all(torch.equal(v, sd0[k]) for k, v in sd.items())
