"""The port's test-set prediction against dmel_tpu's on the JAX-trained
checkpoints under ``results/``, on the CPU, and the eval metrics.

Each trial's flax checkpoint is read with dmel_tpu's
``load_checkpoint``, converted with ``from_jax_variables`` and written
in the port's format, with its geometry sidecar where it has one, into a
one-trial sweep under ``tmp_path``.  The port's ``predict_test`` there
must give the same argmax on every test clip as dmel_tpu's
``predictions_by_row`` on the original checkpoint, both on the CPU.

- ``results/esc50_synth``: 400 test clips; trial 0 (float32, window 256)
  runs in tier-1; the other float32 trials and the six bf16 ones are
  ``slow`` (up to ~70 s each, the 4096-window trials through dmel_tpu's
  specband kernel in interpret mode).
- ``results/audio_mnist`` (mel_linear_net) and
  ``results/time_frequency`` (linear_net): checkpoints without a
  sidecar, so both packages take the geometry from the checkpoint's
  lambda.  audio_mnist's 6000 test clips come from the full fixture tree
  the sweep was trained on; time_frequency's 1000 from its space with
  ``data_seed`` 0 (the sweep's own test set was drawn unseeded).
  audio_mnist trial 3 (lambda 13.3, frozen: the exact route) and
  time_frequency trial 0 run in tier-1, the other ten trials are
  ``slow``.  How many clips also match the stored TPU predictions is
  printed.
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest

from dmel_tpu.data.loader import BatchLoader as JBatchLoader
from dmel_tpu.data.registry import get_dataset_by_config as jax_datasets
from dmel_tpu.eval import metrics as jmetrics
from dmel_tpu.eval import predict as jpredict
from dmel_tpu.training.checkpoint import load_checkpoint as jax_load
from dmel_tpu_torch import eval as teval
from dmel_tpu_torch import from_jax_variables
from dmel_tpu_torch.training import load_checkpoint, save_checkpoint
from tests import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: test clips a sweep's test split holds
TEST_CLIPS = {"esc50_synth": 400, "esc50_synth_hard": 400,
              "audio_mnist": 6000, "time_frequency": 1000}
#: config cells added to a sweep's rows (time_frequency's test set seeded)
ROW_CHANGES = {"time_frequency": {"config/data_seed": 0}}


def _rows(sweep: str) -> list[dict]:
    with open(os.path.join(ROOT, "results", sweep, "results.csv"),
              newline="") as f:
        return list(csv.DictReader(f))


def _trial_dir(sweep_name: str, row: dict) -> str:
    """The trial's directory in this checkout (rows may hold the
    absolute path of the machine that ran the sweep)."""
    return os.path.join(ROOT, "results", sweep_name,
                        os.path.basename(str(row["logdir"])))


def _port_sweep(sweep_name: str, jax_row: dict, out_dir: str) -> str:
    """A one-trial sweep in the port's format: the JAX trial's config
    row (``logdir`` pointing into ``out_dir``) and its checkpoint,
    converted, with the sidecar copied where there is one."""
    src = os.path.join(_trial_dir(sweep_name, jax_row), "checkpoint_000000",
                       "best_model")
    restored = jax_load(src)
    weights = from_jax_variables(restored["params"],
                                 restored.get("batch_stats"))
    sweep = os.path.join(out_dir, "sweep")
    trial = os.path.join(sweep, os.path.basename(jax_row["logdir"]))
    dst = os.path.join(trial, "checkpoint_000000", "best_model")
    save_checkpoint(dst, {"model": weights})
    if os.path.exists(src + ".meta.json"):
        shutil.copy(src + ".meta.json", dst + ".meta.json")
    with open(os.path.join(sweep, "results.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(jax_row))
        writer.writeheader()
        writer.writerow(dict(jax_row, logdir=trial))
    return sweep


def _check_trial(sweep_name: str, index: int, tmp_path,
                 data_dir: str = "/nonexistent"):
    changes = ROW_CHANGES.get(sweep_name, {})
    jrow = jpredict.load_results(
        os.path.join(ROOT, "results", sweep_name)).iloc[index].to_dict()
    jrow.update(changes, logdir=_trial_dir(sweep_name, jrow))
    config = jpredict._coerce(jpredict.get_config_by_row(jrow))
    _, _, jtest = jax_datasets(config, data_dir)
    want_labels, want = jpredict.predictions_by_row(
        jrow, JBatchLoader(jtest, 32, shuffle=False))

    sweep = _port_sweep(sweep_name, dict(_rows(sweep_name)[index],
                                         **changes), str(tmp_path))
    rows = teval.predict_test(sweep, data_dir, verbose=0, device="cpu")
    dataset = config["dataset_name"]
    got = np.load(os.path.join(sweep, f"{dataset}_predictionss.npy"))
    labels = np.load(os.path.join(sweep, f"{dataset}_labelss.npy"))
    n = TEST_CLIPS[sweep_name]
    assert got.shape == (1, n)
    np.testing.assert_array_equal(labels[0], want_labels)
    assert int((got[0] == want).sum()) == n
    assert rows[0]["test_accuracy"] == float(np.mean(want == want_labels))
    with open(os.path.join(sweep, f"{dataset}.csv"), newline="") as f:
        written = list(csv.DictReader(f))
    assert float(written[0]["test_accuracy"]) == rows[0]["test_accuracy"]
    if sweep_name not in ROW_CHANGES:       # the sweep's own test set
        stored = np.load(os.path.join(ROOT, "results", sweep_name,
                                      f"{dataset}_predictionss.npy"))[index]
        print(f"\n{sweep_name} trial {index}: {n} of {n} test clips equal "
              f"dmel_tpu's CPU predictions, {int((got[0] == stored).sum())}"
              " the stored ones")


def test_trial_0_predictions_match_jax(tmp_path):
    """results/esc50_synth trial 0 (float32, the exact route at window
    256): 400 of 400 test clips agree."""
    _check_trial("esc50_synth", 0, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("sweep,index", [
    *(("esc50_synth", i) for i in range(1, 12)),
    *(("esc50_synth_hard", i) for i in range(6))])
def test_trial_predictions_match_jax(sweep, index, tmp_path):
    """Every other trial: float32 and bf16 (odd rows of esc50_synth),
    every route of the auto dispatch."""
    _check_trial(sweep, index, tmp_path)


@pytest.fixture(scope="module")
def audio_mnist_tree(tmp_path_factory):
    """The full 30000-wav AudioMNIST fixture tree the
    ``results/audio_mnist`` sweep was trained on."""
    root = tmp_path_factory.mktemp("audio_mnist")
    return fixtures.make_audio_mnist_tree(str(root), min_len=1500,
                                          max_len=7500)


def test_audio_mnist_trial_3_predictions_match_jax(audio_mnist_tree,
                                                   tmp_path):
    """results/audio_mnist trial 3 (mel_linear_net, lambda 13.3 frozen:
    the exact route at window 128, no sidecar): 6000 of 6000."""
    _check_trial("audio_mnist", 3, tmp_path, audio_mnist_tree)


def test_time_frequency_trial_0_predictions_match_jax(tmp_path):
    """results/time_frequency trial 0 (linear_net, faithful DSPEC, no
    sidecar) on the seeded test set: 1000 of 1000."""
    _check_trial("time_frequency", 0, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("index", [0, 1, 2, 4, 5])
def test_audio_mnist_trial_predictions_match_jax(audio_mnist_tree, index,
                                                 tmp_path):
    """The other audio_mnist trials: 46.7 (framed) and 400 (specband at
    4096, and what lambda grew into)."""
    _check_trial("audio_mnist", index, tmp_path, audio_mnist_tree)


@pytest.mark.slow
@pytest.mark.parametrize("index", [1, 2, 3, 4, 5])
def test_time_frequency_trial_predictions_match_jax(index, tmp_path):
    _check_trial("time_frequency", index, tmp_path)


def test_port_checkpoint_holds_the_converted_weights(tmp_path):
    """The converted checkpoint reads back as the state dict that was
    written, with the sidecar's geometry beside it."""
    row = _rows("esc50_synth")[0]
    sweep = _port_sweep("esc50_synth", row, str(tmp_path))
    path = os.path.join(sweep, "trial_00000", "checkpoint_000000",
                        "best_model")
    restored = jax_load(os.path.join(_trial_dir("esc50_synth", row),
                                     "checkpoint_000000", "best_model"))
    want = from_jax_variables(restored["params"], restored["batch_stats"])
    got = load_checkpoint(path)["model"]
    assert sorted(got) == sorted(want)
    assert all((got[k] == want[k]).all() for k in want)
    with open(path + ".meta.json") as f:
        assert json.load(f)["window_length"] == 256


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    """average_precision, mean_average_precision and top1_precision
    equal dmel_tpu's (to the bit) on random multi-hot labels, a class
    with no positive included."""
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(40, 6)) < 0.3).astype(np.float32)
    y[:, 2] = 0
    scores = rng.uniform(size=(40, 6)).astype(np.float32)
    for c in range(6):
        a = teval.average_precision(y[:, c], scores[:, c])
        b = jmetrics.average_precision(y[:, c], scores[:, c])
        assert (np.isnan(a) and np.isnan(b)) or a == b
    assert (teval.mean_average_precision(y, scores)
            == jmetrics.mean_average_precision(y, scores))
    assert teval.top1_precision(y, scores) == jmetrics.top1_precision(
        y, scores)
    assert teval.mean_average_precision(np.zeros((3, 2)),
                                        np.ones((3, 2))) == 0.0
