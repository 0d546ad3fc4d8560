"""The port's PANNs Cnn6 import against dmel_tpu's, on the CPU.

The checkpoint is ``tests/fixtures.py``'s stand-in for the PANNs
``Cnn6_mAP=0.343.pth``: the full key set of the published file (the
AudioSet front end's buffers, ``bn0``, the four conv blocks, ``fc1``
and the 527-class ``fc_audioset``) with random values.  MelPANNsNet
takes the exact route (``impl="xla"``) on 4096-sample clips, so that
both packages run their plain front end.
"""

import contextlib
import io
import re
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu.training import checkpoint as jcheckpoint
from dmel_tpu_torch import fit, from_jax_variables
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.training import import_panns_cnn6
from dmel_tpu_torch.training import train as ttrain
from tests import fixtures

T = 4096
WINDOW = 1024
CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
              init_lambd=128.0, n_points=T, hop_length=80, optimized=True,
              normalize_window=False, n_mels=64, resample_rate=8000,
              energy_normalize=True, impl="xla", model_dtype="float32",
              optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
              trainable=True, batch_size=4, max_epochs=1, patience=100,
              n_samples=12, sigma_ref=8000 * 0.035 / 6, noise_std=0.05,
              data_seed=0)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "Cnn6_mAP=0.343.pth")
    fixtures.make_fake_cnn6_checkpoint(path)
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


@pytest.fixture(scope="module")
def jax_model():
    """dmel_tpu's MelPANNsNet and its initial variables."""
    model = jmodels.get_model_by_config(CONFIG, window_length=WINDOW)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((2, T))))
    return model, variables


def _jax_import(sd, variables):
    """dmel_tpu's import of ``sd`` and its printed counts."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = jcheckpoint.import_panns_cnn6(
            sd, {"params": variables["params"],
                 "batch_stats": variables["batch_stats"]}, verbose=True)
    counts = re.search(r"imported (\d+) tensors, skipped (\d+)",
                       buf.getvalue())
    return out, (int(counts[1]), int(counts[2]))


def _port_model(variables):
    model = tmodels.get_model_by_config(CONFIG, WINDOW, device="cpu")
    model.load_state_dict(from_jax_variables(variables["params"],
                                             variables["batch_stats"]))
    return model


def test_import_matches_jax(checkpoint, jax_model):
    """From the same initial weights, every tensor of the imported
    model equals dmel_tpu's import through ``from_jax_variables``, the
    imported and skipped counts are dmel_tpu's, and the eval-mode
    scores agree within 1e-5."""
    jmodel, variables = jax_model
    imported, counts = _jax_import(checkpoint, variables)
    model = _port_model(variables)
    assert import_panns_cnn6(checkpoint, model) == counts
    want = from_jax_variables(imported["params"], imported["batch_stats"])
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    conv = checkpoint["conv_block3.conv1.weight"]
    assert torch.equal(got["spectrogram_model.conv_block3.conv1.weight"],
                       conv)

    x = np.random.default_rng(0).standard_normal((3, T)).astype(np.float32)
    want_scores, _ = jmodel.apply(imported, jnp.asarray(x), train=False)
    with torch.no_grad():
        scores, _ = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=0, atol=1e-5)


def test_import_skips_what_jax_skips(checkpoint, jax_model):
    """The stand-in's skips: the AudioSet front end's three buffers, the
    four ``bn0`` tensors (dmel_tpu's CNN6 names its mel batch norm
    ``bn1``) and the 527-class head, and no ``num_batches_tracked``;
    the verbose count line is dmel_tpu's."""
    _, variables = jax_model
    _, counts = _jax_import(checkpoint, variables)
    model = _port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        import_panns_cnn6(checkpoint, model, verbose=True)
    assert buf.getvalue().strip().endswith(
        f"imported {counts[0]} tensors, skipped {counts[1]}")
    after = model.state_dict()
    for key in ("spectrogram_model.bn1.running_mean",
                "spectrogram_model.fc_esc50.weight",
                "spectrogram_layer.lambd",
                "spectrogram_model.conv_block1.bn1.num_batches_tracked"):
        assert torch.equal(after[key], before[key]), key
    assert not any(k.startswith("spectrogram_model.bn0") for k in after)


def _small(shape):
    return torch.full(shape, 0.5)


@pytest.mark.parametrize("sd", [
    OrderedDict([("fc_esc50.weight", _small((527, 512))),
                 ("fc_esc50.bias", _small((10,)))]),
    OrderedDict([("bn1.weight", _small((64,))),
                 ("bn1.running_var", _small((64,))),
                 ("bn1.num_batches_tracked", torch.tensor(7))]),
    OrderedDict([("conv_block2.conv1.weight", _small((128, 64, 5, 5))),
                 ("conv_block2.conv1.bias", _small((128,)))]),
    OrderedDict([("logmel_extractor.melW", _small((513, 64))),
                 ("conv_block4.bn1.scale", _small((512,)))]),
], ids=["shape", "mel_bn", "absent_bias", "unknown"])
def test_import_counts_match_jax(sd, jax_model):
    """Small state dicts through both imports: the same counts, the
    same tensors."""
    _, variables = jax_model
    imported, counts = _jax_import(sd, variables)
    model = _port_model(variables)
    assert import_panns_cnn6(sd, model) == counts
    want = from_jax_variables(imported["params"], imported["batch_stats"])
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_fit_starts_from_the_imported_weights(checkpoint, jax_model,
                                               monkeypatch):
    """``fit(pretrained_state_dict=...)`` imports the checkpoint into
    the fresh model before its optimizer is built: there, every tensor
    the import maps equals the checkpoint's, the rest keep the seeded
    init, and the counts are dmel_tpu's; the trial then trains to the
    end."""
    _, (n_imported, n_skipped) = _jax_import(checkpoint, jax_model[1])
    seen = {}
    real = ttrain.build_optimizer

    def capture(config, model):
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
        return real(config, model)
    monkeypatch.setattr(ttrain, "build_optimizer", capture)
    trainset, validset, _ = get_dataset_by_config(CONFIG)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, history = fit(CONFIG, trainset, validset, device="cpu",
                         verbose=1, pretrained_state_dict=checkpoint)
    assert (f"imported {n_imported} tensors, skipped {n_skipped}"
            in buf.getvalue())
    fresh = tmodels.get_model_by_config(CONFIG, WINDOW,
                                        device="cpu").state_dict()
    mapped = 0
    for key, value in seen.items():
        src = checkpoint.get(key.removeprefix("spectrogram_model."))
        if (key.startswith("spectrogram_model.") and src is not None
                and src.shape == value.shape
                and not key.endswith("num_batches_tracked")):
            assert torch.equal(value, src), key
            mapped += 1
        else:
            assert torch.equal(value, fresh[key]), key
    assert mapped == n_imported
    assert len(history["records"]) == 1
    assert np.isfinite(history["records"][0]["loss"])
