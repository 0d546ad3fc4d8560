"""The port's model path against dmel_tpu, on the CPU: MelPANNsNet
inference after ``from_jax_variables``, the registry, ``predict`` and
the synthetic dataset.

MelPANNsNet runs at the published CNN6 widths on short clips (4000
samples, as ``__graft_entry__.py`` uses), at the 1024 window bucket so
that both packages take the specband route (dmel_tpu's kernel in
Pallas interpret mode, the port's plain version); features and scores
must agree within 1e-4 max-abs (bench.py's feature gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu.data.synthetic import (
    make_esc50_synth_dataset as jax_make_esc50_synth_dataset)
from dmel_tpu.ops.stft import pallas_compile_hint
from dmel_tpu_torch import from_jax_variables, predict
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch.data import make_esc50_synth_dataset
from dmel_tpu_torch.ops import specband

GATE = 1e-4
T = 4000
CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
              init_lambd=128.0, n_points=T, hop_length=80, optimized=True,
              normalize_window=False, n_mels=64, resample_rate=8000,
              energy_normalize=True, impl="pallas", model_dtype="float32")
WINDOW = 1024
HINT = pallas_compile_hint(128.0, WINDOW, 80)


def _perturbed(tree, rng, fn):
    return {k: _perturbed(v, rng, fn) if isinstance(v, dict)
            else fn(k, np.asarray(v), rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_model():
    """dmel_tpu's MelPANNsNet with its init, batch-norm parameters and
    statistics moved off their trivial init so that the conversion of
    every leaf shows in the output."""
    hint = pallas_compile_hint(128.0, WINDOW, 80)
    model = jmodels.get_model_by_config(CONFIG, window_length=WINDOW,
                                        lambd_hint=hint)
    rng = np.random.default_rng(1)
    x0 = jnp.zeros((2, T), jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), x0))
    params = _perturbed(variables["params"], rng, lambda k, a, r: (
        a if k in ("kernel", "lambd")
        else a + 0.1 * r.standard_normal(a.shape)).astype(np.float32))
    stats = _perturbed(variables["batch_stats"], rng, lambda k, a, r: (
        0.1 * r.standard_normal(a.shape) if k == "mean"
        else r.uniform(0.5, 2.0, a.shape)).astype(np.float32))
    return model, params, stats, hint


def _torch_model(params, stats, hint):
    model = tmodels.get_model_by_config(CONFIG, window_length=WINDOW,
                                        lambd_hint=hint, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return model.eval()


def test_mel_panns_net_matches_jax(jax_model, rng):
    jmodel, params, stats, hint = jax_model
    x = rng.standard_normal((2, T)).astype(np.float32)
    out_j, s_j = jmodel.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    model = _torch_model(params, stats, hint)
    with torch.no_grad():
        out_t, s_t = model(torch.from_numpy(x))
    assert s_t.shape == s_j.shape == (2, 1, 64, T // 80 + 1)
    assert out_t.shape == out_j.shape == (2, 10)
    assert float(np.max(np.abs(s_t.numpy() - np.asarray(s_j)))) <= GATE
    assert float(np.max(np.abs(out_t.numpy() - np.asarray(out_j)))) <= GATE

    # the slice as a whole: predict over the same clips, in two batches
    preds, scores = predict(model, np.concatenate([x, x[::-1]]),
                            batch_size=2, device="cpu")
    np.testing.assert_allclose(scores[:2], out_t.numpy(), rtol=0, atol=1e-6)
    assert (preds == scores.argmax(-1)).all()


def test_state_dict_conversion(jax_model):
    _, params, stats, hint = jax_model
    sd = from_jax_variables(params, stats)
    model = tmodels.get_model_by_config(CONFIG, window_length=WINDOW,
                                        lambd_hint=hint, device="cpu")
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    conv = params["spectrogram_model"]["conv_block2"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        sd["spectrogram_model.conv_block2.conv1.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    fc = params["spectrogram_model"]["fc_esc50"]["kernel"]
    np.testing.assert_array_equal(
        sd["spectrogram_model.fc_esc50.weight"].numpy(), fc.T)
    bn = stats["spectrogram_model"]["bn1"]
    np.testing.assert_array_equal(
        sd["spectrogram_model.bn1.running_var"].numpy(), bn["var"])
    assert float(sd["spectrogram_layer.lambd"]) == 128.0
    with pytest.raises(ValueError, match="no torch counterpart"):
        from_jax_variables({"m": {"embedding": np.zeros(3)}})


def test_registry_matches_jax():
    from dmel_tpu.models import registry as jreg
    for name in jreg.N_CLASSES:
        assert tmodels.n_classes_for(name) == jreg.n_classes_for(name)
    with pytest.raises(ValueError):
        tmodels.n_classes_for("imagenet")
    for lam in (13.3, 46.7, 100.0, 128.0, 300.0, 400.0):
        wl = min(1 << (int(6 * lam) - 1).bit_length(), 65536)
        assert (tmodels.dispatch_hint_for(CONFIG, wl, lam)
                == jreg.dispatch_hint_for(CONFIG, wl, lam))
    assert tmodels.dispatch_hint_for(dict(CONFIG, impl="xla"), 1024,
                                     128.0) is None
    assert tmodels.dispatch_hint_for(CONFIG, None, 128.0) is None


@pytest.mark.parametrize("change,error", [
    (dict(n_sigma=3), None),
    (dict(impl="pallas_framed"), None),
    (dict(impl="pallas_fused"), None),
    (dict(precision="default"), NotImplementedError),
    (dict(impl="cudnn"), ValueError),
    (dict(impl="specband"), ValueError)])
def test_registry_refuses_what_is_not_ported(change, error):
    """What is not ported raises; the framed and fused impls and the
    multi-sigma front end build and take their routes (``error``
    None)."""
    if error is None:
        model = tmodels.get_model_by_config(dict(CONFIG, **change),
                                            window_length=WINDOW,
                                            device="cpu")
        layer = model.spectrogram_layer
        if "impl" in change:
            assert layer.impl == change["impl"][len("pallas_"):]
        else:
            assert isinstance(layer, tmodels.MultiSigmaMelSpectrogramLayer)
            assert layer.lambd.shape == (change["n_sigma"],)
        return
    with pytest.raises(error):
        tmodels.get_model_by_config(dict(CONFIG, **change),
                                    window_length=WINDOW, device="cpu")


def test_seeded_init_and_default_device(monkeypatch):
    a = tmodels.get_model_by_config(CONFIG, WINDOW, device="cpu", seed=3)
    b = tmodels.get_model_by_config(CONFIG, WINDOW, device="cpu", seed=3)
    c = tmodels.get_model_by_config(CONFIG, WINDOW, device="cpu", seed=4)
    w = "spectrogram_model.conv_block3.conv1.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    bound = (6.0 / (128 * 25 + 256 * 25)) ** 0.5
    assert float(a.state_dict()[w].abs().max()) <= bound
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.get_model_by_config(CONFIG, WINDOW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict(a, np.zeros((1, T), np.float32))


def test_predict_batches_and_device(rng):
    model = tmodels.get_model_by_config(CONFIG, WINDOW, HINT, device="cpu")
    xs = rng.standard_normal((5, T)).astype(np.float32)
    before = specband.specband_mel_power.launches
    preds, scores = predict(model, xs, batch_size=2, device="cpu")
    assert specband.specband_mel_power.launches == before
    assert preds.shape == (5,) and scores.shape == (5, 10)
    assert np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all()
    with torch.no_grad():
        direct, _ = model(torch.from_numpy(xs[4:]))
    np.testing.assert_allclose(scores[4:], direct.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="lies on"):
        predict(model, xs, device="meta")


def test_train_mode_augment_is_not_ported():
    """SpecAugment (``augment=True``) runs in a training-mode forward:
    its masks come from the generator passed in (the same seed gives
    the same scores, another seed others), and an eval-mode forward
    equals the unaugmented model's."""
    config = dict(CONFIG, augment=True)
    model = tmodels.get_model_by_config(config, WINDOW, HINT, device="cpu")
    x = torch.randn(2, T, generator=torch.Generator().manual_seed(0))
    runs = [model.train()(x, generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                               runs[2])
    plain = tmodels.get_model_by_config(CONFIG, WINDOW, HINT, device="cpu")
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(model.eval()(x)[0], plain.eval()(x)[0])


def test_synthetic_dataset_matches_jax():
    for hard in (False, True):
        want = jax_make_esc50_synth_dataset(n_samples=12, seed=5, hard=hard)
        got = make_esc50_synth_dataset(n_samples=12, seed=5, hard=hard)
        for field in ("xs", "ys", "locs"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.xs.shape == (12, 40000) and got.xs.dtype == np.float32
