"""The port's fsd space against dmel_tpu's, on the CPU: the FSD50K
loader and its cache, SpecAugment's masks, CNN6 with ``augment=True``
and a one-trial fsd sweep from the port's CLI through ``predict_test``.

The FSD50K tree is ``tests/fixtures.py``'s official layout at 200
classes (24 dev and 6 eval clips at 22.05 kHz, 0.5-2 s long), with one
dev clip of 6 s added so that a clip is longer than ``n_points`` (the
center crop).  The masks take dmel_tpu's uniforms: the ones its
``jax.random.split`` and ``uniform`` draw from a key.
"""

import contextlib
import csv
import io
import os
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu.data import fsd as jfsd
from dmel_tpu.data.registry import get_dataset_by_config as jax_datasets
from dmel_tpu.eval import predict as jpredict
from dmel_tpu.experiments import runner as jrunner
from dmel_tpu.models import panns as jpanns
from dmel_tpu.training.checkpoint import load_checkpoint as jax_load
from dmel_tpu_torch import from_jax_variables
from dmel_tpu_torch.data import fsd as tfsd
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.eval import predict_test
from dmel_tpu_torch.eval.metrics import mean_average_precision, top1_precision
from dmel_tpu_torch.experiments import cli as tcli
from dmel_tpu_torch.experiments import configs as tconfigs
from dmel_tpu_torch.experiments import runner as trunner
from dmel_tpu_torch.models import panns as tpanns
from dmel_tpu_torch.training import save_checkpoint
from tests import fixtures

SR = 22050
CONFIG = {"dataset_name": "fsd", "resample_rate": 8000, "n_points": 40000}


def _add_long_clip(root):
    """A 6 s dev clip (48000 samples at 8 kHz, past ``n_points``), for
    the center crop, appended to ``dev.csv`` as a train row."""
    rng = np.random.default_rng(7)
    fixtures.write_wav(os.path.join(root, "FSD50K.dev_audio", "long.wav"),
                       fixtures.speechish(rng, 6 * SR, SR, 440.0), SR)
    with open(os.path.join(root, "FSD50K.ground_truth", "dev.csv"),
              "a") as f:
        f.write('long,"Class_003,Class_150",/m/x,train\n')


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies of one FSD50K tree, neither loaded yet: one for each
    package, so that each writes its own cache."""
    base = tmp_path_factory.mktemp("fsd")
    jax_root = fixtures.make_fsd50k_tree(str(base / "jax"), n_classes=200,
                                         n_dev=24, n_eval=6, sr=SR)
    _add_long_clip(jax_root)
    port_root = str(base / "port")
    shutil.copytree(jax_root, port_root)
    return jax_root, port_root


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.xs, w.xs)
        np.testing.assert_array_equal(g.ys, w.ys)
        assert g.xs.dtype == w.xs.dtype == np.float32
        assert g.ys.dtype == w.ys.dtype == np.float32
        assert g.sample_rate == w.sample_rate


def test_fsd50k_matches_jax_fresh_and_cached(trees):
    """Each package loads its own copy fresh (resampling and writing the
    cache), then from its cache, and the port also from dmel_tpu's
    cache: every array bit-equal, the cache files of the same names."""
    jax_root, port_root = trees
    want = jfsd.fsd50k(jax_root)
    fresh = tfsd.fsd50k(port_root)
    _equal(fresh, want)
    assert [len(s) for s in fresh] == [21, 4, 6]
    train = fresh[0]
    assert train.xs.shape == (21, 40000) and train.ys.shape == (21, 200)
    assert train.ys[-1].nonzero()[0].tolist() == [3, 150]   # the long clip
    assert np.abs(train.xs[-1, :100]).max() > 0     # cropped, not padded
    assert (train.ys.sum(1) >= 1).all() and (train.ys.sum(1) <= 3).all()
    names = sorted(f for f in os.listdir(port_root) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(jax_root)
                           if f.endswith(".npy"))
    assert "8000_40000_val_ys.npy" in names
    _equal(tfsd.fsd50k(port_root), want)
    _equal(tfsd.fsd50k(jax_root), want)


def test_fsd_registry_matches_jax(trees):
    jax_root, port_root = trees
    got = get_dataset_by_config(CONFIG, port_root)
    _equal(got, jax_datasets(CONFIG, jax_root))


@pytest.mark.parametrize("n", [10, 40000, 48000, 48001])
def test_fix_length_matches_jax(n):
    x = np.arange(1, n + 1, dtype=np.float32)
    got = tfsd._fix_length(x, 40000)
    want = jfsd._fix_length(x, 40000)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (40000,)


def test_vocabulary_matches_jax(trees):
    vocab = tfsd.load_vocabulary(trees[1])
    assert vocab == jfsd.load_vocabulary(trees[0])
    assert len(vocab) == 200 and vocab["Class_199"] == 199


# --- SpecAugment ---------------------------------------------------------

MASKS = {"time": (jpanns.time_mask, 2, 64), "freq": (jpanns.freq_mask, 3, 8)}


def _uniforms(key, b):
    """The two uniforms dmel_tpu's mask draws from ``key`` for ``b``
    clips (its width's, then its start's)."""
    k1, k2 = jax.random.split(key)
    return [torch.tensor(np.asarray(jax.random.uniform(k, (b,))))
            for k in (k1, k2)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("which", ["time", "freq"])
def test_mask_matches_jax(which, seed):
    """``mask_span`` fed dmel_tpu's uniforms gives dmel_tpu's mask, bit
    for bit, on (8, 1, 101, 64) (dmel_tpu's layout (8, 101, 64, 1))."""
    jfn, dim, param = MASKS[which]
    x = np.random.default_rng(seed).standard_normal(
        (8, 101, 64)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jfn(key, jnp.asarray(x[..., None]), param))[..., 0]
    got = tpanns.mask_span(torch.from_numpy(x[:, None]), dim, param,
                           *_uniforms(key, 8))
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    assert (want == 0).any()


@pytest.mark.parametrize("which", ["time", "freq"])
def test_mask_draws_from_the_generator(which):
    """``time_mask``/``freq_mask`` draw their two uniforms a clip, the
    widths' then the starts', from the generator they are given."""
    fn = tpanns.time_mask if which == "time" else tpanns.freq_mask
    _, dim, param = MASKS[which]
    x = torch.randn(5, 1, 70, 64, generator=torch.Generator().manual_seed(1))
    got = fn(x, param, torch.Generator().manual_seed(3))
    u = torch.rand((2, 5), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, tpanns.mask_span(x, dim, param, u[0], u[1]))
    assert not torch.equal(got, fn(x, param,
                                   torch.Generator().manual_seed(4)))


def test_mask_bounds():
    """On a ones batch of the esc50/fsd geometry (501 frames x 64
    mels), each clip's zeroed frames and mels are one contiguous span of
    at most 64 frames and 8 mels.  The span takes the positions ``i``
    with ``start <= i < start + width`` for a real width below the
    parameter, so it can reach the parameter itself (torchaudio's
    integer widths stay below it)."""
    g = torch.Generator().manual_seed(0)
    x = torch.ones(256, 1, 501, 64)
    t = tpanns.time_mask(x, 64, g)[:, 0]            # (B, frames, mels)
    f = tpanns.freq_mask(x, 8, g)[:, 0].transpose(1, 2)   # (B, mels, frames)
    for masked, param in ((t, 64), (f, 8)):
        assert (masked == 0).any()
        for clip in masked:
            span = (clip == 0).all(dim=1).nonzero()[:, 0]
            assert len(span) <= param
            assert int((clip == 0).sum()) == len(span) * clip.shape[1]
            if len(span):
                assert int(span[-1] - span[0]) + 1 == len(span)


class _NoDropout(nn.Module):
    rate: float = 0.0

    @nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def test_cnn6_augment_matches_jax(monkeypatch):
    """A training-mode forward of CNN6 with ``augment=True`` (dropout
    off in both packages, the port's masks fed dmel_tpu's uniforms)
    against dmel_tpu's through ``from_jax_variables``: the scores and
    the updated batch-norm statistics within 1e-5 (the means absolute,
    the variances relative to the largest)."""
    monkeypatch.setattr(nn, "Dropout", _NoDropout)
    monkeypatch.setattr(tpanns, "dropout",
                        lambda x, p, training, generator=None: x)
    keys = []
    for name in ("time_mask", "freq_mask"):
        real = getattr(jpanns, name)

        def record(key, x, param, real=real):
            keys.append(key)
            return real(key, x, param)
        monkeypatch.setattr(jpanns, name, record)
    x = np.random.default_rng(0).standard_normal(
        (3, 96, 64)).astype(np.float32)
    jmodel = jpanns.Cnn6(classes_num=10, n_mels=64, augment=True)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((3, 96, 64, 1))))
    want, updates = jmodel.apply(
        variables, jnp.asarray(x[..., None]), train=True,
        rngs={"augment": jax.random.PRNGKey(5)}, mutable=["batch_stats"])
    assert len(keys) == 2
    u_time, u_freq = _uniforms(keys[0], 3), _uniforms(keys[1], 3)
    monkeypatch.setattr(tpanns, "time_mask", lambda x, p, generator=None:
                        tpanns.mask_span(x, 2, p, *u_time))
    monkeypatch.setattr(tpanns, "freq_mask", lambda x, p, generator=None:
                        tpanns.mask_span(x, 3, p, *u_freq))

    model = tpanns.Cnn6(10, 64, augment=True)
    model.load_state_dict(from_jax_variables(variables["params"],
                                             variables["batch_stats"]))
    got = model.train()(torch.from_numpy(x[:, None]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    stats = from_jax_variables({}, jax.device_get(updates["batch_stats"]))
    sd = model.state_dict()
    for key, w in stats.items():
        if key.endswith("num_batches_tracked"):
            continue
        err = float((sd[key] - w).abs().max())
        if key.endswith("running_var"):
            err /= float(w.abs().max())
        assert err <= 1e-5, (key, err)


def test_cnn6_augment_draw_order():
    """``Cnn6.forward`` draws from its generator the time mask's
    uniforms, the frequency mask's, then the dropout masks: the same as
    those steps taken by hand from the same seed; eval mode draws
    nothing and masks nothing."""
    model = tpanns.Cnn6(10, 64, augment=True,
                        generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 1, 48, 64, generator=torch.Generator().manual_seed(1))
    got = model(x, torch.Generator().manual_seed(9))

    g = torch.Generator().manual_seed(9)
    h = model.bn1(x.reshape(-1, 64)).reshape(x.shape)
    h = tpanns.freq_mask(tpanns.time_mask(h, 64, g), 8, g)
    for block in (model.conv_block1, model.conv_block2, model.conv_block3,
                  model.conv_block4):
        h = tpanns.dropout(block(h), 0.2, True, g)
    h = h.mean(dim=3)
    h = tpanns.dropout(h.max(dim=2).values + h.mean(dim=2), 0.5, True, g)
    h = tpanns.dropout(torch.relu(model.fc1(h)), 0.5, True, g)
    assert torch.equal(got, torch.sigmoid(model.fc_esc50(h)))

    model.eval()
    plain = tpanns.Cnn6(10, 64, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    assert torch.equal(model(x), plain.eval()(x))


# --- the sweep -----------------------------------------------------------

def _one_trial_space(max_epochs=1):
    """The fsd space cut to one trial (lambda 13.33 trainable, the exact
    route) on 8000-sample clips."""
    space = tconfigs.fsd(max_epochs)
    space.update(init_lambd=8000 * 0.01 / 6, trainable=True, n_points=8000)
    return space


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_fsd_sweep_from_the_cli(trees, tmp_path, monkeypatch):
    """One fsd trial (bf16 CNN6, SpecAugment, 200 classes) through the
    port's CLI and dmel_tpu's ``run_sweep`` on the same space and tree:
    results.csv and fsd.csv with dmel_tpu's columns and a finite
    ``test_mAP`` in [0, 1].  dmel_tpu's trial's checkpoint, converted
    into the port's format, gives dmel_tpu's test scores through the
    port's ``predict_test`` within 2e-3 (bf16 CNN6: the packages round
    at different points, as in ``test_torch_bf16.py``), and the port's
    metrics on dmel_tpu's scores give dmel_tpu's ``test_mAP`` and
    ``test_accuracy``."""
    jax_root, port_root = trees
    monkeypatch.setitem(tconfigs.SEARCH_SPACES, "fsd", _one_trial_space)
    out = str(tmp_path / "out")
    tcli.main(["--name", "fsd", "--num_samples", "1", "--max_epochs", "1",
               "--output_dir", out, "--data_dir", port_root,
               "--verbose", "0", "--device", "cpu"])
    jax_space = {k: v for k, v in _one_trial_space().items()}
    jsweep = _quiet(jrunner.run_sweep, "fsd", 1, 1, str(tmp_path / "jax"),
                    jax_root, space=jax_space)
    tsweep = os.path.join(out, "fsd")
    assert (_header(os.path.join(tsweep, "results.csv"))
            == _header(os.path.join(jsweep, "results.csv")))

    scored = predict_test(tsweep, port_root, verbose=0, device="cpu")
    jscored = _quiet(jpredict.predict_test, jsweep, jax_root, verbose=0)
    assert (_header(os.path.join(tsweep, "fsd.csv"))
            == _header(os.path.join(jsweep, "fsd.csv")))
    assert len(scored) == 1
    assert 0.0 <= scored[0]["test_mAP"] <= 1.0
    assert 0.0 <= scored[0]["test_accuracy"] <= 1.0
    preds = np.load(os.path.join(tsweep, "fsd_predictionss.npy"))
    assert preds.shape == (1, 6, 200) and np.isfinite(preds).all()

    # dmel_tpu's checkpoint in the port's format, beside its own sidecar
    jtrial = os.path.join(jsweep, "trial_00000", "checkpoint_000000")
    restored = jax_load(os.path.join(jtrial, "best_model"))
    ported = os.path.join(tsweep, "trial_00000", "checkpoint_000000")
    save_checkpoint(os.path.join(ported, "best_model"), {
        "model": from_jax_variables(restored["params"],
                                    restored.get("batch_stats"))})
    shutil.copy(os.path.join(jtrial, "best_model.meta.json"),
                os.path.join(ported, "best_model.meta.json"))
    got = predict_test(tsweep, port_root, verbose=0, device="cpu")[0]
    scores = np.load(os.path.join(tsweep, "fsd_predictionss.npy"))[0]
    jscores = np.load(os.path.join(jsweep, "fsd_predictionss.npy"))[0]
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=2e-3)
    labels = np.load(os.path.join(tsweep, "fsd_labelss.npy"))[0]
    np.testing.assert_array_equal(
        labels, np.load(os.path.join(jsweep, "fsd_labelss.npy"))[0])
    assert got["test_mAP"] == mean_average_precision(labels, scores)
    want = jscored.iloc[0]
    assert mean_average_precision(labels, jscores) == pytest.approx(
        float(want["test_mAP"]), abs=1e-12)
    assert top1_precision(labels, jscores) == pytest.approx(
        float(want["test_accuracy"]), abs=1e-12)
    rows = trunner.load_results(tsweep)
    assert rows[0]["config/augment"] is True
