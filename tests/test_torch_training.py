"""The port's training slice against dmel_tpu, on the CPU: the losses,
the per-group optimizer, one MelPANNsNet train step and ``fit``.

MelPANNsNet runs at the published CNN6 widths on short clips (4000
samples) at the 1024 window bucket, so both packages take the specband
route: dmel_tpu's Pallas kernels in interpret mode, the port's plain
version.  Dropout is switched off on both sides inside the test, since
the two packages draw their masks from different generators.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu import training as jtraining
from dmel_tpu.data import synthetic as jsynthetic
from dmel_tpu.ops.stft import pallas_compile_hint
from dmel_tpu.training import optim as joptim
from dmel_tpu.training import train as jtrain
from dmel_tpu_torch import build_optimizer, fit, from_jax_variables
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.models import layers as tlayers
from dmel_tpu_torch.models import panns as tpanns
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.training import train as ttrain

T = 4000
WINDOW = 1024
HINT = pallas_compile_hint(128.0, WINDOW, 80)
CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
              init_lambd=128.0, n_points=T, hop_length=80, optimized=True,
              normalize_window=False, n_mels=64, resample_rate=8000,
              energy_normalize=True, impl="pallas", model_dtype="float32",
              optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
              trainable=True)


# --- losses and metrics ----------------------------------------------

def _probs_with_edges(rng, shape):
    p = rng.uniform(0.01, 0.99, shape).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 0.0]
    p[1, :2] = [1.0, 1.0]
    return p


def test_bce_matches_jax_with_saturated_probabilities(rng):
    """Values within relative 1e-6 and gradients within 1e-5 (relative
    to the largest) of the JAX loss, finite at probabilities of exactly 0 and
    1; the masked tail does not count."""
    probs = _probs_with_edges(rng, (6, 5))
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    labels[0, :2] = [1.0, 0.0]                    # log(0) and log1p(-1)
    mask = np.array([True, True, True, True, False, False])
    want, g_want = jax.value_and_grad(jtrain.bce_loss)(
        jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(mask))
    p = torch.from_numpy(probs).requires_grad_()
    got = ttrain.bce_loss(p, torch.from_numpy(labels), torch.from_numpy(mask))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    assert torch.isfinite(p.grad).all()
    g_want = np.asarray(g_want)
    assert np.abs(p.grad.numpy() - g_want).max() <= 1e-5 * np.abs(g_want).max()
    assert (p.grad[4:] == 0).all()


def test_ce_matches_jax(rng):
    logits = rng.standard_normal((7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 7).astype(np.int32)
    mask = np.array([True] * 5 + [False] * 2)
    want = float(jtrain.ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask)))
    got = float(ttrain.ce_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6


class _FixedJax:
    """A stand-in flax model for ``_loss_and_metrics``: returns fixed
    outputs and features."""

    def __init__(self, out, s):
        self.out, self.s = out, s

    def apply(self, variables, xs, train=False, **kwargs):
        return jnp.asarray(self.out), jnp.asarray(self.s)


class _FixedTorch(torch.nn.Module):
    def __init__(self, out, s):
        super().__init__()
        self.out, self.s = torch.from_numpy(out), torch.from_numpy(s)

    def forward(self, xs, generator=None):
        return self.out, self.s


@pytest.mark.parametrize("one_hot", [True, False])
@pytest.mark.parametrize("multi_label", [False, True])
def test_loss_and_metrics_match_jax(rng, one_hot, multi_label):
    """loss and energy within relative 1e-6 and acc within 1e-6 of the
    JAX package's ``_loss_and_metrics`` with a masked tail, for sigmoid
    (one-hot BCE) and logit (CE, or BCE from logits) models and for
    integer and multi-hot labels."""
    b, c = 6, 5
    out = (_probs_with_edges(rng, (b, c)) if one_hot
           else rng.standard_normal((b, c)).astype(np.float32))
    s = rng.standard_normal((b, 1, 4, 3)).astype(np.float32)
    ys = ((rng.uniform(size=(b, c)) < 0.4).astype(np.float32) if multi_label
          else rng.integers(0, c, b).astype(np.int32))
    mask = np.array([True] * 4 + [False] * 2)
    loss_j, (_, acc_j, en_j) = jtrain._loss_and_metrics(
        _FixedJax(out, s), {}, None, jnp.zeros((b, 1)), jnp.asarray(ys),
        jnp.asarray(mask), jax.random.PRNGKey(0), one_hot, c, False)
    loss_t, acc_t, en_t = ttrain.loss_and_metrics(
        _FixedTorch(out, s), torch.zeros((b, 1)), torch.from_numpy(ys),
        torch.from_numpy(mask), one_hot=one_hot, n_classes=c)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    assert abs(float(acc_t) - float(acc_j)) <= 1e-6
    assert abs(float(en_t) - float(en_j)) <= 1e-6 * abs(float(en_j))


# --- the optimizer ----------------------------------------------------

class _Params(torch.nn.Module):
    def __init__(self, lambd, w, b):
        super().__init__()
        self.lambd = torch.nn.Parameter(torch.tensor(lambd))
        self.fc = torch.nn.Linear(w.shape[1], w.shape[0])
        with torch.no_grad():
            self.fc.weight.copy_(torch.from_numpy(w))
            self.fc.bias.copy_(torch.from_numpy(b))


@pytest.mark.parametrize("name", ["sgd", "adam"])
@pytest.mark.parametrize("trainable", [True, False])
def test_build_optimizer_matches_optax(rng, name, trainable):
    """Three steps on the same fixed gradients: parameters within
    relative 1e-6 of optax's; a frozen lambda does not move."""
    config = dict(optimizer_name=name, lr_model=0.01, lr_tf=0.5,
                  trainable=trainable)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    grads = [dict(lambd=np.float32(rng.standard_normal()),
                  w=rng.standard_normal((3, 4)).astype(np.float32),
                  b=rng.standard_normal(3).astype(np.float32))
             for _ in range(3)]

    params = {"lambd": jnp.float32(7.0),
              "fc": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}}
    opt = joptim.build_optimizer(config, params)
    state = opt.init(params)
    for g in grads:
        gj = {"lambd": jnp.asarray(g["lambd"]),
              "fc": {"kernel": jnp.asarray(g["w"].T),
                     "bias": jnp.asarray(g["b"])}}
        updates, state = opt.update(gj, state, params)
        params = optax.apply_updates(params, updates)

    model = _Params(7.0, w, b)
    topt = build_optimizer(config, model)
    assert model.lambd.requires_grad == trainable
    for g in grads:
        topt.zero_grad(set_to_none=True)
        if trainable:
            model.lambd.grad = torch.tensor(g["lambd"])
        model.fc.weight.grad = torch.from_numpy(g["w"])
        model.fc.bias.grad = torch.from_numpy(g["b"])
        topt.step()

    for got, want in ((model.lambd, params["lambd"]),
                      (model.fc.weight, np.asarray(params["fc"]["kernel"]).T),
                      (model.fc.bias, params["fc"]["bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    if not trainable:
        assert float(model.lambd) == 7.0


def test_build_optimizer_refuses_unknown_names():
    with pytest.raises(ValueError, match="optimizer not found"):
        build_optimizer(dict(CONFIG, optimizer_name="lamb"), _Params(
            1.0, np.zeros((2, 2), np.float32), np.zeros(2, np.float32)))


# --- one MelPANNsNet train step --------------------------------------

class _NoDropout(nn.Module):
    rate: float

    @nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _grad_capture():
    """An optax transformation whose state after a step is the step's
    gradients (and whose updates are zero)."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _norm_err(got, want):
    return float((got - want).norm() / want.norm())


def test_train_step_matches_jax(rng, monkeypatch):
    """One train step of MelPANNsNet against dmel_tpu's
    ``make_train_step``, from the same weights and batch:

    - loss within relative 1e-5;
    - dlambda within relative 1e-2, bench.py's gate (dmel_tpu's
      specband adjoint runs in bf16);
    - every other parameter's gradient within 1e-2 in norm, relative to
      the norm: at batch 4 single entries of the first blocks'
      gradients sit on ReLU boundaries and move by a few percent even
      between float32 and float64 of one model (see
      ``test_train_step_matches_float64``), so entries are compared as
      a whole;
    - batch-norm running means within 1e-5, and running variances
      within 1e-5 of dmel_tpu's, relative: both take the biased batch
      variance (torch's own update takes the unbiased one, a factor
      n / (n - 1) in the new term: 1 + 5.2e-3 at this batch's smallest
      n, 4 x 6 x 8 = 192 values a channel in ``conv_block4``).
    """
    monkeypatch.setattr(nn, "Dropout", _NoDropout)
    monkeypatch.setattr(tpanns, "dropout",
                        lambda x, p, training, generator=None: x)
    jmodel = jmodels.get_model_by_config(CONFIG, window_length=WINDOW,
                                         lambd_hint=HINT)
    x = rng.standard_normal((4, T)).astype(np.float32)
    ys = np.array([0, 3, 5, 9], np.int32)
    mask = np.ones(4, bool)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((4, T))))
    params, stats = variables["params"], variables["batch_stats"]
    capture = _grad_capture()
    step = jtrain.make_train_step(jmodel, capture, True, 10)
    _, grads, new_stats, _, metrics = step(
        params, capture.init(params), stats, jax.random.PRNGKey(1),
        jnp.asarray(x), jnp.asarray(ys), jnp.asarray(mask))
    grads = from_jax_variables(jax.device_get(grads))
    new_stats = from_jax_variables({}, jax.device_get(new_stats))

    model = tmodels.get_model_by_config(CONFIG, WINDOW, HINT, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats))
    opt = build_optimizer(CONFIG, model)
    got = ttrain.train_step(model, opt, torch.from_numpy(x),
                            torch.from_numpy(ys), torch.from_numpy(mask),
                            one_hot=True, n_classes=10)

    want_loss = float(metrics["loss"])
    assert abs(float(got["loss"]) - want_loss) <= 1e-5 * want_loss
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(grads)
    lam = "spectrogram_layer.lambd"
    assert abs(float(named[lam].grad - grads[lam])) <= 1e-2 * abs(
        float(grads[lam]))
    for key, p in named.items():
        if key != lam:
            assert _norm_err(p.grad, grads[key]) <= 1e-2, key

    sd = model.state_dict()
    for key, want in new_stats.items():
        if key.endswith("running_mean"):
            assert float((sd[key] - want).abs().max()) <= 1e-5, key
        elif key.endswith("running_var"):
            assert float((sd[key] - want).abs().max()
                         / want.abs().max()) <= 1e-5, key


def test_train_step_matches_float64(rng, monkeypatch):
    """The port's float32 train-step gradients (specband route) against
    the same model in float64 through the exact route: dlambda within
    relative 1e-2, every parameter within 1e-2 in norm.  This holds the
    port to the mathematics and not only to dmel_tpu, whose own
    float32 CNN6 gradients differ from float64 by a few percent in
    places on the CPU."""
    monkeypatch.setattr(tpanns, "dropout",
                        lambda x, p, training, generator=None: x)
    x = torch.from_numpy(rng.standard_normal((4, T)).astype(np.float32))
    ys = torch.tensor([0, 3, 5, 9])
    mask = torch.ones(4, dtype=torch.bool)
    model = tmodels.get_model_by_config(CONFIG, WINDOW, HINT, device="cpu",
                                        seed=1).train()
    ref = tmodels.get_model_by_config(dict(CONFIG, impl="xla"), WINDOW,
                                      device="cpu").train()
    ref.load_state_dict(model.state_dict())
    ref.double()

    def grads(m, xs):
        loss, _, _ = ttrain.loss_and_metrics(m, xs, ys, mask, one_hot=True,
                                             n_classes=10)
        return dict(zip([k for k, _ in m.named_parameters()],
                        torch.autograd.grad(loss, list(m.parameters()))))

    got, want = grads(model, x), grads(ref, x.double())
    lam = "spectrogram_layer.lambd"
    assert abs(float(got[lam]) - float(want[lam])) <= 1e-2 * abs(
        float(want[lam]))
    for key in got:
        assert _norm_err(got[key].double(), want[key]) <= 1e-2, key


# --- fit -------------------------------------------------------------

FIT_CONFIG = dict(CONFIG, n_points=4096, batch_size=4, max_epochs=2,
                  patience=100, n_samples=20, data_seed=0,
                  sigma_ref=8000 * 0.035 / 6, noise_std=0.05)


@pytest.fixture(scope="module")
def jax_record_keys():
    """Record and history keys of dmel_tpu's ``fit`` on a tiny
    time_frequency probe (the keys do not depend on the model)."""
    cfg = dict(model_name="linear_net", hop_length=1, optimized=False,
               normalize_window=False, optimizer_name="sgd", lr_model=1e-3,
               lr_tf=1.0, batch_size=16, trainable=True, max_epochs=1,
               patience=100, n_points=64, noise_std=0.5, init_lambd=6.38,
               n_samples=40, sigma_ref=6.38, dataset_name="time_frequency",
               center_offset=False, data_seed=0)
    ds = jsynthetic.make_gauss_pulse_dataset(
        sigma=6.38, n_points=64, noise_std=0.5, n_samples=40, seed=0)
    _, history = jtraining.fit(cfg, ds, ds)
    return set(history["records"][0]), set(history)


@pytest.mark.parametrize("trainable", [True, False])
def test_fit_two_epochs(jax_record_keys, monkeypatch, trainable):
    """Two epochs at a tiny esc50_synth config: the JAX package's record
    and history keys, finite values, lambda moving only when trainable,
    and the layer's bucket and hint re-selected at each epoch from the
    lambda the epoch starts at."""
    geometry = []
    set_geometry = tlayers.MelSpectrogramLayer.set_geometry

    def spy(self, window_length, lambd_hint):
        geometry.append((window_length, lambd_hint))
        set_geometry(self, window_length, lambd_hint)

    monkeypatch.setattr(tlayers.MelSpectrogramLayer, "set_geometry", spy)
    config = dict(FIT_CONFIG, trainable=trainable)
    trainset, validset, _ = get_dataset_by_config(config)
    reported = []
    state, history = fit(config, trainset, validset, seed=0, device="cpu",
                         report_fn=reported.append)
    record_keys, history_keys = jax_record_keys
    records = history["records"]
    assert len(records) == 2 and reported == records
    assert all(set(r) == record_keys for r in records)
    assert set(history) == history_keys
    assert all(np.isfinite(r[k]) for r in records for k in r)
    lam = [history["init_lambd"]] + [r["lambd_est"] for r in records]
    if trainable:
        assert lam[1] != lam[0] and lam[2] != lam[1]
    else:
        assert lam == [128.0] * 3
    assert history["est_lambd"] == lam[-1]
    want = []
    for start in lam[:2]:
        wl = bucketed_window_length(start, config["n_points"])
        want.append((wl, tmodels.dispatch_hint_for(config, wl, start)))
    assert geometry == want
    assert (state["window_length"], state["lambd_hint"]) == want[-1]
    layer = state["model"].spectrogram_layer
    assert (layer.window_length, layer.lambd_hint) == want[-1]


def test_fit_stops_when_lambda_diverges(monkeypatch):
    """A non-finite lambda at an epoch boundary ends the trial."""
    step = ttrain.train_step

    def poisoned(model, *args, **kwargs):
        out = step(model, *args, **kwargs)
        with torch.no_grad():
            model.spectrogram_layer.lambd.fill_(float("nan"))
        return out

    monkeypatch.setattr(ttrain, "train_step", poisoned)
    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    _, history = fit(dict(FIT_CONFIG, max_epochs=3), trainset, validset,
                     device="cpu")
    assert history["diverged"] and len(history["records"]) == 1


def test_fit_early_stopping():
    """patience 0: the first epoch sets the best valid loss and uses up
    the patience, so the trial converges after it."""
    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    _, history = fit(dict(FIT_CONFIG, max_epochs=3, patience=0), trainset,
                     validset, device="cpu")
    assert history["converged"] and len(history["records"]) == 1


@pytest.mark.parametrize("kwargs", [dict(mesh=object())], ids=["mesh"])
def test_fit_refuses_what_is_not_ported(kwargs):
    with pytest.raises(NotImplementedError):
        fit(FIT_CONFIG, None, None, device="cpu", **kwargs)
