"""The port's seven probe classifiers and its DSPEC layer against
dmel_tpu's, on the CPU.

- ``SpectrogramLayer`` (DSPEC) in faithful mode (T 128, hop 1, the
  time_frequency geometry) and in optimized mode: features within 1e-4
  of their largest entry, dlambda within 1e-2 relative (bench.py's
  gates).
- Each probe, its flax variables (random init, biases and batch-norm
  parameters and statistics moved off their init) converted with
  ``from_jax_variables``: eval-mode logits within 1e-4 of the largest;
  one train step (CE, dropout off on both sides, since the packages draw
  their masks from different generators) with the loss within 1e-4
  relative, every gradient within 1e-2 in norm and dlambda within 1e-2.
  The DSPEC probes run the time_frequency geometry; the mel probes 2048
  samples at hop 80 on the framed route (dmel_tpu's kernel in Pallas
  interpret mode, the port's plain version).
- MelLinearNet on each route of the auto dispatch at a small shape
  (exact at window 128, framed at 512, specband at 1024) against
  dmel_tpu; and at AudioMNIST's shape (T 8000, hop 80, 64 mels) on the
  exact, framed and specband routes (windows 128, 512, 2048 and 4096)
  against the port's exact route (torch.stft): log-mel features within
  1e-4, logits within 1e-4 of the largest, dlambda within 1e-2.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu.models import registry as jregistry
from dmel_tpu.training import train as jtrain
from dmel_tpu_torch import build_optimizer, from_jax_variables
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch.data import make_gauss_pulse_dataset
from dmel_tpu_torch.models import classifiers as tclassifiers
from dmel_tpu_torch.models import layers as tlayers
from dmel_tpu_torch.ops.dmel import auto_route
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.training import train as ttrain

GATE = 1e-4
GRAD_GATE = 1e-2
LAM = "spectrogram_layer.lambd"

#: the time_frequency space's geometry and optimizer
SPEC_CONFIG = dict(dataset_name="time_frequency", init_lambd=6.38,
                   n_points=128, hop_length=1, optimized=False,
                   normalize_window=False, optimizer_name="sgd",
                   lr_model=1e-3, lr_tf=1.0, trainable=True)
#: the audio_mnist space's front end and optimizer on 2048-sample clips
MEL_T = 2048
MEL_CONFIG = dict(dataset_name="audio_mnist", init_lambd=46.7,
                  n_points=MEL_T, hop_length=80, optimized=True,
                  normalize_window=False, n_mels=64, resample_rate=8000,
                  energy_normalize=True, impl="pallas",
                  optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
                  trainable=True)
SPEC_PROBES = ("linear_net", "bn_linear_net", "mlp_net", "conv_net")
MEL_PROBES = ("mel_linear_net", "mel_mlp_net", "mel_conv_net")
BATCH = 4


class _NoDropout(nn.Module):
    rate: float

    @nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _grad_capture():
    """An optax transformation whose state after a step is the step's
    gradients."""
    import optax
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _perturbed(tree, rng, fn):
    return {k: _perturbed(v, rng, fn) if isinstance(v, dict)
            else fn(k, np.asarray(v), rng) for k, v in tree.items()}


def _config(name):
    base = SPEC_CONFIG if name in SPEC_PROBES else MEL_CONFIG
    return dict(base, model_name=name)


def _geometry(config):
    if not config["optimized"]:
        return None, None
    lam = float(config["init_lambd"])
    wl = bucketed_window_length(lam, config["n_points"])
    return wl, tmodels.dispatch_hint_for(config, wl, lam)


def _inputs(config, seed=0):
    if config["dataset_name"] == "time_frequency":
        data = make_gauss_pulse_dataset(sigma=6.38, n_points=128,
                                        noise_std=0.5, n_samples=BATCH,
                                        seed=seed)
        xs, ys = data.xs, data.ys
    else:
        rng = np.random.default_rng(seed)
        xs = rng.standard_normal((BATCH, config["n_points"])).astype(
            np.float32)
        ys = rng.integers(0, 10, BATCH).astype(np.int32)
    return np.ascontiguousarray(xs), ys.astype(np.int32)


def _jax_variables(jmodel, config, seed=0):
    """dmel_tpu's init of ``jmodel``, biases, batch-norm parameters and
    statistics moved off their init (kernels keep their random init)."""
    x0 = jnp.zeros((BATCH, config["n_points"]), jnp.float32)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), x0))
    rng = np.random.default_rng(seed + 1)
    params = _perturbed(variables["params"], rng, lambda k, a, r: (
        a if k in ("kernel", "lambd")
        else a + 0.1 * r.standard_normal(a.shape)).astype(np.float32))
    stats = _perturbed(variables.get("batch_stats", {}), rng,
                       lambda k, a, r: (
                           0.1 * r.standard_normal(a.shape) if k == "mean"
                           else r.uniform(0.5, 2.0, a.shape)).astype(
                               np.float32))
    return params, stats


def _port_model(config, params, stats, wl, hint):
    model = tmodels.get_model_by_config(config, window_length=wl,
                                        lambd_hint=hint, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return model


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _of_max(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


_RUNS: dict = {}


def _probe_run(name):
    """Both packages' eval-mode forward and one train step of probe
    ``name`` from the same variables and batch (cached per probe)."""
    if name in _RUNS:
        return _RUNS[name]
    config = _config(name)
    wl, hint = _geometry(config)
    xs, ys = _inputs(config)
    mask = np.ones(BATCH, bool)
    n_classes = tmodels.n_classes_for(config["dataset_name"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "Dropout", _NoDropout)
        mp.setattr(tclassifiers, "dropout",
                   lambda x, p, training, generator=None: x)
        jmodel = jregistry.get_model_by_config(config, window_length=wl,
                                               lambd_hint=hint)
        params, stats = _jax_variables(jmodel, config)
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        out_j, s_j = jmodel.apply(variables, jnp.asarray(xs), train=False)
        capture = _grad_capture()
        step = jtrain.make_train_step(jmodel, capture, False, n_classes)
        _, jgrads, jstats, _, metrics = step(
            params, capture.init(params), stats or None,
            jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(ys),
            jnp.asarray(mask))

        model = _port_model(config, params, stats, wl, hint).eval()
        with torch.no_grad():
            out_t, s_t = model(torch.from_numpy(xs))
        opt = build_optimizer(config, model)
        got = ttrain.train_step(model, opt, torch.from_numpy(xs),
                                torch.from_numpy(ys),
                                torch.from_numpy(mask), one_hot=False,
                                n_classes=n_classes)
    run = dict(
        out=(out_t.numpy(), np.asarray(out_j)),
        s=(s_t.numpy(), np.asarray(s_j)),
        loss=(float(got["loss"]), float(metrics["loss"])),
        grads=({k: p.grad.numpy() for k, p in model.named_parameters()},
               {k: v.numpy() for k, v in from_jax_variables(
                   jax.device_get(jgrads)).items()}),
        stats=({k: v.numpy() for k, v in model.state_dict().items()
                if "running" in k},
               {k: v.numpy() for k, v in from_jax_variables(
                   {}, jax.device_get(jstats or {})).items()
                if "running" in k}),
        n_classes=n_classes, config=config)
    _RUNS[name] = run
    return run


@pytest.mark.parametrize("name", SPEC_PROBES + MEL_PROBES)
def test_probe_forward_matches_jax(name):
    """Eval-mode logits within 1e-4 of the largest; the features the
    head reads within 1e-4 of their largest entry (DSPEC power, and the
    batch-normalised power of bn_linear_net) or 1e-4 absolute (log-mel)."""
    run = _probe_run(name)
    (out_t, out_j), (s_t, s_j) = run["out"], run["s"]
    assert out_t.shape == out_j.shape == (BATCH, run["n_classes"])
    assert s_t.shape == s_j.shape
    assert _of_max(out_t, out_j) <= GATE
    if name in SPEC_PROBES:
        assert s_t.shape == (BATCH, 1, 129, 129)
        assert _of_max(s_t, s_j) <= GATE
    else:
        assert s_t.shape == (BATCH, 1, 64, MEL_T // 80 + 1)
        assert float(np.abs(s_t - s_j).max()) <= GATE


@pytest.mark.parametrize("name", SPEC_PROBES + MEL_PROBES)
def test_probe_train_step_matches_jax(name):
    """One train step (CE, dropout off): the loss within 1e-4 relative,
    every parameter's gradient within 1e-2 in norm, dlambda within
    1e-2."""
    run = _probe_run(name)
    (loss_t, loss_j), (got, want) = run["loss"], run["grads"]
    assert abs(loss_t - loss_j) <= GATE * abs(loss_j)
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        if key == LAM:
            assert abs(float(g) / float(want[key]) - 1) <= GRAD_GATE
        else:
            assert _rel(g, want[key]) <= GRAD_GATE, key


def test_bn_linear_net_running_stats_match_jax():
    """bn_linear_net's batch-norm statistics after one train step: the
    running means within 1e-5 and the running variances within 1e-5 of
    their largest entry of ``dmel_tpu``'s, which update the variance
    from the biased batch variance."""
    got, want = _probe_run("bn_linear_net")["stats"]
    assert sorted(got) == sorted(want) == ["bn.running_mean",
                                           "bn.running_var"]
    assert float(np.abs(got["bn.running_mean"]
                        - want["bn.running_mean"]).max()) <= 1e-5
    assert _of_max(got["bn.running_var"], want["bn.running_var"]) <= 1e-5


def test_conv_probe_conversion_permutes_fc1():
    """``fc1`` of a conv probe takes the NCHW-flattened conv output: the
    converted weight's column ``(c, f, t)`` is flax's row
    ``(f, t, c)``; conv1 goes HWIO -> OIHW."""
    config = _config("conv_net")
    jmodel = jregistry.get_model_by_config(config)
    params, _ = _jax_variables(jmodel, config)
    sd = from_jax_variables(params)
    kernel = params["fc1"]["kernel"]                    # (F T C, 32)
    f = t = 129
    c = 32
    w = sd["fc1.weight"].numpy()                         # (32, C F T)
    for cc, ff, tt in ((0, 0, 0), (3, 17, 100), (31, 128, 128)):
        np.testing.assert_array_equal(w[:, (cc * f + ff) * t + tt],
                                      kernel[(ff * t + tt) * c + cc])
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(),
                                  params["conv1"]["kernel"].transpose(
                                      3, 2, 0, 1))


@pytest.mark.parametrize("optimized,lam,hop", [(False, 6.38, 1),
                                               (False, 31.9, 1),
                                               (True, 30.0, 4)])
def test_spectrogram_layer_matches_jax(optimized, lam, hop):
    """DSPEC, faithful (n_fft 2T, window T) and optimized (window 256):
    features within 1e-4 of their largest entry, dlambda within 1e-2.
    The layer subtracts the mean and uses |lambda| (lambda negative
    here)."""
    t = 128
    wl = bucketed_window_length(lam, t) if optimized else None
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, t)) + 0.5).astype(np.float32)
    jlayer = jmodels.SpectrogramLayer(init_lambd=-lam, hop_length=hop,
                                      optimized=optimized, window_length=wl)
    jvars = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jlayer.apply(jvars, jnp.asarray(x)))
    jgrad = jax.grad(lambda v: jlayer.apply(v, jnp.asarray(x)).sum())(jvars)
    layer = tlayers.SpectrogramLayer(-lam, hop_length=hop,
                                     optimized=optimized, window_length=wl)
    got = layer(torch.from_numpy(x))
    got.sum().backward()
    n_fft = wl if optimized else 2 * t
    assert got.shape == want.shape == (3, 1, n_fft // 2 + 1, t // hop + 1)
    assert _of_max(got.detach().numpy(), want) <= GATE
    dlam = float(jgrad["params"]["lambd"])
    assert abs(float(layer.lambd.grad) / dlam - 1) <= GRAD_GATE


@pytest.mark.parametrize("lam,route", [(13.3, "exact"), (46.7, "framed"),
                                       (128.0, "specband")])
def test_mel_linear_net_routes_match_jax(lam, route):
    """MelLinearNet at 2048 samples on each route of the auto dispatch,
    dmel_tpu's kernels in interpret mode: log-mel features within 1e-4,
    logits within 1e-4 of the largest."""
    config = dict(_config("mel_linear_net"), init_lambd=lam)
    wl, hint = _geometry(config)
    assert auto_route(signal_length=MEL_T, hop_length=80, n_mels=64,
                      optimized=True, window_length=wl,
                      lambd_hint=hint)[0] == route
    jmodel = jregistry.get_model_by_config(config, window_length=wl,
                                           lambd_hint=hint)
    params, _ = _jax_variables(jmodel, config)
    xs, _ = _inputs(config, seed=5)
    out_j, s_j = jmodel.apply({"params": params}, jnp.asarray(xs))
    model = _port_model(config, params, {}, wl, hint).eval()
    with torch.no_grad():
        out_t, s_t = model(torch.from_numpy(xs))
    assert float(np.abs(s_t.numpy() - np.asarray(s_j)).max()) <= GATE
    assert _of_max(out_t.numpy(), out_j) <= GATE


@pytest.mark.parametrize("lam,route,window", [
    (13.3, "exact", 128), (46.7, "framed", 512),
    (172.95, "specband", 2048), (400.0, "specband", 4096)])
def test_mel_linear_net_audio_mnist_routes(lam, route, window):
    """MelLinearNet at AudioMNIST's shape (T 8000, hop 80, 64 mels) on
    the route the audio_mnist sweep's lambdas take, against the same
    weights on the exact route (torch.stft): log-mel within 1e-4, logits
    within 1e-4 of the largest, dlambda within 1e-2 (in eval mode: no
    dropout)."""
    config = dict(_config("mel_linear_net"), n_points=8000, init_lambd=lam)
    wl, hint = _geometry(config)
    assert wl == window
    assert auto_route(signal_length=8000, hop_length=80, n_mels=64,
                      optimized=True, window_length=wl,
                      lambd_hint=hint)[0] == route
    model = tmodels.get_model_by_config(config, wl, hint, device="cpu")
    exact = tmodels.get_model_by_config(dict(config, impl="xla"), wl,
                                        device="cpu")
    exact.load_state_dict(model.state_dict())
    x = torch.from_numpy(_inputs(config, seed=7)[0])
    grads = []
    for m in (model.eval(), exact.eval()):
        out, s = m(x)
        (out.sum() + s.mean()).backward()
        grads.append(float(m.spectrogram_layer.lambd.grad))
    with torch.no_grad():
        (out_k, s_k), (out_x, s_x) = model(x), exact(x)
    assert s_k.shape == (BATCH, 1, 64, 101)
    assert float((s_k - s_x).abs().max()) <= GATE
    assert _of_max(out_k.numpy(), out_x.numpy()) <= GATE
    assert abs(grads[0] / grads[1] - 1) <= GRAD_GATE


def test_registry_builds_the_seven_probes():
    """Every probe name builds, with its class, image size and seeded
    init (the same seed, the same weights)."""
    want = {"linear_net": tmodels.LinearNet,
            "bn_linear_net": tmodels.BatchNormLinearNet,
            "mlp_net": tmodels.MlpNet, "conv_net": tmodels.ConvNet,
            "mel_linear_net": tmodels.MelLinearNet,
            "mel_mlp_net": tmodels.MelMlpNet,
            "mel_conv_net": tmodels.MelConvNet}
    for name, cls in want.items():
        config = _config(name)
        wl, hint = _geometry(config)
        a = tmodels.get_model_by_config(config, wl, hint, device="cpu",
                                        seed=4)
        b = tmodels.get_model_by_config(config, wl, hint, device="cpu",
                                        seed=4)
        assert type(a) is cls
        if name in SPEC_PROBES:
            assert a.size == (129, 129)
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    with pytest.raises(ValueError, match="model name not found"):
        tmodels.get_model_by_config(dict(SPEC_CONFIG, model_name="resnet"),
                                    device="cpu")
