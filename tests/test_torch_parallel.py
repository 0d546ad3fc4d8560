"""The port's packed trials (``dmel_tpu_torch.parallel``) against
dmel_tpu's (``dmel_tpu.parallel.trials``), on the CPU.

- the pack's static hint and per-leaf rates: equal to dmel_tpu's;
- the packed front end (``mel_spectrogram`` with lambda (K,)) on the
  exact, framed, fused and specband routes: each trial bit for bit the
  port's single-trial call, and against ``jax.vmap`` of dmel_tpu's
  function (Pallas in interpret mode) within the tolerances of the
  single-trial tests of each route (``test_torch_framed.py``,
  ``test_torch_fused.py``, ``test_torch_specband.py``): log-mel max-abs
  1e-5 on the exact and fused routes and 1e-4 on the framed and
  specband ones, dlambda relative 1e-4 on the exact and fused routes
  and 1e-2 on the framed and specband ones;
- ``make_multitrial_step`` against dmel_tpu's from the same converted
  stacked state and batches (tolerances in each test);
- ``fit_trials``'s behaviour (dmel_tpu's ``TestMultiTrial``), no trial
  leaking into another, and ``run_sweep_packed`` / ``--pack`` writing
  dmel_tpu's packed sweep layout.
"""

import copy
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu import ops as jops
from dmel_tpu.data import synthetic as jsynthetic
from dmel_tpu.experiments import runner as jrunner
from dmel_tpu.parallel import trials as jtrials
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.convert import (from_jax_stacked, from_jax_variables,
                                    jax_trial, stack_state_dicts)
from dmel_tpu_torch.data import ArrayDataset
from dmel_tpu_torch.experiments import cli as tcli
from dmel_tpu_torch.experiments import runner as trunner
from dmel_tpu_torch.models import classifiers as tclassifiers
from dmel_tpu_torch.models import packed as tpacked
from dmel_tpu_torch.models import panns as tpanns
from dmel_tpu_torch.parallel import mesh as tmesh
from dmel_tpu_torch.parallel import trials as ttrials
from dmel_tpu_torch.training import load_checkpoint
from dmel_tpu_torch.training.optim import PackedOptimizer
from tests.test_experiments import tiny_space

SR = 8000


def small_cfg(**over):
    """dmel_tpu's ``tests/test_parallel.py`` config: a mel probe on 256
    samples in faithful mode."""
    cfg = dict(model_name="mel_linear_net", dataset_name="audio_mnist",
               init_lambd=10.0, n_points=256, hop_length=16,
               optimized=False, normalize_window=False, n_mels=16,
               resample_rate=8000, energy_normalize=True,
               optimizer_name="sgd", lr_model=1e-3, lr_tf=1.0,
               trainable=True, batch_size=16, max_epochs=2, patience=100)
    cfg.update(over)
    return cfg


def toy(n, n_points=256, seed=0, n_classes=10):
    rng = np.random.default_rng(seed)
    return ArrayDataset(rng.standard_normal((n, n_points)).astype(np.float32),
                        rng.integers(0, n_classes, n).astype(np.int32), SR)


# --- the pack's hint and rates ------------------------------------------

@pytest.mark.parametrize("impl,wl", [("pallas", 1024), ("pallas", 4096),
                                     ("pallas", 512), ("pallas", None),
                                     ("xla", 1024),
                                     ("pallas_specband", 1024)])
def test_shared_specband_hint_matches_jax(impl, wl):
    """Equal hints over lambda sets that share a region, straddle two,
    hold a non-finite value or a trial outside the truncation window,
    with and without frozen trials."""
    c0 = dict(impl=impl, hop_length=80)
    sets = [(110.0, 120.0), (13.33, 46.67, 400.0), (100.0, 128.0),
            (400.0, 420.0), (np.nan, 120.0), (46.7, 50.0), (30.0, 46.7),
            (128.0,), (341.67, 500.0, 13.33)]
    for lams in sets:
        for active in (None, [1.0] * len(lams),
                       [0.0] + [1.0] * (len(lams) - 1),
                       [0.0] * len(lams)):
            assert ttrials._shared_specband_hint(c0, wl, lams, active) == \
                jtrials._shared_specband_hint(c0, wl, lams, active), (
                    lams, active)


def _port_names(tree, prefix=""):
    """A flax params tree's leaves under the port's names (``kernel``
    and ``scale`` are ``weight``)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_port_names(value, path + "."))
        else:
            module, _, leaf = path.rpartition(".")
            leaf = "weight" if leaf in ("kernel", "scale") else leaf
            out[f"{module}.{leaf}" if module else leaf] = value
    return out


@pytest.mark.parametrize("model_name,n_sigma", [
    ("mel_linear_net", 1), ("mel_conv_net", 1), ("linear_net", 1),
    ("bn_linear_net", 1), ("panns_cnn6", 3)])
def test_lr_tree_matches_jax(model_name, n_sigma):
    """The same rate for every leaf, lambd's at lr_tf, for each model
    family (and the multi-sigma lambda vector)."""
    cfg = small_cfg(model_name=model_name, n_sigma=n_sigma, n_mels=64)
    if model_name in ("linear_net", "bn_linear_net"):
        cfg.update(dataset_name="time_frequency", n_points=64, hop_length=1)
    jmodel = jmodels.get_model_by_config(cfg)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, cfg["n_points"])))["params"]
    model = tmodels.get_model_by_config(cfg, device="cpu")
    names = dict(model.named_parameters())
    for lr_tf, lr_model in ((1.0, 1e-3), (0.0, 1e-4)):
        want = _port_names(jtrials._lr_tree(params, lr_tf, lr_model))
        assert ttrials._lr_tree(names, lr_tf, lr_model) == want


# --- the packed front end --------------------------------------------------

#: (impl, route name of dmel_tpu, K lambdas, T, n_fft, win, hop, n_mels,
#:  hint, log-mel gate, dlambda gate)
FRONT_CASES = [
    ("exact", "xla", (20.0, 32.0, 45.0), 1500, 256, 256, 16, 32, None,
     1e-5, 1e-4),
    ("framed", "pallas_framed", (28.0, 32.0), 1000, 256, 256, 16, 32, None,
     1e-4, 1e-2),
    ("fused", "pallas_fused", (14.0, 16.0), 1000, 128, 128, 20, 16, None,
     1e-5, 1e-4),
    ("specband", "pallas_specband", (24.0, 22.0), 1500, 256, 256, 16, 32,
     24.0, 1e-4, 1e-2),
]
# the specband lambdas are test_torch_specband.py's 24 and one more on its
# J 12 rung: dmel_tpu's interpret kernel runs its DFT as bf16 splits and
# sits 6e-5 to 9e-5 from the port on these signals at 22 to 26, up to
# 1.1e-4 at 26 on the second trial's, as far as on a single trial


@pytest.mark.parametrize("case", FRONT_CASES, ids=lambda c: c[0])
def test_packed_front_end(case):
    """``mel_spectrogram`` with lambda (K,) on (K, B, T): each trial's
    log-mel bit for bit the single-trial call's, its dlambda within
    relative 1e-6 of the single call's (the window's gradient sums a
    (K, L) row where the single call sums an (L,) vector); against
    ``jax.vmap`` of dmel_tpu's function with the same impl within the
    route's gates (module docstring)."""
    impl, jimpl, lams, t, n_fft, win, hop, n_mels, hint, gate, ggate = case
    k = len(lams)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((k, 2, t)).astype(np.float32)
    cot = rng.uniform(0.5, 1.5, (k, 2, n_mels, t // hop + 1)).astype(
        np.float32)
    kw = dict(n_mels=n_mels, sample_rate=SR, hop_length=hop, optimized=True,
              window_length=n_fft, lambd_hint=hint)
    lam = torch.tensor(lams, requires_grad=True)
    got = tops.log_mel_spectrogram(torch.from_numpy(x), lam, impl=impl,
                                   device="cpu", **kw)
    (got * torch.from_numpy(cot)).sum().backward()
    for i, li in enumerate(lams):
        l1 = torch.tensor(li, requires_grad=True)
        one = tops.log_mel_spectrogram(torch.from_numpy(x[i]), l1, impl=impl,
                                       device="cpu", **kw)
        (one * torch.from_numpy(cot[i])).sum().backward()
        assert torch.equal(got[i], one)
        assert abs(float(lam.grad[i] - l1.grad)) <= 1e-6 * abs(
            float(l1.grad))

    def jax_logmel(xi, li):
        return jops.log_mel_spectrogram(xi, li, impl=jimpl, method="matmul",
                                        **kw)

    def jax_vjp(xi, li, ci):
        out, vjp = jax.vjp(lambda lv: jax_logmel(xi, lv), li)
        return out, vjp(ci)[0]

    want, jgrad = jax.jit(jax.vmap(jax_vjp))(
        jnp.asarray(x), jnp.asarray(lams), jnp.asarray(cot))
    assert float(np.max(np.abs(got.detach().numpy() - np.asarray(want)))) \
        <= gate
    for i in range(k):
        assert abs(float(lam.grad[i]) - float(jgrad[i])) <= ggate * abs(
            float(jgrad[i])), (i, float(lam.grad[i]), float(jgrad[i]))


def test_packed_multi_sigma_front_end():
    """``multi_sigma_mel_spectrogram`` with lambdas (P, K): each trial bit
    for bit its single call, on the specband route (K1/K2 at k_sig 2
    with the trial axis beside) and the exact one."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 2, 2000)).astype(
        np.float32))
    lams = torch.tensor([[100.0, 110.0], [105.0, 120.0]])
    for impl, hint in (("auto", [110.0, 120.0]), ("exact", None)):
        kw = dict(n_mels=64, sample_rate=SR, hop_length=80, optimized=True,
                  window_length=1024, impl=impl, lambd_hint=hint,
                  device="cpu")
        assert tops.multi_sigma_route(
            hop_length=80, n_mels=64, optimized=True, window_length=1024,
            lambd_hint=hint, impl=impl)[0] == (
                "specband" if impl == "auto" else "exact")
        got = tops.multi_sigma_mel_spectrogram(x, lams, **kw)
        for i in range(2):
            assert torch.equal(got[i], tops.multi_sigma_mel_spectrogram(
                x[i], lams[i], **kw)), impl


# --- the packed train step -------------------------------------------------

class _NoDropout(nn.Module):
    rate: float = 0.0

    @nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _no_dropout(monkeypatch):
    monkeypatch.setattr(nn, "Dropout", _NoDropout)
    identity = lambda x, p, training, generator=None, dim=0: x  # noqa: E731
    monkeypatch.setattr(tpanns, "dropout", identity)
    monkeypatch.setattr(tpacked, "dropout", identity)


def _jax_state(cfgs, n_points, wl=None, seed=0):
    """dmel_tpu's stacked params and batch statistics (its
    ``fit_trials``'s init: trial i from key ``seed + i``)."""
    sample = jnp.zeros((2, n_points), jnp.float32)
    variables = [jax.device_get(jmodels.get_model_by_config(
        c, window_length=wl).init(jax.random.PRNGKey(seed + i), sample))
        for i, c in enumerate(cfgs)]
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    params = jax.tree.map(stack, *[v["params"] for v in variables])
    stats = (jax.tree.map(stack, *[v["batch_stats"] for v in variables])
             if "batch_stats" in variables[0] else None)
    return params, stats


def _port_pack(cfgs, params, stats, wl=None):
    """The port's pack loaded with dmel_tpu's stacked state."""
    models = []
    for i, c in enumerate(cfgs):
        m = tmodels.get_model_by_config(c, window_length=wl, device="cpu")
        m.load_state_dict(from_jax_variables(
            jax_trial(params, i),
            None if stats is None else jax_trial(stats, i)))
        models.append(m)
    return tpacked.TrialPack(models)


def _both_packs(cfgs, n_points, wl=None, seed=0):
    """dmel_tpu's stacked state and the port's pack loaded with it."""
    params, stats = _jax_state(cfgs, n_points, wl, seed)
    return params, stats, _port_pack(cfgs, params, stats, wl)


def _rates(cfgs, jparams, pack):
    lrs_j = [jtrials._lr_tree(jax_trial(jparams, i),
                              c["lr_tf"] if c["trainable"] else 0.0,
                              c["lr_model"]) for i, c in enumerate(cfgs)]
    lrs_j = jax.tree.map(lambda *xs: jnp.asarray(xs, jnp.float32), *lrs_j)
    lrs_t = [ttrials._lr_tree(pack.params,
                              c["lr_tf"] if c["trainable"] else 0.0,
                              c["lr_model"]) for c in cfgs]
    lrs_t = {n: torch.tensor([lr[n] for lr in lrs_t]) for n in pack.params}
    return lrs_j, lrs_t


def _run_both(cfgs, n_points, batches, active, opt_name, one_hot,
              n_classes, wl=None):
    """The packed steps on ``batches`` in each package from the same
    state: dmel_tpu's params, stats, metrics and optimizer state, the
    port's pack, metrics and optimizer, its initial params and each
    step's gradients."""
    jparams, jstats = _jax_state(cfgs, n_points, wl)
    jmodel = jmodels.get_model_by_config(cfgs[0], window_length=wl)
    base = {"sgd": optax.sgd, "adam": optax.adam}[opt_name](1.0)
    jstep = jtrials.make_multitrial_step(jmodel, base, one_hot, n_classes)
    pack = _port_pack(cfgs, jparams, jstats, wl)
    p0 = {n: t.detach().clone() for n, t in pack.params.items()}
    lrs_j, lrs_t = _rates(cfgs, jparams, pack)
    opt_state = jax.vmap(base.init)(jparams)
    rngs = jax.random.split(jax.random.PRNGKey(1), len(cfgs))
    p, s = jparams, jstats
    opt = PackedOptimizer(opt_name, pack.params, lrs_t)
    tstep = ttrials.make_multitrial_step(pack, opt, one_hot, n_classes)
    act_t = torch.tensor(active)
    grads = []
    for xs, ys, mask in batches:
        p, opt_state, s, rngs, jm = jstep(
            p, opt_state, s, lrs_j, jnp.asarray(active), rngs,
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask))
        tm = tstep(act_t, torch.from_numpy(xs), torch.from_numpy(ys),
                   torch.from_numpy(mask))
        grads.append({n: q.grad.clone() for n, q in pack.params.items()})
    return (jax.device_get(p), jax.device_get(s), jm,
            jax.device_get(opt_state), pack, tm, opt, p0, grads)


def _batches(k, b, n_points, n_classes, n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xs = rng.standard_normal((k, b, n_points)).astype(np.float32)
        ys = rng.integers(0, n_classes, (k, b)).astype(np.int32)
        mask = np.ones((k, b), bool)
        mask[:, -1] = False
        out.append((xs, ys, mask))
    return out


def _pulse_batches(k, b, n_points, n=2):
    """dmel_tpu's time_frequency task (Gauss pulses in noise), shaped as
    :func:`_batches`'s."""
    out = []
    for i in range(n):
        d = jsynthetic.make_gauss_pulse_dataset(
            sigma=6.38, n_points=n_points, noise_std=0.5, n_samples=k * b,
            seed=i)
        mask = np.ones((k, b), bool)
        mask[:, -1] = False
        out.append((np.asarray(d.xs, np.float32).reshape(k, b, n_points),
                    np.asarray(d.ys, np.int32).reshape(k, b), mask))
    return out


#: every registry model but CNN6 (its own test below), at small sizes:
#: the mel probes on 256 samples (16 mels, 17 frames), the DSPEC probes
#: on dmel_tpu's time_frequency task at 64 samples (65 x 65 images)
STEP_MODELS = ["mel_linear_net", "mel_mlp_net", "mel_conv_net",
               "linear_net", "mlp_net", "bn_linear_net", "conv_net"]


def _optax_steps(params0, grads, lrs, active):
    """optax's ``adam(1.0)`` under ``jax.vmap`` from ``params0`` over the
    steps' ``grads`` (port names, (K, ...) tensors), each update scaled
    by the per-trial rates and ``active`` as dmel_tpu's packed step
    scales it: the parameters those gradients give there."""
    adam = optax.adam(1.0)
    tree = lambda d: {n: jnp.asarray(t.numpy())  # noqa: E731
                      for n, t in d.items()}
    params, act = tree(params0), jnp.asarray(active)
    state = jax.vmap(adam.init)(params)
    update = jax.jit(jax.vmap(adam.update))
    for g in grads:
        updates, state = update(tree(g), state)
        params = {n: params[n] + updates[n] * (jnp.asarray(lrs[n].numpy())
                                               * act).reshape(
            (-1,) + (1,) * (params[n].ndim - 1)) for n in params}
    return {n: torch.from_numpy(np.array(t)) for n, t in params.items()}


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("model_name", STEP_MODELS)
def test_multitrial_step_matches_jax(monkeypatch, model_name, opt_name):
    """Two packed steps of K 3 trials with differing lambda, lr_tf and
    trainable, one trainable trial inactive (dropout off in both
    packages), from the same converted stacked state: every batch
    statistic within 1e-5 of its largest entry of dmel_tpu's, the active
    trainable trial's lambda moved, the frozen and the inactive trial's
    unchanged, the inactive trial's statistics too.

    Under SGD every parameter is within 1e-5 of its largest entry of
    dmel_tpu's and the losses within relative 1e-5.  Adam's update
    ``m / (sqrt(v) + 1e-8)`` takes a gradient entry's float32 rounding to
    as much as a whole step where the entry is small or its two steps
    cancel, so under Adam the gradients are held through Adam's moments
    (every entry of both steps, within 1e-4 of the largest of optax's:
    dlambda's gate on the exact route), the parameters against optax's
    Adam applied to the port's own gradients (within 1e-5 of their
    largest entry), and the losses, the second of which reads the first
    update, within relative 1e-4.

    The mel probes read white noise; the DSPEC probes read dmel_tpu's
    time_frequency task (on white noise conv_net's two SGD steps at its
    rate diverge, loss 3 to 313, and amplify rounding past any gate)."""
    _no_dropout(monkeypatch)
    if model_name in ("linear_net", "mlp_net", "bn_linear_net", "conv_net"):
        base = dict(small_cfg(), model_name=model_name,
                    dataset_name="time_frequency", n_points=64,
                    hop_length=1)
        n_classes, batches = 3, _pulse_batches(3, 8, 64)
    else:
        base, n_classes = small_cfg(model_name=model_name), 10
        batches = _batches(3, 8, base["n_points"], n_classes)
    base["optimizer_name"] = opt_name
    cfgs = [dict(base, init_lambd=5.0, lr_tf=1.0, trainable=True),
            dict(base, init_lambd=8.0, lr_tf=0.5, trainable=True),
            dict(base, init_lambd=12.0, lr_tf=1.0, trainable=False)]
    active = [1.0, 0.0, 1.0]
    jp, js, jm, jopt, pack, tm, opt, p0, grads = _run_both(
        cfgs, base["n_points"], batches, active, opt_name, False, n_classes)
    want = {n: t for n, t in {
        **from_jax_stacked(jp),
        **({} if js is None else from_jax_stacked({}, js))}.items()
        if not n.endswith("num_batches_tracked")}
    got = {n: t.detach() for n, t in pack.state().items()
           if not n.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    if opt_name == "adam":
        for name, w in _optax_steps(p0, grads, opt.lrs, active).items():
            err = (got[name] - w).abs().max() / w.abs().max()
            assert float(err) <= 1e-5, (name, float(err))
        adam = jopt[0]
        for mine, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            for name, w in from_jax_stacked(theirs).items():
                err = (mine[name] - w).abs().max() / w.abs().max()
                assert float(err) <= 1e-4, (name, float(err))
    for name, t in got.items():
        if opt_name == "sgd" or name in pack.buffers:
            w = want[name]
            err = float((t - w).abs().max() / w.abs().max())
            assert err <= 1e-5, (name, err)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5 if opt_name == "sgd" else 1e-4)
    lam = pack.params["spectrogram_layer.lambd"].detach()
    assert float(lam[0]) != 5.0
    assert float(lam[1]) == 8.0 and float(lam[2]) == 12.0
    for name, t in got.items():         # dmel_tpu keeps the inactive init
        if name in pack.buffers:
            assert torch.equal(t[1], want[name][1]), name


def test_multitrial_step_matches_jax_cnn6(monkeypatch):
    """One packed step of float32 CNN6 (full widths, 2000 samples, the
    exact route at bucket 256), K 3, one trial inactive, dropout off,
    the gradients taken from dmel_tpu's step through an optax
    transformation that keeps them: ``test_train_step_matches_jax``'s
    tolerances on each trial (loss relative 1e-5; dlambda relative
    1e-2; every other gradient within 1e-2 in norm; running means within
    1e-5, running variances within 1e-5 relative), and the inactive
    trial's batch statistics unchanged, bit for bit."""
    _no_dropout(monkeypatch)
    base = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                n_points=2000, hop_length=80, optimized=True,
                normalize_window=False, n_mels=64, resample_rate=8000,
                energy_normalize=True, impl="xla", model_dtype="float32",
                optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
                trainable=True, batch_size=4)
    cfgs = [dict(base, init_lambd=20.0), dict(base, init_lambd=30.0),
            dict(base, init_lambd=40.0, trainable=False)]
    active = [1.0, 0.0, 1.0]
    capture = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))
    jparams, jstats, pack = _both_packs(cfgs, 2000, wl=256)
    stats0 = {n: b.clone() for n, b in pack.buffers.items()}
    jmodel = jmodels.get_model_by_config(cfgs[0], window_length=256)
    lrs_j, lrs_t = _rates(cfgs, jparams, pack)
    jstep = jtrials.make_multitrial_step(jmodel, capture, True, 10)
    (xs, ys, mask), = _batches(3, 4, 2000, 10, n=1, seed=2)
    mask[:] = True
    _, jgrads, jnew, _, jm = jstep(
        jparams, jax.vmap(capture.init)(jparams), jstats, lrs_j,
        jnp.asarray(active), jax.random.split(jax.random.PRNGKey(1), 3),
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask))
    jgrads = from_jax_stacked(jax.device_get(jgrads))
    jnew = from_jax_stacked({}, jax.device_get(jnew))
    opt = PackedOptimizer("adam", pack.params, lrs_t)
    tm = ttrials.make_multitrial_step(pack, opt, True, 10)(
        torch.tensor(active), torch.from_numpy(xs), torch.from_numpy(ys),
        torch.from_numpy(mask))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    lam = "spectrogram_layer.lambd"
    for i in range(3):
        g, w = pack.params[lam].grad[i], jgrads[lam][i]
        assert abs(float(g - w)) <= 1e-2 * abs(float(w)), i
        for name, p in pack.params.items():
            if name != lam:
                w = jgrads[name][i]
                assert float((p.grad[i] - w).norm() / w.norm()) <= 1e-2, name
    for name, b in pack.buffers.items():
        if name.endswith("num_batches_tracked"):
            continue
        assert torch.equal(b[1], stats0[name][1]), name
        for i in (0, 2):
            w = jnew[name][i]
            err = float((b[i] - w).abs().max())
            if name.endswith("running_var"):
                err /= float(w.abs().max())
            assert err <= 1e-5, (name, i)


@pytest.mark.parametrize("model_name", ["mel_conv_net", "bn_linear_net"])
def test_trials_do_not_leak(model_name):
    """Trial k of a K 3 pack after two SGD steps against a K 1 pack of
    trial k alone, from the same state and batches: every parameter and
    statistic within 1e-6 of its largest entry (relative).  Neither model
    has dropout, whose masks a pack of 3 and one of 1 draw apart; the
    grouped convolution, the batched products and the batch norm over
    (trial, channel) pairs are what is held."""
    if model_name == "bn_linear_net":
        base = dict(small_cfg(), model_name=model_name,
                    dataset_name="time_frequency", n_points=64, hop_length=1)
        n_classes = 3
    else:
        base, n_classes = small_cfg(model_name=model_name, n_mels=16), 10
    cfgs = [dict(base, init_lambd=lam, lr_tf=lr)
            for lam, lr in ((5.0, 1.0), (8.0, 0.5), (12.0, 0.1))]
    n_points = base["n_points"]
    batches = _batches(3, 8, n_points, n_classes)
    _, _, pack = _both_packs(cfgs, n_points)
    state0 = [pack.trial_state_dict(i) for i in range(3)]

    def run(idx):
        models = [tmodels.get_model_by_config(cfgs[i], device="cpu")
                  for i in idx]
        for m, i in zip(models, idx):
            m.load_state_dict(state0[i])
        p = tpacked.TrialPack(models)
        lrs = [ttrials._lr_tree(p.params, cfgs[i]["lr_tf"],
                                cfgs[i]["lr_model"]) for i in idx]
        opt = PackedOptimizer("sgd", p.params,
                              {n: torch.tensor([lr[n] for lr in lrs])
                               for n in p.params})
        step = ttrials.make_multitrial_step(p, opt, False, n_classes)
        for xs, ys, mask in batches:
            step(torch.ones(len(idx)), torch.from_numpy(xs[idx]),
                 torch.from_numpy(ys[idx]), torch.from_numpy(mask[idx]))
        return p

    full = run([0, 1, 2])
    for k in range(3):
        alone = run([k]).trial_state_dict(0)
        for name, t in full.trial_state_dict(k).items():
            w = alone[name].double()
            scale = max(float(w.abs().max()), 1e-30)
            assert float((t.double() - w).abs().max()) / scale <= 1e-6, (
                k, name)


# --- the packed forwards against the single models -----------------------

#: (model, config over small_cfg): each registry model at the small
#: sizes of the step tests above; CNN6 at 2000 samples (26 frames, the
#: fewest its four 2x2 poolings take), in float32 and in bf16
_DSPEC = dict(dataset_name="time_frequency", n_points=64, hop_length=1)
_CNN6 = dict(dataset_name="esc50_synth", n_points=2000, hop_length=80,
             optimized=True, n_mels=64, impl="xla")
FORWARD_CASES = [
    ("mel_linear_net", {}), ("mel_mlp_net", {}), ("mel_conv_net", {}),
    ("linear_net", _DSPEC), ("mlp_net", _DSPEC), ("bn_linear_net", _DSPEC),
    ("conv_net", _DSPEC),
    ("panns_cnn6", dict(_CNN6, model_dtype="float32")),
    ("panns_cnn6", dict(_CNN6, model_dtype="bfloat16")),
]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", FORWARD_CASES, ids=lambda c: (
    c[0] + ("-bf16" if c[1].get("model_dtype") == "bfloat16" else "")))
def test_packed_forward_matches_single_models(monkeypatch, case, training):
    """``TrialPack``'s forward (``models/packed.py``) against each
    trial's own model (``models/classifiers.py``, ``models/panns.py``)
    from the same weights, K 2 trials of differing lambda and seed, so
    that a change to one side fails here: each trial's logits (CNN6's
    clipwise scores) and features within 1e-5 of their largest entry; in
    training the batch statistics within 1e-5 of their largest entry
    and their counts equal.  Dropout is patched out on both sides (the
    pack draws its masks over the whole pack); SpecAugment is off."""
    name, over = case
    identity = lambda x, p, training, generator=None, dim=0: x  # noqa: E731
    for module in (tpanns, tpacked, tclassifiers):
        monkeypatch.setattr(module, "dropout", identity)
    cfg = dict(small_cfg(model_name=name), **over)
    wl = 256 if cfg["optimized"] else None
    cfgs = [dict(cfg, init_lambd=lam) for lam in (10.0, 14.0)]
    models = [tmodels.get_model_by_config(c, window_length=wl, seed=i,
                                          device="cpu")
              for i, c in enumerate(cfgs)]
    singles = [copy.deepcopy(m).train(training) for m in models]
    pack = tpacked.TrialPack(models).train(training)
    n = 4 if name == "panns_cnn6" else 8
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, n, cfg["n_points"])).astype(np.float32))
    with torch.no_grad():
        out, feats = pack(x)
        for i, single in enumerate(singles):
            want, want_s = single(x[i])
            err = (out[i] - want).abs().max() / want.abs().max()
            assert float(err) <= 1e-5, (i, float(err))
            err = (feats[i] - want_s).abs().max() / want_s.abs().max()
            assert float(err) <= 1e-5, (i, float(err))
            for key, b in single.named_buffers():
                got = pack.buffers[key][i]
                if key.endswith("num_batches_tracked"):
                    assert torch.equal(got, b), key
                else:
                    err = float((got - b).abs().max()) / max(
                        float(b.abs().max()), 1e-30)
                    assert err <= 1e-5, (key, err)


# --- fit_trials --------------------------------------------------------------

def test_fit_trials_runs_and_separates():
    """dmel_tpu's ``test_fit_trials_runs_and_separates``: trainable trials'
    lambdas move, the frozen one's stays, two records each."""
    configs = [small_cfg(init_lambd=5.0), small_cfg(init_lambd=20.0),
               small_cfg(init_lambd=20.0, trainable=False)]
    state, hists = ttrials.fit_trials(configs, toy(48), toy(16, seed=1),
                                      device="cpu")
    lam = state["pack"].params["spectrogram_layer.lambd"].detach()
    assert float(lam[0]) != pytest.approx(5.0)
    assert float(lam[1]) != pytest.approx(20.0)
    assert float(lam[2]) == 20.0
    assert [len(h["records"]) for h in hists] == [2, 2, 2]
    for h in hists:
        assert set(h["best_state"]) == set(state["pack"].state())


def test_fit_trials_per_trial_early_stopping():
    """dmel_tpu's ``test_fit_trials_per_trial_early_stopping``: a trial
    whose patience expires freezes (its lambda and records stop) while
    the other trains on to ``max_epochs``."""
    configs = [small_cfg(init_lambd=10.0, patience=1, lr_model=50.0,
                         max_epochs=6),
               small_cfg(init_lambd=10.0, patience=100, max_epochs=6)]
    state, hists = ttrials.fit_trials(configs, toy(48), toy(16, seed=1),
                                      device="cpu")
    assert hists[0]["converged"] and not hists[1]["converged"]
    assert len(hists[0]["records"]) < 6
    assert len(hists[1]["records"]) == 6
    assert hists[0]["records"][-1]["epoch"] < 5
    final = state["pack"].params["spectrogram_layer.lambd"].detach()
    assert float(final[0]) == pytest.approx(
        hists[0]["records"][-1]["lambd_est"], abs=1e-6)
    assert float(final[1]) != pytest.approx(10.0)


def test_fit_trials_makes_a_diverged_row_inert():
    """A trial whose lambda turns NaN (a NaN lr_tf) stops on its patience,
    gets its last finite estimate back (``diverged``) and no NaN reaches
    the other trial, whose records stay finite."""
    configs = [small_cfg(init_lambd=10.0, lr_tf=float("nan"), patience=1,
                         max_epochs=3),
               small_cfg(init_lambd=10.0, max_epochs=3)]
    state, hists = ttrials.fit_trials(configs, toy(48), toy(16, seed=1),
                                      device="cpu")
    lam = state["pack"].params["spectrogram_layer.lambd"].detach()
    assert hists[0]["diverged"] and hists[0]["converged"]
    assert float(lam[0]) == 10.0
    assert len(hists[0]["records"]) == 1
    assert "diverged" not in hists[1] and len(hists[1]["records"]) == 3
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["valid_loss"])
               for r in hists[1]["records"])


def test_fit_trials_refuses_mesh_and_mixed_configs():
    """Mixed shared keys, a model without a packed forward and trials that
    do not split over the mesh's ranks are refused (``ValueError``
    before any collective: the mesh record has no process group)."""
    with pytest.raises(ValueError, match="6 trials do not split over 4"):
        ttrials.fit_trials([small_cfg()] * 6, toy(16), toy(16),
                           mesh=tmesh.Mesh(("data",), 0, 4,
                                           torch.device("cpu")))
    with pytest.raises(ValueError, match="batch_size"):
        ttrials.fit_trials([small_cfg(), small_cfg(batch_size=8)], toy(16),
                           toy(16), device="cpu")
    with pytest.raises(NotImplementedError, match="packed forward"):
        tpacked.TrialPack([tpanns.Cnn14(10, 64)])


# --- the packed sweep -------------------------------------------------------

def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out += [os.path.normpath(os.path.join(rel, f)) for f in files]
    return sorted(out)


def test_packed_sweep_matches_jax_layout(tmp_path):
    """``run_sweep_packed`` on dmel_tpu's ``tiny_space`` (through
    ``--pack``) writes the files dmel_tpu's packed sweep writes (no
    sidecar beside ``best_model``) and ``results.csv``'s columns in
    dmel_tpu's order; each best model is a full single-trial state."""
    jsweep = jrunner.run_sweep_packed("tiny", 1, 1, str(tmp_path / "jax"),
                                      "/nonexistent", space=tiny_space())
    with pytest.MonkeyPatch.context() as mp:
        from dmel_tpu_torch.experiments import configs as tconfigs
        mp.setitem(tconfigs.SEARCH_SPACES, "tiny", lambda me: {
            k: (tconfigs.grid_search(v.values)
                if type(v).__name__ == "grid_search" else v)
            for k, v in tiny_space(me).items()})
        tcli.main(["--name", "tiny", "--num_samples", "1", "--max_epochs",
                   "1", "--output_dir", str(tmp_path / "torch"),
                   "--data_dir", "/nonexistent", "--pack", "--verbose", "0",
                   "--device", "cpu"])
    tsweep = str(tmp_path / "torch" / "tiny")
    assert _tree(tsweep) == _tree(jsweep)
    assert not any(f.endswith(".meta.json") for f in _tree(tsweep))
    import pandas as pd
    want = list(pd.read_csv(os.path.join(jsweep, "results.csv")).columns)
    rows = trunner.load_results(tsweep)
    assert len(rows) == 4 and list(rows[0]) == want
    model = tmodels.get_model_by_config(
        dict(tiny_space(), init_lambd=1.276, trainable=True), device="cpu")
    weights = load_checkpoint(os.path.join(
        tsweep, "trial_00000", "checkpoint_000000", "best_model"))["model"]
    model.load_state_dict(weights)


def test_convert_round_trips_a_jax_pack():
    """``from_jax_stacked`` is ``from_jax_variables`` of each trial's
    slice, stacked, for the params and for Adam's moments after a step
    (so a port pack can start from a JAX pack's optimizer state: the
    moments land on the port's names and layouts, ``(1 - b1) g`` and
    ``(1 - b2) g^2`` within float32 rounding); ``stack_state_dicts`` of
    the port's models is their pack's state."""
    cfgs = [small_cfg(init_lambd=5.0), small_cfg(init_lambd=9.0)]
    jparams, _, pack = _both_packs(cfgs, 256)
    stacked = from_jax_stacked(jparams)
    for i in range(2):
        one = from_jax_variables(jax_trial(jparams, i))
        for name, t in one.items():
            assert torch.equal(stacked[name][i], t)
    sds = [pack.trial_state_dict(i) for i in range(2)]
    for name, t in stack_state_dicts(sds).items():
        assert torch.equal(t, pack.state()[name].detach())
    assert all(torch.equal(pack.params[n].detach(), stacked[n])
               for n in stacked)
    # Adam's moments after one JAX step, converted, continue the port
    base = optax.adam(1.0)
    opt_state = jax.vmap(base.init)(jparams)
    grads = jax.tree.map(lambda a: 0.01 * np.sign(a) + 0.001, jparams)
    _, opt_state = jax.vmap(base.update)(grads, opt_state, jparams)
    adam = jax.device_get(opt_state[0])
    mu, nu = from_jax_stacked(adam.mu), from_jax_stacked(adam.nu)
    assert set(mu) == set(nu) == set(pack.params)
    for name, p in pack.params.items():
        assert mu[name].shape == nu[name].shape == p.shape
        g = from_jax_stacked(jax.device_get(grads))[name]
        assert torch.allclose(mu[name], 0.1 * g, rtol=1e-6)
        assert torch.allclose(nu[name], 0.001 * g * g, rtol=1e-5)
