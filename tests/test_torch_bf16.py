"""The port's bf16 CNN6 (``model_dtype="bfloat16"``) against dmel_tpu's
bf16 model, on the CPU.

Both packages run the conv stack in bf16 with float32 parameters,
batch-norm statistics, front end and head.  bf16 keeps 8 bits of
mantissa, and the two packages round at different points (XLA fuses
elementwise chains, torch rounds after every operator), so outputs are
compared within bf16's tolerances and gradients by their norms.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu.ops.stft import pallas_compile_hint
from dmel_tpu.training import train as jtrain
from dmel_tpu_torch import build_optimizer, from_jax_variables
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.models import panns as tpanns
from dmel_tpu_torch.training import train as ttrain

T = 4000
WINDOW = 1024
HINT = pallas_compile_hint(128.0, WINDOW, 80)
CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
              init_lambd=128.0, n_points=T, hop_length=80, optimized=True,
              normalize_window=False, n_mels=64, resample_rate=8000,
              energy_normalize=True, impl="pallas", model_dtype="bfloat16",
              optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
              trainable=True)
LAM = "spectrogram_layer.lambd"


def _perturbed(tree, rng, fn):
    return {k: _perturbed(v, rng, fn) if isinstance(v, dict)
            else fn(k, np.asarray(v), rng) for k, v in tree.items()}


def _jax_variables(model, batch, t, seed=0):
    """dmel_tpu's init of ``model``, its batch-norm parameters and
    statistics moved off their trivial init."""
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((batch, t))))
    rng = np.random.default_rng(seed)
    params = _perturbed(variables["params"], rng, lambda k, a, r: (
        a if k in ("kernel", "lambd")
        else a + 0.1 * r.standard_normal(a.shape)).astype(np.float32))
    stats = _perturbed(variables["batch_stats"], rng, lambda k, a, r: (
        0.1 * r.standard_normal(a.shape) if k == "mean"
        else r.uniform(0.5, 2.0, a.shape)).astype(np.float32))
    return params, stats


def test_bf16_forward_matches_jax(rng):
    """Eval-mode forward of MelPANNsNet in bf16 on the specband route
    (dmel_tpu's kernel in interpret mode, the port's plain version):
    features (float32 in both) within 1e-4 max-abs, bench.py's gate;
    scores within 2e-3 max-abs (measured 2.1e-4: bf16 rounding, not
    the front end)."""
    jmodel = jmodels.get_model_by_config(CONFIG, window_length=WINDOW,
                                         lambd_hint=HINT)
    params, stats = _jax_variables(jmodel, 2, T)
    x = rng.standard_normal((4, T)).astype(np.float32)
    out_j, s_j = jmodel.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    model = tmodels.get_model_by_config(CONFIG, WINDOW, HINT, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats))
    model.eval()
    with torch.no_grad():
        out_t, s_t = model(torch.from_numpy(x))
    assert s_t.dtype == out_t.dtype == torch.float32
    s_err = float(np.abs(s_t.numpy() - np.asarray(s_j)).max())
    out_err = float(np.abs(out_t.numpy() - np.asarray(out_j)).max())
    print(f"bf16 forward: features {s_err:.3e}, scores {out_err:.3e}")
    assert s_err <= 1e-4
    assert out_err <= 2e-3


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


#: the train-step comparison: 16 esc50_synth clips of 5 s at lambda 128 on
#: the exact route (the front end is float32 in both packages and tested
#: elsewhere; this holds the bf16 conv stack)
STEP_B, STEP_T = 16, 40000
STEP_CONFIG = dict(CONFIG, impl="xla", n_points=STEP_T)


@pytest.fixture(scope="module")
def bf16_steps():
    """One bf16 train step of dmel_tpu and of the port from the same
    weights and batch, dropout off on both sides (the packages draw
    their masks from different generators); the port's float32 step
    beside them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn, "Dropout", _NoDropout)
        mp.setattr(tpanns, "dropout",
                   lambda x, p, training, generator=None: x)
        trainset, _, _ = get_dataset_by_config(dict(
            STEP_CONFIG, n_samples=40, data_seed=0,
            sigma_ref=8000 * 0.035 / 6, noise_std=0.05))
        x = np.ascontiguousarray(trainset.xs[:STEP_B])
        ys = trainset.ys[:STEP_B].astype(np.int32)
        mask = np.ones(STEP_B, bool)
        jmodel = jmodels.get_model_by_config(STEP_CONFIG,
                                             window_length=WINDOW)
        variables = jax.device_get(jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((STEP_B, STEP_T))))
        params, stats = variables["params"], variables["batch_stats"]
        capture = _grad_capture()
        step = jtrain.make_train_step(jmodel, capture, True, 10)
        _, grads, _, _, metrics = step(
            params, capture.init(params), stats, jax.random.PRNGKey(1),
            jnp.asarray(x), jnp.asarray(ys), jnp.asarray(mask))
        want = from_jax_variables(jax.device_get(grads))

        got = {}
        for dtype in ("bfloat16", "float32"):
            model = tmodels.get_model_by_config(
                dict(STEP_CONFIG, model_dtype=dtype), WINDOW, device="cpu")
            model.load_state_dict(from_jax_variables(params, stats))
            opt = build_optimizer(STEP_CONFIG, model)
            out = ttrain.train_step(model, opt, torch.from_numpy(x),
                                    torch.from_numpy(ys),
                                    torch.from_numpy(mask), one_hot=True,
                                    n_classes=10)
            got[dtype] = (float(out["loss"]),
                          {k: p.grad for k, p in model.named_parameters()})
        return float(metrics["loss"]), want, got


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_bf16_train_step_matches_jax(bf16_steps):
    """One bf16 train step against dmel_tpu's from the same weights and
    batch, by gradient norm per parameter:

    - the loss within relative 1e-3 (measured 3.8e-5);
    - every CNN6 parameter's gradient norm within relative 5e-2 of
      dmel_tpu's (measured at most 1.6e-2), and the gradient itself
      within 0.15 in norm (measured at most 8.8e-2: bf16 rounding, as
      far as each package's bf16 gradient lies from float32);
    - the port's bf16 gradient no farther from its float32 gradient than
      1.5 times dmel_tpu's (measured at most 1.2 times), so the port's
      casts lose no more than the reference's;
    - lambda's gradient within relative 0.25 of dmel_tpu's (measured
      8.6e-2).  It sums dL/ds ds/dlambda over every feature with heavy
      cancellation, and bf16 rounding in the conv stack moves it by 5-14
      % from float32 in either package at this batch.
    """
    want_loss, want, got = bf16_steps
    loss, grads = got["bfloat16"]
    _, grads32 = got["float32"]
    assert abs(loss - want_loss) <= 1e-3 * want_loss
    assert sorted(grads) == sorted(want)
    for key, g in grads.items():
        if key == LAM:
            continue
        assert abs(float(g.norm() / want[key].norm()) - 1) <= 5e-2, key
        assert _rel(g, want[key]) <= 0.15, key
        assert _rel(g, grads32[key]) <= 1.5 * _rel(want[key],
                                                   grads32[key]), key
    assert abs(float(grads[LAM] / want[LAM]) - 1) <= 0.25


def test_bf16_step_keeps_float32_state():
    """A bf16 train step (dropout on) leaves every parameter and
    batch-norm statistic float32 and updates the statistics; the front
    end's features, the head's input and the gradient into the features
    are float32, each conv block's output bf16."""
    model = tmodels.get_model_by_config(CONFIG, WINDOW, HINT,
                                        device="cpu").train()
    cnn = model.spectrogram_model
    assert cnn.conv_block1.dtype == torch.bfloat16
    seen = {}
    for name in ("conv_block1", "conv_block2", "conv_block3", "conv_block4",
                 "fc1"):
        getattr(cnn, name).register_forward_hook(
            lambda m, a, out, name=name: seen.__setitem__(
                name, (a[0].dtype, out.dtype)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, T)).astype(np.float32))
    out, s = model(x, torch.Generator().manual_seed(0))
    ds, = torch.autograd.grad(out.sum(), s)
    assert s.dtype == out.dtype == ds.dtype == torch.float32
    assert seen["conv_block1"] == (torch.float32, torch.bfloat16)
    for name in ("conv_block2", "conv_block3", "conv_block4"):
        assert seen[name] == (torch.bfloat16, torch.bfloat16), name
    assert seen["fc1"] == (torch.float32, torch.float32)

    opt = build_optimizer(CONFIG, model)
    ttrain.train_step(model, opt, x, torch.tensor([0, 1, 2, 3]),
                      torch.ones(4, dtype=torch.bool), one_hot=True,
                      n_classes=10, generator=torch.Generator().manual_seed(1))
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        assert value.dtype == torch.float32, key
        assert not torch.equal(value, before[key]), key


def test_dropout_masks_do_not_depend_on_the_dtype():
    """bf16 and float32 activations draw the same masks from the same
    generator state (the mask is drawn in float32)."""
    x = torch.rand((3, 8, 5, 7)) + 0.5
    a = tpanns.dropout(x, 0.2, True, torch.Generator().manual_seed(3))
    b = tpanns.dropout(x.bfloat16(), 0.2, True,
                       torch.Generator().manual_seed(3))
    assert b.dtype == torch.bfloat16
    assert torch.equal(a == 0, b == 0)
    assert 0 < int((a == 0).sum()) < x.numel()


@pytest.mark.parametrize("dtype,want", [("float32", None),
                                        ("bfloat16", torch.bfloat16)])
def test_registry_builds_model_dtype(dtype, want):
    model = tmodels.get_model_by_config(dict(CONFIG, model_dtype=dtype),
                                        WINDOW, device="cpu")
    cnn = model.spectrogram_model
    assert all(getattr(cnn, f"conv_block{i}").dtype is want
               for i in range(1, 5))
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_registry_refuses_unknown_model_dtype():
    with pytest.raises(ValueError, match="model_dtype"):
        tmodels.get_model_by_config(dict(CONFIG, model_dtype="float16"),
                                    WINDOW, device="cpu")
