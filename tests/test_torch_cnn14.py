"""The port's PANNs Cnn14, ConvBlock, AttBlock and pooling against
dmel_tpu's, on the CPU, through ``from_jax_variables``.

Cnn14 runs at its fixed widths (64 to 2048 channels, 527 classes) on a
tiny log-mel input, 2 clips x 64 frames x 64 mels, from dmel_tpu's init
with its batch-norm parameters and statistics moved off their trivial
values.  Dropout is off on both sides in training mode, since the two
packages draw their masks from different generators.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu.models import panns as jpanns
from dmel_tpu_torch import from_jax_variables
from dmel_tpu_torch.models import panns as tpanns

B, FRAMES, MELS = 2, 64, 64


def _perturbed(tree, rng, fn):
    return {k: _perturbed(v, rng, fn) if isinstance(v, dict)
            else fn(k, np.asarray(v), rng) for k, v in tree.items()}


def _jax_variables(model, x, seed=0):
    """dmel_tpu's init of ``model`` on ``x``, its batch-norm parameters
    and statistics moved off their trivial init."""
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                   x))
    rng = np.random.default_rng(seed)
    params = _perturbed(variables["params"], rng, lambda k, a, r: (
        a if k == "kernel" or a.ndim != 1
        else a + 0.1 * r.standard_normal(a.shape)).astype(np.float32))
    stats = _perturbed(variables.get("batch_stats", {}), rng,
                       lambda k, a, r: (
                           0.1 * r.standard_normal(a.shape) if k == "mean"
                           else r.uniform(0.5, 2.0, a.shape)).astype(
                               np.float32))
    return params, stats


class _NoDropout(nn.Module):
    rate: float = 0.0

    @nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def cnn14():
    """dmel_tpu's Cnn14, its variables, the port's Cnn14 holding them
    and an input ``(B, FRAMES, MELS)``."""
    jmodel = jpanns.Cnn14(classes_num=527, n_mels=MELS)
    params, stats = _jax_variables(jmodel, jnp.zeros((B, FRAMES, MELS, 1)))
    model = tpanns.Cnn14(527, MELS)
    model.load_state_dict(from_jax_variables(params, stats))
    x = np.random.default_rng(1).standard_normal(
        (B, FRAMES, MELS)).astype(np.float32)
    return jmodel, params, stats, model, x


def test_cnn14_parameters_match_jax(cnn14):
    """The same parameter and statistic names as dmel_tpu's (``bn0``,
    ``conv_block1..6`` with ``conv1``/``conv2``/``bn1``/``bn2``,
    ``fc1``, ``fc_audioset``) at the same shapes."""
    _, params, stats, model, _ = cnn14
    want = from_jax_variables(params, stats)
    got = tpanns.Cnn14(527, MELS).state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
    assert got["conv_block6.conv2.weight"].shape == (2048, 2048, 3, 3)
    assert got["fc_audioset.weight"].shape == (527, 2048)


def test_cnn14_eval_matches_jax(cnn14):
    """Eval-mode scores within 1e-4."""
    jmodel, params, stats, model, x = cnn14
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x[..., None]), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x[:, None]))
    assert got.shape == (B, 527)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_cnn14_train_statistics_match_jax(cnn14, monkeypatch):
    """One training-mode forward (dropout off): the scores within 1e-4,
    and every batch-norm statistic after it within 1e-4 of dmel_tpu's
    (the variances relative to the largest).  At ``conv_block6`` a
    channel has 2 x 2 x 2 = 8 values, so torch's unbiased update would
    miss by 1/7 there."""
    monkeypatch.setattr(nn, "Dropout", _NoDropout)
    monkeypatch.setattr(tpanns, "dropout",
                        lambda x, p, training, generator=None: x)
    jmodel, params, stats, _, x = cnn14
    want, updates = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x[..., None]),
        train=True, mutable=["batch_stats"])
    model = tpanns.Cnn14(527, MELS)
    model.load_state_dict(from_jax_variables(params, stats))
    got = model.train()(torch.from_numpy(x[:, None]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    new = from_jax_variables({}, jax.device_get(updates["batch_stats"]))
    sd = model.state_dict()
    for key, w in new.items():
        if key.endswith("num_batches_tracked"):
            continue
        err = float((sd[key] - w).abs().max() / w.abs().max())
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize("activation", ["linear", "sigmoid"])
def test_att_block_matches_jax(cnn14, activation):
    """AttBlock on Cnn14's frames (``Cnn14.frames``: (B, 2048, 2)):
    the clipwise output, the attention and ``cla`` within 1e-5 of
    dmel_tpu's on the same frames in its (B, time, C) layout;
    ``bn_att`` holds dmel_tpu's parameters and statistics."""
    _, _, _, model, x = cnn14
    with torch.no_grad():
        frames = model.eval().frames(torch.from_numpy(x[:, None]))
    assert frames.shape == (B, 2048, FRAMES // 32)
    jblock = jpanns.AttBlock(n_out=11, activation=activation)
    jframes = jnp.asarray(frames.numpy().transpose(0, 2, 1))
    params, stats = _jax_variables(jblock, jframes)
    want = jblock.apply({"params": params, "batch_stats": stats}, jframes)
    block = tpanns.AttBlock(2048, 11, activation=activation)
    block.load_state_dict(from_jax_variables(params, stats))
    with torch.no_grad():
        out, norm_att, cla = block(frames)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for got, w in ((norm_att, want[1]), (cla, want[2])):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                                   np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(norm_att.sum(dim=-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("pool_type", ["avg", "max", "avg+max"])
@pytest.mark.parametrize("pool_size", [(2, 2), (1, 1), (2, 1)])
def test_pool_matches_jax(pool_type, pool_size):
    x = np.random.default_rng(2).standard_normal(
        (2, 3, 9, 6)).astype(np.float32)
    want = jpanns._pool(jnp.asarray(x.transpose(0, 2, 3, 1)), pool_size,
                        pool_type)
    got = tpanns._pool(torch.from_numpy(x), pool_size, pool_type)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=1e-6)


def test_pool_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="pool_type"):
        tpanns._pool(torch.zeros(1, 1, 2, 2), (2, 2), "median")


@pytest.mark.parametrize("pool_type", ["avg", "max", "avg+max"])
def test_conv_block_matches_jax(pool_type):
    """ConvBlock (two 3x3 convolutions, batch norms, ReLUs, a pool) in
    eval mode within 1e-5, from dmel_tpu's variables."""
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 12, 10)).astype(np.float32)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    jblock = jpanns.ConvBlock(out_channels=8)
    params, stats = _jax_variables(jblock, jx)
    want = jblock.apply({"params": params, "batch_stats": stats}, jx,
                        pool_type=pool_type)
    block = tpanns.ConvBlock(3, 8)
    block.load_state_dict(from_jax_variables(params, stats))
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x), pool_type=pool_type)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=1e-5)


def test_cnn14_bf16_runs():
    """``dtype=torch.bfloat16``: the conv stack in bf16, the parameters,
    statistics and scores in float32, finite, within bf16's reach of the
    float32 model's (2e-2)."""
    x = torch.randn(B, 1, FRAMES, MELS,
                    generator=torch.Generator().manual_seed(4))
    f32 = tpanns.Cnn14(527, MELS, generator=torch.Generator().manual_seed(0))
    bf16 = tpanns.Cnn14(527, MELS, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        want, got = f32.eval()(x), bf16.eval()(x)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert float((got - want).abs().max()) <= 2e-2
