"""The port's fused module (K5 forward, the torch adjoint backward)
against dmel_tpu's fused kernel, on the CPU; and the slice as a whole:
MelPANNsNet with JAX weights moved from the specband route to the framed
and the fused route.

The same numpy-seeded inputs go through both packages.  The JAX fused
kernel (Pallas interpret mode) runs its DFT in float32 and its backward
is the XLA adjoint, so the port is held to it as tightly as to the exact
routes, ten times inside bench.py's gates: log-mel max-abs <= 1e-5 and
dlambda relative <= 1e-4 (all float32; they differ in the order of the
sums).  Model features and scores: max-abs <= 1e-4 (bench.py's feature
gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu import ops as jops
from dmel_tpu.ops import stft as jstft
from dmel_tpu.ops.pallas import fused_dmel as jfu
from dmel_tpu_torch import from_jax_variables
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.ops import framed as tfr
from dmel_tpu_torch.ops import fused as tfu
from tests.test_torch_framed import emulate_fwd

GATE = 1e-4
EXACT_GATE = 1e-5
EXACT_GRAD_GATE = 1e-4
SR = 8000

# (T, win_length, n_fft, hop, n_mels): an optimized bucket, faithful
# mode's short window at n_fft = 2 T, one such n_fft that is not a lane
# multiple nor a multiple of the kernel's contraction step
CASES = [(1000, 128, 128, 20, 16), (128, 128, 256, 1, 32),
         (700, 700, 1400, 40, 32), (1500, 512, 512, 80, 64)]


def _log(a):
    return np.log(np.asarray(a) + 1e-10)


@pytest.mark.parametrize("win,n_fft", [(128, 128), (100, 256), (101, 256),
                                       (700, 1400)])
def test_pad_window_matches_jax(win, n_fft):
    w = np.linspace(0.1, 1.0, win).astype(np.float32)
    np.testing.assert_array_equal(
        tfu.pad_window(torch.from_numpy(w), n_fft).numpy(),
        np.asarray(jstft.pad_window(jnp.asarray(w), n_fft)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[2]}-w{c[1]}")
def test_forward_matches_jax_kernel_and_exact(rng, case):
    t, win, n_fft, hop, n_mels = case
    x = rng.standard_normal((3, t)).astype(np.float32)
    lam = win / 8.0
    kw = dict(win_length=win, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
              sample_rate=SR)
    kern = jfu.dmel_power(jnp.asarray(x), lam, interpret=True, **kw)
    opt = dict(optimized=win == n_fft, window_length=win)
    exact_j = jops.mel_spectrogram(
        jnp.asarray(x), lam, n_mels=n_mels, sample_rate=SR, hop_length=hop,
        method="matmul", subtract_mean=False, **opt)
    exact_t = tops.mel_spectrogram(
        x, lam, n_mels=n_mels, sample_rate=SR, hop_length=hop,
        subtract_mean=False, device="cpu", **opt)
    plain = tfu.dmel_power_plain(torch.from_numpy(x), lam, **kw)
    port = tfu.dmel_power(torch.from_numpy(x), lam, **kw)
    assert plain.shape == port.shape == kern.shape == (3, n_mels,
                                                       t // hop + 1)
    for got in (plain, port):
        lg = _log(got)
        assert float(np.max(np.abs(lg - _log(kern)))) <= EXACT_GATE
        assert float(np.max(np.abs(lg - _log(exact_j)))) <= EXACT_GATE
        assert float(np.max(np.abs(lg - _log(exact_t)))) <= EXACT_GATE


def _dlambd_port(x, lam, kw, cot):
    lam_t = torch.tensor(lam, requires_grad=True)
    mel = tops.mel_spectrogram(x, lam_t, impl="fused", log_output=True,
                               device="cpu", **kw)
    (mel * torch.from_numpy(cot)).sum().backward()
    return float(lam_t.grad)


def _dlambd_jax(x, lam, kw, cot, impl):
    def loss(l):
        mel = jops.mel_spectrogram(jnp.asarray(x), l, impl=impl, **kw)
        return jnp.sum(jnp.log(mel + 1e-10) * cot)
    return float(jax.grad(loss)(jnp.float32(lam)))


@pytest.mark.parametrize("t,win,hop,optimized,lam", [
    (2000, 512, 40, True, 60.0), (700, 700, 40, False, 150.0)])
def test_dlambda_matches_jax(rng, t, win, hop, optimized, lam):
    x = rng.standard_normal((2, t)).astype(np.float32)
    kw = dict(n_mels=32, sample_rate=SR, hop_length=hop, optimized=optimized,
              window_length=win if optimized else None)
    cot = rng.uniform(0.5, 1.5, (2, 32, t // hop + 1)).astype(np.float32)
    got = _dlambd_port(x, lam, kw, cot)
    kern = _dlambd_jax(x, lam, kw, cot, "pallas_fused")
    exact = _dlambd_jax(x, lam, kw, cot, "xla")
    assert abs(got - kern) <= EXACT_GRAD_GATE * abs(kern), (got, kern)
    assert abs(got - exact) <= EXACT_GRAD_GATE * abs(exact), (got, exact)


@pytest.mark.parametrize("case", CASES[1:3],
                         ids=lambda c: f"nfft{c[2]}-w{c[1]}")
def test_backward_matches_autograd_of_plain(rng, case):
    """The torch adjoint (dlambda through the window, and dx) against
    autograd of the plain version: relative 1e-5."""
    t, win, n_fft, hop, n_mels = case
    kw = dict(win_length=win, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
              sample_rate=SR)
    x = rng.standard_normal((2, t)).astype(np.float32)
    cot = torch.from_numpy(rng.uniform(0.5, 1.5, (2, n_mels, t // hop + 1))
                           .astype(np.float32))
    grads = []
    for fn in (tfu.dmel_power, tfu.dmel_power_plain):
        xt = torch.from_numpy(x).requires_grad_()
        lam = torch.tensor(win / 8.0, requires_grad=True)
        (fn(xt, lam, **kw) * cot).sum().backward()
        grads.append((lam.grad, xt.grad))
    (gl, gx), (pl, px) = grads
    assert abs(float(gl - pl)) <= 1e-5 * abs(float(pl))
    assert float((gx - px).abs().max() / px.abs().max()) <= 1e-5


@pytest.mark.parametrize("case", CASES[1:], ids=lambda c: f"nfft{c[2]}")
def test_k5_launcher_layout_matches_plain(rng, case):
    """K5 runs the framed forward's kernels through its second entry
    point: the same emulated launcher at faithful-mode geometries (an
    n_fft that is not a multiple of the contraction step, a window
    centred in n_fft)."""
    t, win, n_fft, hop, n_mels = case
    x = torch.from_numpy(rng.standard_normal((3, t)).astype(np.float32))
    w = tfu.pad_window(tops.gaussian_window(win / 8.0, win), n_fft)
    g = tfr.Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2))
    got, reim = emulate_fwd(x, w, g)
    want, reim_p = tfr.fwd_plain(x, w, g)
    assert float((reim - reim_p).abs().max() / reim_p.abs().max()) <= 1e-5
    assert float(np.max(np.abs(_log(got) - _log(want)))) <= EXACT_GATE


def test_wrapper_takes_plain_version_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((2, 700)).astype(np.float32))
    w = tfu.pad_window(tops.gaussian_window(80.0, 700), 1400)
    g = tfr.Geom(1400, 40, 32, SR, 0.0, float(SR // 2))
    before = tfu.dmel_power.launches
    out, reim = tfu.fused_fwd(x, w, g)
    want, want_reim = tfr.fwd_plain(x, w, g)
    assert torch.equal(out, want) and torch.equal(reim, want_reim)
    y = tfu.dmel_power(x.reshape(1, 2, 700), 80.0, win_length=700,
                       n_fft=1400, hop_length=40, n_mels=32, sample_rate=SR)
    assert y.shape == (1, 2, 32, 18)
    assert tfu.dmel_power.launches == before


def test_bad_inputs_raise(rng):
    x = torch.zeros((1, 2000))
    kw = dict(hop_length=80, n_mels=64, sample_rate=SR)
    with pytest.raises(ValueError, match="win_length"):
        tfu.dmel_power(x, 50.0, win_length=600, n_fft=512, **kw)
    with pytest.raises(ValueError, match="4096"):
        tfu.dmel_power(x, 50.0, win_length=8192, n_fft=8192, **kw)
    with pytest.raises(ValueError, match="win_length"):
        tfu.pad_window(torch.ones(10), 8)


def test_explicit_impl_matches_jax(rng):
    x = rng.standard_normal((2, 1200)).astype(np.float32)
    kw = dict(n_mels=32, sample_rate=SR, hop_length=16, optimized=True,
              window_length=256)
    want = jops.mel_spectrogram(jnp.asarray(x), 32.0, impl="pallas_fused",
                                **kw)
    got = tops.mel_spectrogram(x, 32.0, impl="fused", device="cpu", **kw)
    assert float(np.max(np.abs(_log(got) - _log(want)))) <= EXACT_GATE


@pytest.mark.parametrize("t,optimized,window_length,lam", [
    (2400, True, 8192, 900.0), (2100, False, None, 300.0)])
def test_explicit_impl_above_cap_takes_exact_route(rng, t, optimized,
                                                   window_length, lam):
    """Above the kernel's n_fft cap (the 8192 bucket, faithful mode's
    n_fft = 2 T > 4096) ``impl="fused"`` runs the exact route, as the
    JAX package's ``pallas_fused`` does."""
    x = rng.standard_normal((2, t)).astype(np.float32)
    kw = dict(n_mels=32, sample_rate=SR, hop_length=400, optimized=optimized,
              window_length=window_length)
    want = jops.mel_spectrogram(jnp.asarray(x), lam, impl="pallas_fused",
                                **kw)
    got = tops.mel_spectrogram(x, lam, impl="fused", device="cpu", **kw)
    exact = tops.mel_spectrogram(x, lam, impl="exact", device="cpu", **kw)
    assert torch.equal(got, exact)
    assert float(np.max(np.abs(_log(got) - _log(want)))) <= EXACT_GATE


# --- the slice as a whole ------------------------------------------------

T = 4000
MODEL_CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                    init_lambd=128.0, n_points=T, hop_length=80,
                    optimized=True, normalize_window=False, n_mels=64,
                    resample_rate=8000, energy_normalize=True, impl="pallas",
                    model_dtype="float32")


def test_mel_panns_net_moves_across_routes(rng, monkeypatch):
    """MelPANNsNet at the published CNN6 widths on short clips, with JAX
    weights crossed by ``from_jax_variables``: ``set_geometry`` moves the
    port's layer from specband (lambda 128) to framed (46.7, the 512
    bucket) to fused (300, the 2048 bucket), and each forward matches
    dmel_tpu's model built at the same geometry (its kernels in Pallas
    interpret mode)."""
    calls = {"framed": 0, "fused": 0}

    def spy(name, real):
        def call(*args):
            calls[name] += 1
            return real(*args)
        return call

    monkeypatch.setattr(tfr, "framed_fwd", spy("framed", tfr.framed_fwd))
    monkeypatch.setattr(tfu, "fused_fwd", spy("fused", tfu.fused_fwd))
    x = rng.standard_normal((2, T)).astype(np.float32)
    variables = None
    model = None
    for lam, route in ((128.0, "specband"), (46.7, "framed"),
                       (300.0, "fused")):
        wl = tops.bucketed_window_length(lam, T)
        hint = jstft.pallas_compile_hint(lam, wl, 80)
        assert tops.auto_route(signal_length=T, hop_length=80, n_mels=64,
                               optimized=True, window_length=wl,
                               lambd_hint=hint)[0] == route
        jmodel = jmodels.get_model_by_config(MODEL_CONFIG, window_length=wl,
                                             lambd_hint=hint)
        if variables is None:
            variables = jax.device_get(jmodel.init(
                jax.random.PRNGKey(0), jnp.zeros((2, T), jnp.float32)))
            model = tmodels.get_model_by_config(
                MODEL_CONFIG, window_length=wl, lambd_hint=hint,
                device="cpu").eval()
            model.load_state_dict(from_jax_variables(
                variables["params"], variables["batch_stats"]))
        variables["params"]["spectrogram_layer"]["lambd"] = np.float32(lam)
        with torch.no_grad():
            model.spectrogram_layer.lambd.fill_(lam)
        model.spectrogram_layer.set_geometry(wl, hint)
        out_j, s_j = jmodel.apply(variables, jnp.asarray(x), train=False)
        before = dict(calls)
        with torch.no_grad():
            out_t, s_t = model(torch.from_numpy(x))
        if route in calls:
            assert calls[route] == before[route] + 1
        assert float(np.max(np.abs(s_t.numpy() - np.asarray(s_j)))) <= GATE
        assert float(np.max(np.abs(out_t.numpy()
                                   - np.asarray(out_j)))) <= GATE
