"""Card-only tests of dmel_tpu_torch: the specband CUDA kernels (K1
forward, K2 the taps' gradient), the framed kernels (K3 forward, K4 the
window's gradient) and the fused forward (K5) against their plain
PyTorch versions at edge shapes, a train step through them, the GPU
rules of the entry points, and ``fit``'s precision flags and
reproducibility.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from dmel_tpu_torch import (build_optimizer, get_model_by_config, ops,
                            precision_scope)
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.ops import framed, fused, specband
from dmel_tpu_torch.training import fit, train_step

pytestmark = pytest.mark.gpu

#: log-mel max-abs gate, as in bench.py
GATE = 1e-4
#: dlambda relative gate, as in bench.py
GRAD_GATE = 1e-2
#: K2 against its plain version: max |error| over the largest tap's
#: gradient (fp32 sums over every frame row in another order)
DRHO_GATE = 1e-3
#: K4 against its plain version: max |error| over the largest entry of
#: the window's gradient, for the same reason
DW_GATE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _signal(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x - x.mean(-1, keepdims=True))


# (batch, T, n_fft, hop, n_mels, lambd, J): ragged frame counts, frame
# blocks that straddle batch rows, every bucket size the kernel takes
CASES = [
    (3, 1001, 256, 16, 32, 24.0, 12),
    (1, 500, 512, 40, 32, 64.0, 16),
    (5, 4000, 1024, 80, 64, 128.0, 24),
    (2, 3000, 2048, 80, 64, 250.0, 12),
    (2, 9000, 4096, 80, 64, 400.0, 12),
    (4, 2000, 384, 32, 40, 40.0, 24),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[2]}-b{c[0]}")
@pytest.mark.parametrize("log", [False, True])
def test_kernel_matches_plain(cuda, case, log):
    b, t, n_fft, hop, n_mels, lam, j = case
    x = _signal((b, t)).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=n_mels, sample_rate=8000,
              j_taps=j, log_epilogue=log)
    before = specband.specband_mel_power.launches
    got = specband.specband_mel_power(x, w, **kw)
    want = specband.specband_mel_power_plain(x, w, **kw)
    torch.cuda.synchronize()
    assert specband.specband_mel_power.launches == before + 1
    assert got.shape == want.shape == (b, n_mels, ops.num_frames(t, hop))
    assert torch.isfinite(got).all()
    if log:
        err = float((got - want).abs().max())
    else:
        err = float(((got - want).abs() / want.abs()).max())
    assert err <= GATE, err


def test_kernel_matches_cpu_plain(cuda):
    """The CUDA result against the plain version computed on the CPU."""
    x = _signal((2, 4000), seed=3)
    w = ops.gaussian_window(128.0, 1024)
    kw = dict(n_fft=1024, hop_length=80, n_mels=64, sample_rate=8000,
              j_taps=24, log_epilogue=True)
    got = specband.specband_mel_power(x.to(cuda), w.to(cuda), **kw).cpu()
    want = specband.specband_mel_power(x, w, **kw)
    assert float((got - want).abs().max()) <= GATE


def test_leading_dims_and_noncontiguous_input(cuda):
    x = _signal((2, 3, 2500)).to(cuda)
    xt = x.transpose(0, 1)                      # not contiguous
    w = ops.gaussian_window(torch.tensor(128.0, device=cuda), 1024)
    kw = dict(n_fft=1024, hop_length=80, n_mels=64, sample_rate=8000)
    got = specband.specband_mel_power(xt, w, **kw)
    want = specband.specband_mel_power_plain(xt, w, **kw)
    assert got.shape == (3, 2, 64, 32)
    assert float(((got - want).abs() / want.abs()).max()) <= GATE


def test_auto_route_uses_kernel(cuda):
    x = _signal((2, 4000)).to(cuda)
    hint = ops.pallas_compile_hint(128.0, 1024, 80)
    before = specband.specband_mel_power.launches
    got = ops.log_mel_spectrogram(
        x, 128.0, n_mels=64, sample_rate=8000, hop_length=80,
        optimized=True, window_length=1024, impl="auto", lambd_hint=hint)
    assert specband.specband_mel_power.launches == before + 1
    exact = ops.log_mel_spectrogram(
        x, 128.0, n_mels=64, sample_rate=8000, hop_length=80,
        optimized=True, window_length=1024, impl="exact")
    assert float((got - exact).abs().max()) <= GATE


def test_default_device_is_cuda(cuda):
    x = _signal((1, 2000))
    out = ops.mel_spectrogram(x, 20.0, n_mels=16, sample_rate=8000,
                              hop_length=40, optimized=True,
                              window_length=128)
    assert out.device.type == "cuda"


def _residual(cuda, case, log, seed=0):
    """K1's outputs and K2's operands at one geometry: (xext, rho, fb,
    dmel, logmel)."""
    b, t, n_fft, hop, n_mels, lam, j = case
    x = _signal((b, t), seed).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    rho = specband.window_taps_sym(w, n_fft, j)
    g = specband._Geom(n_fft, hop, n_mels, 8000, 0.0, 4000.0, j, log)
    out, xext = specband._fwd(x, rho, g)
    _, fb, _ = specband._consts(g, cuda)
    dmel = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(cuda)
    return xext, rho, fb, dmel, (out if log else None)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[2]}-b{c[0]}")
@pytest.mark.parametrize("log", [False, True])
def test_k2_matches_plain(cuda, case, log):
    ops_ = _residual(cuda, case, log)
    before = specband.specband_drho.launches
    got = specband.specband_drho(*ops_)
    again = specband.specband_drho(*ops_)
    want = specband.specband_drho_plain(*ops_)
    torch.cuda.synchronize()
    assert specband.specband_drho.launches == before + 2
    assert got.shape == want.shape == (2 * case[6] + 1,)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= DRHO_GATE, err


@pytest.mark.parametrize("log", [False, True])
def test_grad_on_specband_route_runs_k2(cuda, log):
    """d lambda through the specband route comes from K2 and matches
    autograd through the plain version (bench.py's gate)."""
    x = _signal((2, 4000)).to(cuda)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=1024, log_output=log)
    lam = torch.tensor(128.0, device=cuda, requires_grad=True)
    k1 = specband.specband_mel_power.launches
    k2 = specband.specband_drho.launches
    ops.mel_spectrogram(x, lam, impl="specband", **kw).sum().backward()
    assert specband.specband_mel_power.launches == k1 + 1
    assert specband.specband_drho.launches == k2 + 1
    lam_p = torch.tensor(128.0, device=cuda, requires_grad=True)
    xm = x - x.mean(-1, keepdim=True)
    specband.specband_mel_power_plain(
        xm, ops.gaussian_window(lam_p, 1024), n_fft=1024, hop_length=80,
        n_mels=64, sample_rate=8000, log_epilogue=log).sum().backward()
    assert abs(float(lam.grad - lam_p.grad)) <= GRAD_GATE * abs(
        float(lam_p.grad))


def test_dx_and_frozen_lambda(cuda):
    """dx comes from the plain rebuild; a frozen lambda launches no K2."""
    x = _signal((2, 3000)).to(cuda).requires_grad_()
    w = ops.gaussian_window(torch.tensor(128.0, device=cuda), 1024)
    kw = dict(n_fft=1024, hop_length=80, n_mels=64, sample_rate=8000,
              log_epilogue=True)
    dout = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 38)).astype(np.float32)).to(cuda)
    before = specband.specband_drho.launches
    (specband.specband_mel_power(x, w, **kw) * dout).sum().backward()
    assert specband.specband_drho.launches == before
    xp = x.detach().clone().requires_grad_()
    (specband.specband_mel_power_plain(xp, w, **kw) * dout).sum().backward()
    err = float((x.grad - xp.grad).abs().max() / xp.grad.abs().max())
    assert err <= 1e-4, err


def test_train_step_runs_both_kernels(cuda):
    config = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                  init_lambd=128.0, n_points=4000, hop_length=80,
                  optimized=True, normalize_window=False, n_mels=64,
                  resample_rate=8000, energy_normalize=True, impl="pallas",
                  optimizer_name="adam", lr_model=1e-4, lr_tf=1.0)
    hint = ops.pallas_compile_hint(128.0, 1024, 80)
    model = get_model_by_config(config, 1024, hint, device=cuda)
    opt = build_optimizer(config, model)
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs = _signal((4, 4000)).to(cuda)
    ys = torch.tensor([0, 3, 5, 9], device=cuda)
    mask = torch.ones(4, dtype=torch.bool, device=cuda)
    k1 = specband.specband_mel_power.launches
    k2 = specband.specband_drho.launches
    with precision_scope():
        m = train_step(model, opt, xs, ys, mask, one_hot=True, n_classes=10,
                       generator=gen)
    assert specband.specband_mel_power.launches == k1 + 1
    assert specband.specband_drho.launches == k2 + 1
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["energy"])
    assert model.spectrogram_layer.lambd.item() != 128.0


def test_train_step_gradients_match_cpu_float64(cuda, monkeypatch):
    """Gradients of one train step on the card (K1, K2, cuDNN in fp32,
    TF32 off) against the same weights on the CPU in float64 through the
    exact route: dlambda within relative 1e-2, every parameter within
    1e-2 in norm (single entries sit on ReLU boundaries at batch 4)."""
    from dmel_tpu_torch.models import panns
    from dmel_tpu_torch.training import loss_and_metrics
    monkeypatch.setattr(panns, "dropout",
                        lambda x, p, training, generator=None: x)
    config = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                  init_lambd=128.0, n_points=4000, hop_length=80,
                  optimized=True, normalize_window=False, n_mels=64,
                  resample_rate=8000, energy_normalize=True, impl="pallas")
    hint = ops.pallas_compile_hint(128.0, 1024, 80)
    model = get_model_by_config(config, 1024, hint, device=cuda).train()
    ref = get_model_by_config(dict(config, impl="xla"), 1024,
                              device="cpu").train()
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref.double()
    xs = _signal((4, 4000), seed=4)
    ys = torch.tensor([0, 3, 5, 9])
    mask = torch.ones(4, dtype=torch.bool)

    def grads(m, dev, dtype):
        loss, _, _ = loss_and_metrics(m, xs.to(dev, dtype), ys.to(dev),
                                      mask.to(dev), one_hot=True,
                                      n_classes=10)
        return dict(zip([k for k, _ in m.named_parameters()],
                        torch.autograd.grad(loss, list(m.parameters()))))

    before = specband.specband_drho.launches
    with precision_scope():
        got = grads(model, cuda, torch.float32)
    assert specband.specband_drho.launches == before + 1
    want = grads(ref, "cpu", torch.float64)
    lam = "spectrogram_layer.lambd"
    assert abs(float(got[lam]) - float(want[lam])) <= 1e-2 * abs(
        float(want[lam]))
    for key, g in got.items():
        g = g.cpu().double()
        err = float((g - want[key]).norm() / want[key].norm())
        assert err <= 1e-2, (key, err)


def test_bad_inputs_raise(cuda):
    w = ops.gaussian_window(torch.tensor(128.0, device=cuda), 1024)
    kw = dict(n_fft=1024, hop_length=80, n_mels=64, sample_rate=8000)
    with pytest.raises(TypeError):
        specband.specband_mel_power(
            torch.zeros((1, 2000), dtype=torch.float64, device=cuda),
            w.double(), **kw)
    with pytest.raises(ValueError):
        specband.specband_mel_power(torch.zeros((1, 2000), device=cuda),
                                    w.cpu(), **kw)
    xext, rho, fb, dmel, _ = _residual(cuda, CASES[2], False)
    with pytest.raises(TypeError):
        specband.specband_drho(xext, rho, fb, dmel.double())
    with pytest.raises(ValueError, match="contiguous"):
        specband.specband_drho(xext, rho, fb, dmel.transpose(1, 2))
    with pytest.raises(ValueError, match="inconsistent"):
        specband.specband_drho(xext, rho, fb, dmel[:1])


# --- framed (K3, K4) and fused (K5) ------------------------------------

# (batch, T, n_fft, hop, n_mels, lambd): ragged frame counts, 128-row GEMM
# blocks that straddle batch rows, every framed bucket
FRAMED_CASES = [
    (3, 1001, 128, 16, 32, 12.0),
    (2, 1500, 256, 32, 40, 30.0),
    (5, 4000, 512, 80, 64, 46.7),
    (1, 4000, 512, 80, 64, 30.0),
    (2, 4000, 1024, 80, 64, 150.0),
]
# (batch, T, win_length, n_fft, hop, n_mels, lambd): the fused buckets,
# and faithful mode's short window in an n_fft that is not a lane multiple
FUSED_CASES = [
    (2, 4000, 2048, 2048, 80, 64, 300.0),
    (2, 9000, 4096, 4096, 80, 64, 600.0),
    (3, 1500, 1500, 3000, 80, 64, 300.0),
    (2, 700, 700, 1400, 40, 32, 50.0),
]


def _framed_geom(case):
    b, t, n_fft, hop, n_mels, lam = case
    return framed.Geom(n_fft, hop, n_mels, 8000, 0.0, 4000.0)


@pytest.mark.parametrize("case", FRAMED_CASES,
                         ids=lambda c: f"nfft{c[2]}-b{c[0]}-lam{c[5]}")
def test_k3_matches_plain(cuda, case):
    b, t, n_fft, hop, n_mels, lam = case
    x = _signal((b, t)).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    g = _framed_geom(case)
    before = framed.framed_mel_power.launches
    out, reim = framed.framed_fwd(x, w, g)
    want, reim_p = framed.fwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert framed.framed_mel_power.launches == before + 1
    assert out.shape == want.shape == (b, n_mels, ops.num_frames(t, hop))
    assert reim.shape == reim_p.shape
    assert torch.isfinite(out).all()
    err = float((torch.log(out + 1e-10) - torch.log(want + 1e-10)).abs()
                .max())
    assert err <= GATE, err
    assert float((reim - reim_p).abs().max()
                 / reim_p.abs().max()) <= 1e-5
    n_bins, kp = n_fft // 2 + 1, framed.kp_of(n_fft)
    assert not reim[:, n_bins:kp].any() and not reim[:, kp + n_bins:].any()


@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=lambda c: f"nfft{c[3]}-win{c[2]}-b{c[0]}")
def test_k5_matches_plain(cuda, case):
    b, t, win, n_fft, hop, n_mels, lam = case
    x = _signal((b, t)).to(cuda)
    kw = dict(win_length=win, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
              sample_rate=8000)
    lam_t = torch.tensor(lam, device=cuda)
    before = fused.dmel_power.launches
    got = fused.dmel_power(x, lam_t, **kw)
    want = fused.dmel_power_plain(x, lam_t, **kw)
    exact = ops.mel_spectrogram(
        x, lam, n_mels=n_mels, sample_rate=8000, hop_length=hop,
        optimized=win == n_fft, window_length=n_fft, subtract_mean=False,
        impl="exact")
    torch.cuda.synchronize()
    assert fused.dmel_power.launches == before + 1
    assert got.shape == want.shape == (b, n_mels, ops.num_frames(t, hop))
    lg = torch.log(got + 1e-10)
    assert float((lg - torch.log(want + 1e-10)).abs().max()) <= GATE
    assert float((lg - torch.log(exact + 1e-10)).abs().max()) <= GATE


def _k4_operands(cuda, case, seed=0):
    b, t, n_fft, hop, n_mels, lam = case
    x = _signal((b, t), seed).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    g = _framed_geom(case)
    out, reim = framed.framed_fwd(x, w, g)
    dmel = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(cuda)
    return x, reim, dmel, g


@pytest.mark.parametrize("case", FRAMED_CASES,
                         ids=lambda c: f"nfft{c[2]}-b{c[0]}-lam{c[5]}")
def test_k4_matches_plain(cuda, case):
    x, reim, dmel, g = _k4_operands(cuda, case)
    before = framed.framed_dwindow.launches
    got = framed.framed_dwindow(x, reim, dmel, g)
    again = framed.framed_dwindow(x, reim, dmel, g)
    want = framed.framed_dwindow_plain(x, reim, dmel, g)
    torch.cuda.synchronize()
    assert framed.framed_dwindow.launches == before + 2
    assert got.shape == want.shape == (case[2],)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= DW_GATE, err


def _dlambda(x, lam, impl, n_fft, hop, n_mels, log=True):
    lam = torch.tensor(lam, device=x.device, requires_grad=True)
    ops.mel_spectrogram(
        x, lam, n_mels=n_mels, sample_rate=8000, hop_length=hop,
        optimized=True, window_length=n_fft, impl=impl,
        log_output=log).sum().backward()
    return float(lam.grad)


@pytest.mark.parametrize("impl,n_fft,lam", [
    ("framed", 512, 46.7), ("framed", 1024, 150.0), ("framed", 512, 30.0),
    ("fused", 2048, 300.0), ("fused", 4096, 600.0)])
def test_dlambda_through_kernels(cuda, impl, n_fft, lam):
    """dlambda through the framed route (K3, K4) or the fused route (K5,
    torch adjoint) against the exact route (bench.py's gate), and the
    launches it makes."""
    x = _signal((2, 6000)).to(cuda)
    counters = {"framed": (framed.framed_mel_power, framed.framed_dwindow),
                "fused": (fused.dmel_power,)}[impl]
    before = [c.launches for c in counters]
    got = _dlambda(x, lam, impl, n_fft, 80, 64)
    assert [c.launches for c in counters] == [n + 1 for n in before]
    want = _dlambda(x, lam, "exact", n_fft, 80, 64)
    assert abs(got - want) <= GRAD_GATE * abs(want), (got, want)
    assert got == _dlambda(x, lam, impl, n_fft, 80, 64)


@pytest.mark.parametrize("lam,n_fft,route,counter", [
    (46.7, 512, "framed", framed.framed_mel_power),
    (30.0, 512, "framed", framed.framed_mel_power),
    (150.0, 1024, "framed", framed.framed_mel_power),
    (300.0, 2048, "fused", fused.dmel_power),
    (600.0, 4096, "fused", fused.dmel_power)])
def test_auto_route_uses_framed_and_fused_kernels(cuda, lam, n_fft, route,
                                                  counter):
    x = _signal((2, 6000)).to(cuda)
    hint = ops.pallas_compile_hint(lam, n_fft, 80)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=n_fft)
    assert ops.auto_route(signal_length=6000, hop_length=80, n_mels=64,
                          optimized=True, window_length=n_fft,
                          lambd_hint=hint)[0] == route
    before = counter.launches
    got = ops.log_mel_spectrogram(x, lam, impl="auto", lambd_hint=hint, **kw)
    assert counter.launches == before + 1
    exact = ops.log_mel_spectrogram(x, lam, impl="exact", **kw)
    assert float((got - exact).abs().max()) <= GATE


def test_faithful_auto_route_uses_fused_kernel(cuda):
    x = _signal((2, 1500)).to(cuda)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=False)
    assert ops.auto_route(signal_length=1500, hop_length=80, n_mels=64,
                          optimized=False, window_length=None,
                          lambd_hint=300.0)[0] == "fused"
    before = fused.dmel_power.launches
    got = ops.log_mel_spectrogram(x, 300.0, impl="auto", lambd_hint=300.0,
                                  **kw)
    assert fused.dmel_power.launches == before + 1
    exact = ops.log_mel_spectrogram(x, 300.0, impl="exact", **kw)
    assert float((got - exact).abs().max()) <= GATE


@pytest.mark.parametrize("impl,n_fft,lam", [
    ("specband", 1024, 128.0), ("framed", 512, 46.7), ("fused", 4096, 600.0)])
def test_kernel_routes_do_not_synchronise(cuda, impl, n_fft, lam):
    """Forward and backward into lambda through each kernel route issue
    no operation that makes the host wait for the card, once the
    route's constants are on the card."""
    x = _signal((2, 6000)).to(cuda)
    lam_t = torch.tensor(lam, device=cuda, requires_grad=True)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=n_fft, impl=impl)

    def run():
        ops.log_mel_spectrogram(x, lam_t, **kw).sum().backward()

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_explicit_fused_above_cap_takes_exact_route(cuda):
    """``impl="fused"`` at the 8192 bucket runs the exact route, as the
    JAX package's ``pallas_fused`` does, and launches no K5."""
    x = _signal((2, 9000)).to(cuda)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=8192)
    before = fused.dmel_power.launches
    got = ops.mel_spectrogram(x, 900.0, impl="fused", **kw)
    assert fused.dmel_power.launches == before
    assert torch.equal(got, ops.mel_spectrogram(x, 900.0, impl="exact", **kw))


def test_framed_dx_and_frozen_lambda(cuda):
    """dx comes from the plain rebuild; a frozen window launches no K4."""
    x = _signal((2, 3000)).to(cuda).requires_grad_()
    w = ops.gaussian_window(torch.tensor(46.7, device=cuda), 512)
    kw = dict(n_fft=512, hop_length=80, n_mels=64, sample_rate=8000)
    dout = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 38)).astype(np.float32)).to(cuda)
    before = framed.framed_dwindow.launches
    (framed.framed_mel_power(x, w, **kw) * dout).sum().backward()
    assert framed.framed_dwindow.launches == before
    xp = x.detach().clone().requires_grad_()
    (framed.framed_mel_power_plain(xp, w, **kw) * dout).sum().backward()
    err = float((x.grad - xp.grad).abs().max() / xp.grad.abs().max())
    assert err <= 1e-4, err


def test_framed_and_fused_bad_inputs_raise(cuda):
    w = ops.gaussian_window(torch.tensor(46.7, device=cuda), 512)
    kw = dict(n_fft=512, hop_length=80, n_mels=64, sample_rate=8000)
    with pytest.raises(TypeError):
        framed.framed_mel_power(
            torch.zeros((1, 2000), dtype=torch.float64, device=cuda), w, **kw)
    with pytest.raises(ValueError):
        framed.framed_mel_power(torch.zeros((1, 2000), device=cuda),
                                w.cpu(), **kw)
    with pytest.raises(ValueError):
        fused.dmel_power(torch.zeros((1, 2000), device=cuda), 46.7,
                         win_length=600, n_fft=512, hop_length=80,
                         n_mels=64, sample_rate=8000)
    x, reim, dmel, g = _k4_operands(cuda, FRAMED_CASES[2])
    with pytest.raises(TypeError):
        framed.framed_dwindow(x, reim, dmel.double(), g)
    with pytest.raises(ValueError, match="contiguous"):
        framed.framed_dwindow(x, reim, dmel.transpose(1, 2), g)
    with pytest.raises(ValueError, match="inconsistent"):
        framed.framed_dwindow(x, reim, dmel[:1], g)


# --- fit: precision flags and reproducibility -------------------------

FIT_CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                  init_lambd=46.7, n_points=4096, hop_length=80,
                  optimized=True, normalize_window=False, n_mels=64,
                  resample_rate=8000, energy_normalize=True, impl="pallas",
                  optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
                  trainable=True, batch_size=8, max_epochs=2, patience=100,
                  n_samples=64, data_seed=0, sigma_ref=8000 * 0.035 / 6,
                  noise_std=0.05)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def test_fit_sets_and_restores_precision_flags(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    outside = _flags()
    inside = []
    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    fit(dict(FIT_CONFIG, max_epochs=1), trainset, validset, device=cuda,
        report_fn=lambda record: inside.append(_flags()))
    assert inside == [(False, False, True, False)]
    assert _flags() == outside


def test_fit_is_reproducible(cuda):
    """Two seeded fits on the framed route (lambda 46.7, the 512 bucket):
    the same lambda after every epoch and the same weights, bit for bit."""
    trainset, validset, _ = get_dataset_by_config(FIT_CONFIG)
    runs = []
    for _ in range(2):
        before = framed.framed_dwindow.launches
        state, history = fit(FIT_CONFIG, trainset, validset, seed=0,
                             device=cuda)
        assert framed.framed_dwindow.launches > before
        runs.append(([r["lambd_est"] for r in history["records"]],
                     state["model"].state_dict()))
    (lam_a, sd_a), (lam_b, sd_b) = runs
    assert lam_a == lam_b
    assert lam_a[-1] != FIT_CONFIG["init_lambd"]
    for key, value in sd_a.items():
        assert torch.equal(value, sd_b[key]), key
