"""Card-only tests of dmel_tpu_torch: the specband CUDA kernels (K1
forward, K2 the taps' gradient, single- and multi-sigma), the framed
kernels (K3 forward, K4 the window's gradient) and the fused forward
(K5) and dw kernel (K6) against their plain PyTorch versions at edge
shapes and at AudioMNIST's batch of 64 one-second clips, train steps
through them, the GPU rules of the entry points, and ``fit``'s
precision flags, reproducibility (CNN6 and the audio_mnist space's mel
probe) and prefetching feed.

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
from dmel_tpu_torch.ops import fft_plan, framed, fused, specband
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
# blocks that straddle batch rows, every bucket size the kernel takes, and
# at 4096 more of K2's work items (32 rows x 128 bins) than its blocks
CASES = [
    (3, 1001, 256, 16, 32, 24.0, 12),
    (1, 500, 512, 40, 32, 64.0, 16),
    (5, 4000, 1024, 80, 64, 128.0, 24),
    (2, 3000, 2048, 80, 64, 250.0, 12),
    (2, 9000, 4096, 80, 64, 400.0, 12),
    (4, 2000, 384, 32, 40, 40.0, 24),
    (2, 3000, 896, 80, 64, 112.0, 24),
    (4, 40000, 4096, 80, 64, 400.0, 12),
    # AudioMNIST's batch of 64 one-second clips: the audio_mnist sweep's
    # 400 arms (4096) and its trainable 46.7 arm after it grows (1024,
    # then 2048)
    (64, 8000, 4096, 80, 64, 400.0, 12),
    (64, 8000, 2048, 80, 64, 172.95, 12),
    (64, 8000, 1024, 80, 64, 100.0, 12),
]


def _fft_planned(n_fft):
    """1 where the kernels take the FFT stage at ``n_fft``, else 0."""
    return int(fft_plan.plan(n_fft) is not None)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[2]}-b{c[0]}")
@pytest.mark.parametrize("log", [False, True])
def test_kernel_matches_plain(cuda, case, log):
    b, t, n_fft, hop, n_mels, lam, j = case
    x = _signal((b, t)).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=n_mels, sample_rate=8000,
              j_taps=j, log_epilogue=log)
    before = (specband.specband_mel_power.launches,
              specband.specband_mel_power.fft_launches)
    got = specband.specband_mel_power(x, w, **kw)
    want = specband.specband_mel_power_plain(x, w, **kw)
    torch.cuda.synchronize()
    # the FFT stage at every n_fft of CASES but 896 = 2^7 7 (direct DFT)
    assert (specband.specband_mel_power.launches,
            specband.specband_mel_power.fft_launches) == (
                before[0] + 1, before[1] + _fft_planned(n_fft))
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


@pytest.mark.parametrize("j", [4, 20, 40, 63])
def test_k2_other_tap_counts(cuda, j):
    """Tap counts off the dispatch's ladder (25, 33, 49) take the next
    larger instance of K2 with zero taps on both sides, or the generic one
    up to 127 taps: drho against the plain version on the plain spectra,
    bit-identical on repeat."""
    x = _signal((2, 3000)).to(cuda)
    w = ops.gaussian_window(torch.tensor(96.0, device=cuda), 1024)
    rho = specband.window_taps_sym(w, 1024, j)
    g = specband._Geom(1024, 80, 64, 8000, 0.0, 4000.0, j, True)
    out, xext = specband._fwd_plain(x, rho, g)
    _, fb, _ = specband._consts(g, cuda)
    dmel = _signal(tuple(out.shape), seed=5).to(cuda)
    got = specband.specband_drho(xext, rho, fb, dmel, out)
    again = specband.specband_drho(xext, rho, fb, dmel, out)
    want = specband.specband_drho_plain(xext, rho, fb, dmel, out)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2 * j + 1,)
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
# blocks that straddle batch rows, every framed bucket, and 896 (no FFT
# plan: the direct stage)
FRAMED_CASES = [
    (3, 1001, 128, 16, 32, 12.0),
    (2, 1500, 256, 32, 40, 30.0),
    (5, 4000, 512, 80, 64, 46.7),
    (1, 4000, 512, 80, 64, 30.0),
    (2, 4000, 1024, 80, 64, 150.0),
    (2, 3000, 896, 80, 64, 112.0),
    (64, 8000, 512, 80, 64, 46.7),             # AudioMNIST's batch
    (64, 8000, 1024, 80, 64, 150.0),
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
    counter = framed.framed_mel_power
    before = (counter.launches, counter.fft_launches)
    out, reim = framed.framed_fwd(x, w, g)
    want, reim_p = framed.fwd_plain(x, w, g)
    torch.cuda.synchronize()
    # the FFT stage at every n_fft but 896 = 2^7 7
    assert (counter.launches, counter.fft_launches) == (
        before[0] + 1, before[1] + _fft_planned(n_fft))
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
    before = (fused.dmel_power.launches, fused.dmel_power.fft_launches)
    got = fused.dmel_power(x, lam_t, **kw)
    want = fused.dmel_power_plain(x, lam_t, **kw)
    exact = ops.mel_spectrogram(
        x, lam, n_mels=n_mels, sample_rate=8000, hop_length=hop,
        optimized=win == n_fft, window_length=n_fft, subtract_mean=False,
        impl="exact")
    torch.cuda.synchronize()
    # the FFT stage at 2048, 4096 and 3000 (radices 4, 3, 5); the direct
    # DFT at 1400 = 2^3 5^2 7
    assert (fused.dmel_power.launches, fused.dmel_power.fft_launches) == (
        before[0] + 1, before[1] + _fft_planned(n_fft))
    assert got.shape == want.shape == (b, n_mels, ops.num_frames(t, hop))
    lg = torch.log(got + 1e-10)
    assert float((lg - torch.log(want + 1e-10)).abs().max()) <= GATE
    assert float((lg - torch.log(exact + 1e-10)).abs().max()) <= GATE


#: (kernel, n_fft, lambd, J): the FFT stage's residuals at the buckets
#: the auto dispatch takes it at
FFT_CASES = [(k, n, lam, j) for k in ("K1", "K5")
             for n, lam, j in ((1024, 128.0, 24), (2048, 250.0, 12),
                               (4096, 400.0, 12))]


@pytest.mark.parametrize("case", FFT_CASES, ids=lambda c: f"{c[0]}-nfft{c[1]}")
def test_fft_stage_residual_matches_plain(cuda, case):
    """K1's spectra buffer and K5's Re|Im residual from the FFT stage
    against the plain version (the direct DFT in torch) within 1e-5 of
    its largest entry, with exact zero pad columns, and bit-identical on
    repeat; the launches count on the FFT counter."""
    kernel, n_fft, lam, j = case
    x = _signal((2, 9000)).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    if kernel == "K1":
        g = specband._Geom(n_fft, 80, 64, 8000, 0.0, 4000.0, j, True)
        rho = specband.window_taps_sym(w, n_fft, j)
        counter = specband.specband_mel_power
        before = counter.fft_launches
        (_, got), (_, again) = specband._fwd(x, rho, g), specband._fwd(
            x, rho, g)
        _, want = specband._fwd_plain(x, rho, g)
        kp, width = specband._kp(n_fft, j), specband._geom(n_fft, j)[1]
    else:
        g = framed.Geom(n_fft, 80, 64, 8000, 0.0, 4000.0)
        counter = fused.dmel_power
        before = counter.fft_launches
        (_, got), (_, again) = fused.fused_fwd(x, w, g), fused.fused_fwd(
            x, w, g)
        _, want = framed.fwd_plain(x, w, g)
        kp, width = framed.kp_of(n_fft), n_fft // 2 + 1
    torch.cuda.synchronize()
    assert counter.fft_launches == before + 2
    assert got.shape == want.shape == (2 * ops.num_frames(9000, 80), 2 * kp)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err
    assert not got[:, width:kp].any() and not got[:, kp + width:].any()
    assert torch.equal(got, again)


def test_direct_stage_at_planned_nfft_and_bad_plans(cuda):
    """The direct stage, launched through the C entries at an n_fft the
    wrappers take the FFT for, computes the same function; a plan that is
    not one of n_fft / 2 is refused, never replaced."""
    x = _signal((2, 6000)).to(cuda)
    w = ops.gaussian_window(torch.tensor(128.0, device=cuda), 1024)
    g5 = framed.Geom(1024, 80, 64, 8000, 0.0, 4000.0)
    for entry, wrapper in (("fused_fwd", fused.fused_fwd),
                           ("framed_fwd", framed.framed_fwd)):
        out_d, reim_d = framed.launch_fwd(entry, x, w, g5, None)
        out_f, reim_f = wrapper(x, w, g5)
        assert float((reim_d - reim_f).abs().max()
                     / reim_f.abs().max()) <= 1e-5
        assert float((torch.log(out_d + 1e-10) - torch.log(out_f + 1e-10))
                     .abs().max()) <= GATE
    g1 = specband._Geom(1024, 80, 64, 8000, 0.0, 4000.0, 24, True)
    rho = specband.window_taps_sym(w, 1024, 24)
    out_d, xext_d = specband.launch_fwd(x, rho, g1, None)
    out_f, xext_f = specband._fwd(x, rho, g1)
    assert float((xext_d - xext_f).abs().max() / xext_f.abs().max()) <= 1e-5
    assert float((out_d - out_f).abs().max()) <= GATE
    dmel = _signal((2, 64, ops.num_frames(6000, 80)), seed=3).to(cuda)
    for bad in ((4, 4), (4, 4, 4, 4, 4, 2), (4, 4, 4, 4, 8), (7,) * 3):
        for entry in ("fused_fwd", "framed_fwd"):
            with pytest.raises(RuntimeError, match=f"{entry} launch failed"):
                framed.launch_fwd(entry, x, w, g5, bad)
        with pytest.raises(RuntimeError, match="specband_fwd launch failed"):
            specband.launch_fwd(x, rho, g1, bad)
        for entry in ("fused_bwd", "framed_bwd"):
            with pytest.raises(RuntimeError, match=f"{entry} launch failed"):
                framed.launch_bwd(entry, x, reim_f, dmel, g5, bad)


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
    """K4 against its plain version, on K3's residual: the inverse-FFT
    stage wherever n_fft has a plan (4 to 32 frames a block), counted on
    ``fft_launches``, the direct adjoint at 896; and the direct adjoint
    through K4's entry at every n_fft.  Bit-identical on repeat."""
    x, reim, dmel, g = _k4_operands(cuda, case)
    before = (framed.framed_dwindow.launches,
              framed.framed_dwindow.fft_launches)
    got = framed.framed_dwindow(x, reim, dmel, g)
    again = framed.framed_dwindow(x, reim, dmel, g)
    want = framed.framed_dwindow_plain(x, reim, dmel, g)
    direct = framed.launch_bwd("framed_bwd", x, reim, dmel, g, None)
    direct2 = framed.launch_bwd("framed_bwd", x, reim, dmel, g, None)
    torch.cuda.synchronize()
    fft = 2 * _fft_planned(g.n_fft)
    assert (framed.framed_dwindow.launches,
            framed.framed_dwindow.fft_launches) == (before[0] + 2,
                                                    before[1] + fft)
    assert fft == (0 if g.n_fft == 896 else 2)
    assert got.shape == want.shape == (case[2],)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= DW_GATE, err
    assert torch.equal(direct, direct2)
    err = float((direct - want).abs().max() / want.abs().max())
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
    ("specband", 1024, 128.0), ("framed", 512, 46.7), ("fused", 4096, 600.0),
    ("specband", 4096, 400.0), ("fused", 2048, 300.0)])
def test_kernel_routes_do_not_synchronise(cuda, impl, n_fft, lam):
    """Forward and backward into lambda through each kernel route issue
    no operation that makes the host wait for the card, once the
    route's constants are on the card; every forward takes the FFT
    stage."""
    x = _signal((2, 6000)).to(cuda)
    lam_t = torch.tensor(lam, device=cuda, requires_grad=True)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=n_fft, impl=impl)
    counter = {"specband": specband.specband_mel_power,
               "framed": framed.framed_mel_power,
               "fused": fused.dmel_power}[impl]

    def run():
        ops.log_mel_spectrogram(x, lam_t, **kw).sum().backward()

    run()
    torch.cuda.synchronize()
    before = counter.fft_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counter.fft_launches == before + 1


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


# --- multi-sigma K1/K2 (k_sig > 1) -------------------------------------

#: (k_sig, band map kind, batch, T, n_fft, lambdas' range, J)
MULTI_CASES = [
    (2, "contiguous", 3, 4000, 1024, (100.0, 128.0), 24),
    (4, "contiguous", 2, 4000, 1024, (100.0, 128.0), 24),
    (4, "scattered", 2, 4000, 1024, (100.0, 128.0), 24),
    (8, "contiguous", 2, 3000, 2048, (180.0, 250.0), 12),
    (8, "scattered", 1, 9000, 4096, (345.0, 500.0), 24),
    (3, "scattered", 3, 1001, 256, (28.0, 40.0), 24),
    (4, "contiguous", 4, 40000, 4096, (345.0, 400.0), 12),
    (4, "scattered", 2, 2000, 512, (40.0, 64.0), 16),
]


def _multi_operands(cuda, case, seed=0):
    k_sig, kind, b, t, n_fft, (lo, hi), j = case
    n_mels = 64 if n_fft >= 1024 else 32
    hop = 80 if n_fft >= 1024 else 16
    if kind == "contiguous":
        bm = tuple(int(v) for v in ops.default_band_map(n_mels, k_sig))
    else:   # interleaved groups; the last group gets no band
        bm = tuple((i * 5) % max(k_sig - 1, 1) for i in range(n_mels))
    x = _signal((b, t), seed).to(cuda)
    lams = torch.linspace(lo, hi, k_sig, device=cuda)
    ws = torch.stack([ops.gaussian_window(l, n_fft) for l in lams])
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=n_mels, sample_rate=8000,
              j_taps=j)
    return x, ws, bm, kw


@pytest.mark.parametrize("case", MULTI_CASES,
                         ids=lambda c: f"k{c[0]}-{c[1]}-nfft{c[4]}")
def test_k1_multi_matches_plain(cuda, case):
    x, ws, bm, kw = _multi_operands(cuda, case)
    before = (specband.specband_mel_power.launches,
              specband.specband_mel_power_multi.launches)
    got = specband.specband_mel_power_multi(x, ws, bm, **kw)
    want = specband.specband_mel_power_multi_plain(x, ws, bm, **kw)
    torch.cuda.synchronize()
    assert (specband.specband_mel_power.launches,
            specband.specband_mel_power_multi.launches) == (before[0],
                                                            before[1] + 1)
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    err = float((torch.log(got + 1e-10) - torch.log(want + 1e-10)).abs()
                .max())
    assert err <= GATE, err


def _multi_residual(cuda, case, seed=0):
    x, ws, bm, kw = _multi_operands(cuda, case, seed)
    g = specband._Geom(kw["n_fft"], kw["hop_length"], kw["n_mels"], 8000,
                       0.0, 4000.0, kw["j_taps"], False, bm)
    rho = specband.window_taps_sym(ws, kw["n_fft"], kw["j_taps"])
    out, xext = specband._fwd(x, rho, g)
    _, fb, _ = specband._consts(g, cuda)
    dmel = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(cuda)
    return xext, rho, fb, dmel, bm


@pytest.mark.parametrize("case", MULTI_CASES,
                         ids=lambda c: f"k{c[0]}-{c[1]}-nfft{c[4]}")
def test_k2_multi_matches_plain(cuda, case):
    xext, rho, fb, dmel, bm = _multi_residual(cuda, case)
    before = (specband.specband_drho.launches,
              specband.specband_drho.multi_launches)
    got = specband.specband_drho(xext, rho, fb, dmel, None, bm)
    again = specband.specband_drho(xext, rho, fb, dmel, None, bm)
    want = specband.specband_drho_plain(xext, rho, fb, dmel, None, bm)
    torch.cuda.synchronize()
    assert (specband.specband_drho.launches,
            specband.specband_drho.multi_launches) == (before[0],
                                                       before[1] + 2)
    assert got.shape == want.shape == rho.shape
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= DRHO_GATE, err


@pytest.mark.parametrize("log", [False, True])
def test_one_sigma_multi_launch_is_the_single_launch(cuda, log):
    """k_sig = 1 through the multi-sigma entry (a band map of zeros)
    gives the single-sigma kernels' results bit for bit: the same
    kernels, the same bin range, the same sums."""
    case = CASES[2]
    b, t, n_fft, hop, n_mels, lam, j = case
    x = _signal((b, t)).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    rho = specband.window_taps_sym(w, n_fft, j)
    g = specband._Geom(n_fft, hop, n_mels, 8000, 0.0, 4000.0, j, log)
    gm = g._replace(band_map=(0,) * n_mels)
    out, xext = specband._fwd(x, rho, g)
    out_m, xext_m = specband._fwd(x, rho[None], gm)
    assert torch.equal(out, out_m) and torch.equal(xext, xext_m)
    _, fb, _ = specband._consts(g, cuda)
    dmel = torch.ones_like(out)
    logmel = out if log else None
    d = specband.specband_drho(xext, rho, fb, dmel, logmel)
    d_m = specband.specband_drho(xext, rho[None], fb, dmel, logmel,
                                 gm.band_map)
    assert torch.equal(d, d_m[0])


def test_multi_dlambda_through_kernels(cuda):
    """dlambda (4,) through the multi-sigma route (K1, K2 at k_sig = 4)
    against the exact multi-sigma route, each group within bench.py's
    gate, and bit-identical on repeat."""
    x = _signal((2, 6000)).to(cuda)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=1024, lambd_hint=ops.pallas_compile_hint(
                  110.0, 1024, 80))

    def dlam(impl):
        lam = torch.tensor([100.0, 110.0, 120.0, 128.0], device=cuda,
                           requires_grad=True)
        mel = ops.multi_sigma_mel_spectrogram(x, lam, impl=impl, **kw)
        torch.log(mel + 1e-10).sum().backward()
        return lam.grad

    before = (specband.specband_mel_power_multi.launches,
              specband.specband_drho.multi_launches)
    got = dlam("auto")
    assert (specband.specband_mel_power_multi.launches,
            specband.specband_drho.multi_launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = dlam("exact")
    assert torch.all((got - want).abs() <= GRAD_GATE * want.abs()), (got,
                                                                     want)
    assert torch.equal(got, dlam("auto"))


def test_multi_train_step_runs_both_kernels(cuda):
    config = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                  init_lambd=128.0, n_points=4000, hop_length=80,
                  optimized=True, normalize_window=False, n_mels=64,
                  resample_rate=8000, energy_normalize=True, impl="pallas",
                  optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
                  n_sigma=4)
    hint = ops.pallas_compile_hint(128.0, 1024, 80)
    model = get_model_by_config(config, 1024, hint, device=cuda)
    opt = build_optimizer(config, model)
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs = _signal((4, 4000)).to(cuda)
    ys = torch.tensor([0, 3, 5, 9], device=cuda)
    mask = torch.ones(4, dtype=torch.bool, device=cuda)
    before = (specband.specband_mel_power_multi.launches,
              specband.specband_drho.multi_launches)
    with precision_scope():
        m = train_step(model, opt, xs, ys, mask, one_hot=True, n_classes=10,
                       generator=gen)
    assert (specband.specband_mel_power_multi.launches,
            specband.specband_drho.multi_launches) == (before[0] + 1,
                                                       before[1] + 1)
    lam = model.spectrogram_layer.lambd
    assert lam.shape == (4,) and bool((lam != 128.0).all())
    assert torch.isfinite(m["loss"])


# --- K6, the fused route's dw kernel ----------------------------------

@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=lambda c: f"nfft{c[3]}-win{c[2]}-b{c[0]}")
def test_k6_matches_plain(cuda, case):
    b, t, win, n_fft, hop, n_mels, lam = case
    x = _signal((b, t)).to(cuda)
    w = fused.pad_window(ops.gaussian_window(torch.tensor(lam, device=cuda),
                                             win), n_fft)
    g = framed.Geom(n_fft, hop, n_mels, 8000, 0.0, 4000.0)
    out, reim = fused.fused_fwd(x, w, g)
    dmel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(cuda)
    counter = fused.fused_dwindow
    before = (counter.launches, counter.fft_launches)
    got = fused.fused_dwindow(x, reim, dmel, g)
    again = fused.fused_dwindow(x, reim, dmel, g)
    want = framed.framed_dwindow_plain(x, reim, dmel, g)
    direct = framed.launch_bwd("fused_bwd", x, reim, dmel, g, None)
    torch.cuda.synchronize()
    # the inverse FFT at 2048, 4096 and 3000; the direct adjoint at 1400
    assert (counter.launches, counter.fft_launches) == (
        before[0] + 2, before[1] + 2 * _fft_planned(n_fft))
    assert got.shape == want.shape == (n_fft,)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    for dw in (got, direct):
        err = float((dw - want).abs().max() / want.abs().max())
        assert err <= DW_GATE, err


@pytest.mark.parametrize("n_fft,win,lam", [(2048, 2048, 300.0),
                                           (3000, 1500, 300.0)])
def test_fused_bwd_flag_runs_k6(cuda, monkeypatch, n_fft, win, lam):
    """With ``fused.USE_FUSED_BWD`` set, dlambda on the fused route comes
    from K6 and matches the flag-off dlambda (the torch adjoint) within
    bench.py's gate, bit-identical on repeat."""
    t = win if n_fft != win else 6000
    x = _signal((2, t)).to(cuda)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80,
              optimized=n_fft == win, window_length=n_fft if n_fft == win
              else None, impl="fused", log_output=True)

    def dlam():
        lam_t = torch.tensor(lam, device=cuda, requires_grad=True)
        ops.mel_spectrogram(x, lam_t, **kw).sum().backward()
        return lam_t.grad

    off = dlam()
    monkeypatch.setattr(fused, "USE_FUSED_BWD", True)
    before = fused.fused_dwindow.launches
    on = dlam()
    assert fused.fused_dwindow.launches == before + 1
    assert abs(float(on - off)) <= GRAD_GATE * abs(float(off))
    assert torch.equal(on, dlam())


@pytest.mark.parametrize("route", ["multi", "exact_multi", "fused_bwd"])
def test_new_routes_do_not_synchronise(cuda, monkeypatch, route):
    """Forward and backward into lambda through the multi-sigma routes
    (the specband kernels, and the exact route with its filterbank kept
    on the card) and through the fused route with K6 make the host wait
    for the card nowhere."""
    x = _signal((2, 6000)).to(cuda)
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True)
    if route.endswith("multi"):
        lam = torch.tensor([100.0, 110.0, 120.0, 128.0], device=cuda,
                           requires_grad=True)
        impl = "auto" if route == "multi" else "exact"

        def run():
            ops.multi_sigma_mel_spectrogram(
                x, lam, window_length=1024, impl=impl,
                lambd_hint=ops.pallas_compile_hint(110.0, 1024, 80),
                **kw).sum().backward()
    else:
        monkeypatch.setattr(fused, "USE_FUSED_BWD", True)
        lam = torch.tensor(600.0, device=cuda, requires_grad=True)

        def run():
            ops.log_mel_spectrogram(x, lam, window_length=4096, impl="fused",
                                    **kw).sum().backward()

    run()
    torch.cuda.synchronize()
    counters = {"multi": (specband.specband_mel_power_multi,),
                "exact_multi": (),
                "fused_bwd": (fused.dmel_power, fused.fused_dwindow)}[route]
    before = [c.fft_launches for c in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [c.fft_launches for c in counters] == [n + 1 for n in before]


def test_failed_launches_raise(cuda):
    """A geometry the kernels refuse raises on the card; the plain
    version is never returned in its place."""
    x, ws, bm, kw = _multi_operands(cuda, MULTI_CASES[1])
    n_fft, j = kw["n_fft"], kw["j_taps"]
    with pytest.raises(ValueError, match="too many sigma groups"):
        specband.specband_mel_power_multi(
            x, ws.repeat(3, 1)[:9], (0,) * kw["n_mels"], **kw)
    # nine groups past the Python guard: the C entry refuses the launch
    g = specband._Geom(n_fft, kw["hop_length"], kw["n_mels"], 8000, 0.0,
                       4000.0, j, False, tuple(i % 9 for i in
                                               range(kw["n_mels"])))
    rho = specband.window_taps_sym(ws.repeat(3, 1)[:9], n_fft, j)
    with pytest.raises(RuntimeError, match="specband_fwd launch failed"):
        specband._fwd(x, rho, g)
    xext, rho4, fb, dmel, bm = _multi_residual(cuda, MULTI_CASES[1])
    with pytest.raises(ValueError, match="band_map"):
        specband.specband_drho(xext, rho4, fb, dmel, None, (5,) * 64)
    with pytest.raises(ValueError, match="rho"):
        specband.specband_drho(xext, rho4, fb, dmel)
    # K6 above its cap: shapes consistent, the C entry refuses
    g6 = framed.Geom(4098, 80, 64, 8000, 0.0, 4000.0)
    x6 = torch.zeros((1, 2000), device=cuda)
    nfr = ops.num_frames(2000, 80)
    reim = torch.zeros((nfr, 2 * framed.kp_of(4098)), device=cuda)
    dmel6 = torch.zeros((1, 64, nfr), device=cuda)
    with pytest.raises(RuntimeError, match="fused_bwd launch failed"):
        fused.fused_dwindow(x6, reim, dmel6, g6)


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


def test_fit_is_reproducible_on_specband(cuda):
    """Two seeded fits on the specband route (lambda 128, the 1024
    bucket), whose lambda gradient comes from K2's fixed grid: the same
    lambda after every epoch and the same weights, bit for bit."""
    config = dict(FIT_CONFIG, init_lambd=128.0)
    trainset, validset, _ = get_dataset_by_config(config)
    runs = []
    for _ in range(2):
        before = specband.specband_drho.launches
        state, history = fit(config, trainset, validset, seed=0,
                             device=cuda)
        assert specband.specband_drho.launches > before
        runs.append(([r["lambd_est"] for r in history["records"]],
                     state["model"].state_dict()))
    (lam_a, sd_a), (lam_b, sd_b) = runs
    assert lam_a == lam_b
    assert lam_a[-1] != config["init_lambd"]
    for key, value in sd_a.items():
        assert torch.equal(value, sd_b[key]), key


def test_bf16_fit_is_reproducible(cuda):
    """Two seeded fits with the bf16 conv stack on the specband route:
    the same lambda after every epoch and the same weights and batch-norm
    statistics, bit for bit, all float32."""
    config = dict(FIT_CONFIG, init_lambd=128.0, model_dtype="bfloat16")
    trainset, validset, _ = get_dataset_by_config(config)
    runs = []
    for _ in range(2):
        state, history = fit(config, trainset, validset, seed=0,
                             device=cuda)
        runs.append(([r["lambd_est"] for r in history["records"]],
                     state["model"].state_dict()))
    (lam_a, sd_a), (lam_b, sd_b) = runs
    assert lam_a == lam_b
    assert lam_a[-1] != config["init_lambd"]
    for key, value in sd_a.items():
        assert torch.equal(value, sd_b[key]), key
        if not key.endswith("num_batches_tracked"):
            assert value.dtype == torch.float32, key


class _Kill(Exception):
    pass


@pytest.mark.parametrize("model_dtype", ["float32", "bfloat16"])
def test_resume_is_bit_identical(cuda, tmp_path, model_dtype):
    """A trial killed after epoch 1's report resumes from its live state
    (the CUDA dropout generator's state among it) and ends with the
    records and weights of the uninterrupted run, bit for bit; no live
    state is left.  Its ``init_lambd`` is the lambda it resumed at."""
    config = dict(FIT_CONFIG, init_lambd=128.0, max_epochs=3,
                  model_dtype=model_dtype)
    trainset, validset, _ = get_dataset_by_config(config)
    state_ref, hist_ref = fit(config, trainset, validset, seed=1,
                              device=cuda,
                              checkpoint_dir=str(tmp_path / "ref"))

    def killer(record):
        if record["epoch"] == 1:
            raise _Kill

    with pytest.raises(_Kill):
        fit(config, trainset, validset, seed=1, device=cuda,
            checkpoint_dir=str(tmp_path / "kill"), report_fn=killer)
    assert (tmp_path / "kill" / "live_state").exists()
    state, hist = fit(config, trainset, validset, seed=1, device=cuda,
                      checkpoint_dir=str(tmp_path / "kill"))
    # a resumed trial reports the lambda it resumed at, epoch 0's
    assert hist["init_lambd"] == hist_ref["records"][0]["lambd_est"]
    assert ({k: v for k, v in hist.items() if k != "init_lambd"}
            == {k: v for k, v in hist_ref.items() if k != "init_lambd"})
    sd, sd_ref = state["model"].state_dict(), state_ref["model"].state_dict()
    for key, value in sd.items():
        assert torch.equal(value, sd_ref[key]), key
    for name in ("ref", "kill"):
        assert not (tmp_path / name / "live_state").exists()
        assert (tmp_path / name / "best_model.meta.json").exists()


def _audio_mnist_subset(root, speakers=(1, 2), reps=4):
    """A small AudioMNIST tree (``reps`` clips per digit and speaker,
    lengths 1500-7500) read by ``audio_mnist_big``: the first speaker's
    clips to train on, the second's to validate."""
    from dmel_tpu_torch.data import audio
    from tests import fixtures
    rng = np.random.default_rng(0)
    paths = {}
    for sid in speakers:
        for digit in range(10):
            for rep in range(reps):
                path = str(root / f"{sid:02d}" / f"{digit}_{sid:02d}_{rep}.wav")
                fixtures.write_wav(path, fixtures.speechish(
                    rng, int(rng.integers(1500, 7500)), 8000,
                    110.0 + 40.0 * digit + 2.0 * sid), 8000)
                paths.setdefault(sid, []).append(path)
    return tuple(audio.audio_mnist_big(paths[sid]) for sid in speakers)


#: the audio_mnist space (mel_linear_net, 64 mels, hop 80, Adam, batch
#: 64 cut to 16) for 2 epochs
AM_CONFIG = dict(model_name="mel_linear_net", dataset_name="audio_mnist",
                 n_points=8000, hop_length=80, optimized=True,
                 normalize_window=False, n_mels=64, resample_rate=8000,
                 energy_normalize=True, impl="pallas", optimizer_name="adam",
                 lr_model=1e-4, lr_tf=1.0, trainable=True, batch_size=16,
                 max_epochs=2, patience=100)


@pytest.mark.parametrize("lam,counter", [
    (46.7, lambda: framed.framed_dwindow.launches),
    (400.0, lambda: specband.specband_drho.launches)],
    ids=["framed", "specband"])
def test_mel_linear_net_fit_is_reproducible(cuda, tmp_path, lam, counter):
    """Two seeded fits of the audio_mnist space's probe on a small
    AudioMNIST tree, through K3/K4 (lambda 46.7) and K1/K2 (400, the
    4096 bucket), with dropout: the same records and weights, bit for
    bit."""
    trainset, validset = _audio_mnist_subset(tmp_path)
    config = dict(AM_CONFIG, init_lambd=lam)
    runs = []
    for _ in range(2):
        before = counter()
        state, history = fit(config, trainset, validset, seed=2,
                             device=cuda)
        assert counter() > before
        runs.append((history, state["model"].state_dict()))
    (hist_a, sd_a), (hist_b, sd_b) = runs
    assert hist_a == hist_b
    assert hist_a["est_lambd"] != hist_a["init_lambd"]
    for key, value in sd_a.items():
        assert torch.equal(value, sd_b[key]), key


def test_prefetch_is_bit_identical(cuda, tmp_path):
    """``fit`` with ``prefetch`` 0 (batches placed in the loop) and 2
    (placed on a background thread through pinned memory and
    non-blocking copies on the loop's stream): the same records and
    weights, bit for bit, on the specband route."""
    trainset, validset = _audio_mnist_subset(tmp_path)
    runs = []
    for prefetch in (0, 2):
        state, history = fit(dict(AM_CONFIG, init_lambd=400.0,
                                  prefetch=prefetch),
                             trainset, validset, seed=3, device=cuda)
        runs.append((history, state["model"].state_dict()))
    (hist_a, sd_a), (hist_b, sd_b) = runs
    assert hist_a == hist_b
    for key, value in sd_a.items():
        assert torch.equal(value, sd_b[key]), key
