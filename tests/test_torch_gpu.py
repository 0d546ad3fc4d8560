"""Card-only tests of dmel_tpu_torch: the specband CUDA kernels (K1
forward, K2 the taps' gradient, single- and multi-sigma), the framed
kernels (K3 forward, K4 the window's gradient) and the fused forward
(K5) and dw kernel (K6) against their plain PyTorch versions at edge
shapes and at AudioMNIST's batch of 64 one-second clips, train steps
through them, the GPU rules of the entry points, and ``fit``'s
precision flags, reproducibility (CNN6 and the audio_mnist space's mel
probe), prefetching feed and one-rank NCCL mesh; the reference's literal
geometries (n_fft = win = 8000 and 40000) through cuFFT against the CPU
oracle, and the figures' data example against the CPU.

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


def _bluestein(n_fft):
    """1 where K5 and K6 take Bluestein's stage at ``n_fft``, else 0."""
    return int(fft_plan.fused_stage_name(n_fft) == "bluestein")


def _counts(counter):
    return (counter.launches, counter.fft_launches,
            counter.bluestein_launches)


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
# and faithful mode's short window in an n_fft that is not a lane multiple:
# 3000 planned, the rest Bluestein's (m_pad 2048 at 1042-2042, 4096 at
# 4078; 14 and 26, m_pad 16 and 32, 128 and 64 frames a block)
FUSED_CASES = [
    (2, 4000, 2048, 2048, 80, 64, 300.0),
    (2, 9000, 4096, 4096, 80, 64, 600.0),
    (3, 1500, 1500, 3000, 80, 64, 300.0),
    (2, 700, 700, 1400, 40, 32, 50.0),
    (3, 521, 521, 1042, 40, 64, 60.0),
    (2, 1021, 1021, 2042, 80, 64, 150.0),
    (2, 2039, 2039, 4078, 80, 64, 300.0),
    (3, 1000, 14, 14, 4, 4, 1.5),
    (2, 1000, 26, 26, 8, 4, 3.0),
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
    before = _counts(fused.dmel_power)
    got = fused.dmel_power(x, lam_t, **kw)
    want = fused.dmel_power_plain(x, lam_t, **kw)
    exact = ops.mel_spectrogram(
        x, lam, n_mels=n_mels, sample_rate=8000, hop_length=hop,
        optimized=win == n_fft, window_length=n_fft, subtract_mean=False,
        impl="exact")
    torch.cuda.synchronize()
    # the FFT stage at 2048, 4096 and 3000 (radices 4, 3, 5); Bluestein's
    # at 1400 = 2^3 5^2 7 and the other faithful n_fft
    assert _counts(fused.dmel_power) == (
        before[0] + 1, before[1] + _fft_planned(n_fft),
        before[2] + _bluestein(n_fft))
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


#: (batch, T): faithful mode (win T, n_fft 2 T) on Bluestein's stage, as
#: chip_smoke.py's "K5 vs plain" and "K6 vs plain" phases run it (m_pad
#: 2048, 2048, 4096, and B 512 at m_pad 2048 and 4096: the card's real
#: work)
BLUESTEIN_CASES = [(32, 700), (32, 1021), (32, 2039), (512, 1021),
                   (512, 2039)]


@pytest.mark.parametrize("b,t", BLUESTEIN_CASES, ids=lambda v: str(v))
def test_bluestein_stage_at_faithful_shapes(cuda, b, t):
    """K5 and K6 on Bluestein's stage at faithful n_fft 2 T: one launch
    each on the Bluestein counters; Re|Im within 1e-5 of the plain
    version's largest entry, log-mel 1e-4, dw 1e-3 of the largest, each
    bit-identical on repeat; the direct stage through the same entries
    within the same gates; a pack of two trials bit for bit two single
    launches."""
    n_fft = 2 * t
    assert fft_plan.fused_stage_name(n_fft) == "bluestein"
    x = _signal((b, t), seed=t).to(cuda)
    lam = torch.tensor(t / 5.0, device=cuda)
    w = fused.pad_window(ops.gaussian_window(lam, t), n_fft)
    g = framed.Geom(n_fft, 80, 64, 8000, 0.0, 4000.0)
    fwd, bwd = _counts(fused.dmel_power), _counts(fused.fused_dwindow)
    (out, reim), (out2, reim2) = fused.fused_fwd(x, w, g), fused.fused_fwd(
        x, w, g)
    dmel = _signal(tuple(out.shape), seed=1).to(cuda)
    dw, dw2 = (fused.fused_dwindow(x, reim, dmel, g),
               fused.fused_dwindow(x, reim, dmel, g))
    assert _counts(fused.dmel_power) == (fwd[0] + 2, fwd[1], fwd[2] + 2)
    assert _counts(fused.fused_dwindow) == (bwd[0] + 2, bwd[1], bwd[2] + 2)
    want, reim_p = framed.fwd_plain(x, w, g)
    dw_p = framed.framed_dwindow_plain(x, reim, dmel, g)
    out_d, reim_d = framed.launch_fwd("fused_fwd", x, w, g, None)
    dw_d = framed.launch_bwd("fused_bwd", x, reim, dmel, g, None)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(reim, reim2)
    assert torch.equal(dw, dw2)
    for o, r in ((out, reim), (out_d, reim_d)):
        assert _rel(r, reim_p) <= 1e-5
        assert float((torch.log(o + 1e-10) - torch.log(want + 1e-10)).abs()
                     .max()) <= GATE
    n_bins, kp = n_fft // 2 + 1, framed.kp_of(n_fft)
    assert not reim[:, n_bins:kp].any() and not reim[:, kp + n_bins:].any()
    for d in (dw, dw_d):
        assert _rel(d, dw_p) <= DW_GATE
    # two trials: the second with its own window
    x2 = torch.cat([x, x.flip(0)])
    w2 = torch.stack([w, fused.pad_window(ops.gaussian_window(lam * 1.5, t),
                                          n_fft)])
    out_k, reim_k = fused.fused_fwd_packed(x2, w2, g)
    dmel_k = torch.cat([dmel, dmel.flip(0)])
    dw_k = fused.fused_dwindow_packed(x2, reim_k, dmel_k, g, 2)
    for i in range(2):
        rows = slice(i * b, (i + 1) * b)
        o1, r1 = fused.fused_fwd(x2[rows].contiguous(), w2[i].contiguous(), g)
        assert torch.equal(out_k[rows], o1)
        assert torch.equal(reim_k.chunk(2)[i], r1)
        d1 = fused.fused_dwindow(x2[rows].contiguous(), r1,
                                 dmel_k[rows].contiguous(), g)
        assert torch.equal(dw_k[i], d1)


def test_bluestein_stage_at_planned_nfft_and_bad_stages(cuda):
    """Bluestein's stage launched through the C entries at n_fft 1024
    (m_pad 1024), where the wrappers take the plan's FFT, computes the
    same function; a Bluestein stage whose m_pad is not the smallest power
    of two >= n_fft - 1, whose radices are not a plan of m_pad, or that
    goes to K3's or K4's entry is refused, never replaced."""
    x = _signal((2, 6000)).to(cuda)
    w = ops.gaussian_window(torch.tensor(128.0, device=cuda), 1024)
    g = framed.Geom(1024, 80, 64, 8000, 0.0, 4000.0)
    bl = fft_plan.Bluestein(1024, (4, 4, 4, 4, 4))
    out_b, reim_b = framed.launch_fwd("fused_fwd", x, w, g, bl)
    out_f, reim_f = fused.fused_fwd(x, w, g)
    dmel = _signal(tuple(out_f.shape), seed=3).to(cuda)
    dw_b = framed.launch_bwd("fused_bwd", x, reim_f, dmel, g, bl)
    dw_f = fused.fused_dwindow(x, reim_f, dmel, g)
    torch.cuda.synchronize()
    assert _rel(reim_b, reim_f) <= 1e-5
    assert float((torch.log(out_b + 1e-10) - torch.log(out_f + 1e-10))
                 .abs().max()) <= GATE
    assert _rel(dw_b, dw_f) <= DW_GATE
    g14 = framed.Geom(1400, 80, 64, 8000, 0.0, 4000.0)
    w14 = fused.pad_window(w[:700].contiguous(), 1400)
    _, reim14 = fused.fused_fwd(x, w14, g14)
    dmel14 = _signal((2, 64, ops.num_frames(6000, 80)), seed=4).to(cuda)
    for bad in (fft_plan.Bluestein(4096, (4,) * 6),
                fft_plan.Bluestein(2048, (4, 4, 4, 4, 4)),
                fft_plan.Bluestein(2048, (4, 4, 4, 4, 4, 4))):
        with pytest.raises(RuntimeError, match="fused_fwd launch failed"):
            framed.launch_fwd("fused_fwd", x, w14, g14, bad)
        with pytest.raises(RuntimeError, match="fused_bwd launch failed"):
            framed.launch_bwd("fused_bwd", x, reim14, dmel14, g14, bad)
    with pytest.raises(RuntimeError, match="framed_fwd launch failed"):
        framed.launch_fwd("framed_fwd", x, w, g, bl)
    with pytest.raises(RuntimeError, match="framed_bwd launch failed"):
        framed.launch_bwd("framed_bwd", x, reim_f, dmel, g, bl)


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


# --- K1's band stage: band groups at their edges -----------------------

#: (label, batch, T, n_fft, hop, n_mels, sample_rate, lambdas, J, band
#: map): a group at the cap's edge, two chunks (4096, 8 kHz, 64 mels),
#: bands of up to 402 bins walked in chunks (44.1 kHz, 32 mels),
#: k_sig 8 with interleaved groups (sigma 7 empty), the direct stage
#: (896), 384, and bands whose filterbank column is all zero (44.1 kHz at
#: 512; at 256 bands 0-2, 5 and 8 are, and are sigma 1's: groups with no
#: bin)
BAND_CASES = [
    ("cap-4096", 2, 9000, 4096, 80, 64, 8000, (400.0,), 12, None),
    ("wide-44k", 2, 40000, 4096, 80, 32, 44100, (400.0,), 12, None),
    ("k8-scattered", 3, 4000, 1024, 80, 64, 8000,
     tuple(float(v) for v in np.linspace(100.0, 128.0, 8)), 24,
     tuple((i * 5) % 7 for i in range(64))),
    ("direct-896", 2, 3000, 896, 80, 64, 8000, (112.0,), 24, None),
    ("nfft-384", 4, 2000, 384, 32, 40, 8000, (40.0,), 24, None),
    ("empty-44k-256", 3, 1500, 256, 32, 64, 44100, (24.0, 30.0), 12,
     tuple(int(m in (0, 1, 2, 5, 8)) for m in range(64))),
    ("empty-44k-512", 2, 3000, 512, 32, 64, 44100, (64.0,), 16, None),
]


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: c[0])
def test_band_stage_edges(cuda, case):
    """K1 where its band groups are at their edges, against the plain
    version on log-mel (1e-4); each case's plan has the edge it names."""
    label, b, t, n_fft, hop, n_mels, sr, lams, j, bm = case
    plan = specband.band_plan(n_fft, n_mels, sr, 0.0, float(sr // 2), bm)
    spans = plan.groups[:, 2] - (plan.groups[:, 1] & ~3)
    empty = plan.bands[:, 1] == plan.bands[:, 0]
    assert {"cap-4096": plan.cap - 8 < spans.max() <= plan.cap
            and plan.cap > specband.BAND_CHUNK,
            "wide-44k": spans.max() > 3 * specband.BAND_CHUNK,
            "k8-scattered": set(plan.groups[:, 0]) == set(range(7)),
            "direct-896": fft_plan.plan(n_fft) is None,
            "nfft-384": fft_plan.plan(n_fft) is not None,
            "empty-44k-256": (plan.groups[:, 1] == plan.groups[:, 2]).any(),
            }.get(label, empty.any())
    x = _signal((b, t)).to(cuda)
    ws = torch.stack([ops.gaussian_window(torch.tensor(lam, device=cuda),
                                          n_fft) for lam in lams])
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=n_mels, sample_rate=sr,
              j_taps=j)
    if bm is None:
        got = specband.specband_mel_power(x, ws[0], log_epilogue=True, **kw)
        want = specband.specband_mel_power_plain(x, ws[0], log_epilogue=True,
                                                 **kw)
    else:
        got, want = (torch.log(fn(x, ws, bm, **kw) + 1e-10) for fn in (
            specband.specband_mel_power_multi,
            specband.specband_mel_power_multi_plain))
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, n_mels, ops.num_frames(t, hop))
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= GATE, err
    if empty.any():
        floor = float(np.log(np.float32(1e-10)))
        assert ((got[:, torch.from_numpy(empty).to(cuda)] - floor).abs()
                <= 1e-6).all()


def _launches_by_kernel(fn):
    """``{kernel name: launches}`` of one call of ``fn`` after a warm-up,
    from ``torch.profiler``.  The profiler's own warm-up step takes a
    second call whose events it drops: the first kernel of a profiling
    session can go unrecorded, and the recorded step is the one after
    (its events read when that step's trace is ready)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    steps = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: steps.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    assert len(steps) == 1, len(steps)
    out = {}
    for ev in steps[0]:
        if (getattr(ev, "device_time_total", 0) or 0) > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            out[name] = out.get(name, 0) + ev.count
    return out


@pytest.mark.parametrize("n_fft,lam,j,k_sig", [
    (1024, 128.0, 24, 1), (4096, 400.0, 12, 1), (896, 112.0, 24, 1),
    (1024, 128.0, 24, 4)])
def test_k1_is_two_launches_and_xext_is_the_spectra_stage(cuda, n_fft, lam,
                                                          j, k_sig):
    """A K1 call is two launches, the spectra stage and the band stage
    (no kernel finds ranges on the card: the band plan is the host's),
    and the ``xext`` it leaves for K2 is bit for bit what the spectra
    stage launched alone writes: the band stage does not touch it."""
    x = _signal((2, 9000)).to(cuda)
    w = ops.gaussian_window(torch.tensor(lam, device=cuda), n_fft)
    rho = specband.window_taps_sym(w, n_fft, j)
    bm = None
    if k_sig > 1:
        bm = tuple(int(v) for v in ops.default_band_map(64, k_sig))
        rho = rho.repeat(k_sig, 1)
    g = specband._Geom(n_fft, 80, 64, 8000, 0.0, 4000.0, j, bm is None, bm)
    radices = fft_plan.plan(n_fft)
    stage = "ext_fft_kernel" if radices else "ext_dft_kernel"
    assert _launches_by_kernel(lambda: specband._fwd(x, rho, g)) == {
        stage: 1, "group_mel_kernel": 1}
    _, xext = specband._fwd(x, rho, g)
    out, alone = specband.launch_fwd(x, rho, g, radices, band_stage=False)
    torch.cuda.synchronize()
    assert out is None and torch.equal(xext, alone)


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
    before = _counts(counter)
    got = fused.fused_dwindow(x, reim, dmel, g)
    again = fused.fused_dwindow(x, reim, dmel, g)
    want = framed.framed_dwindow_plain(x, reim, dmel, g)
    direct = framed.launch_bwd("fused_bwd", x, reim, dmel, g, None)
    torch.cuda.synchronize()
    # the inverse FFT at 2048, 4096 and 3000; Bluestein's at 1400 and the
    # other faithful n_fft
    assert _counts(counter) == (
        before[0] + 2, before[1] + 2 * _fft_planned(n_fft),
        before[2] + 2 * _bluestein(n_fft))
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


def test_one_rank_nccl_fit_is_fit(cuda):
    """``fit`` over a one-rank NCCL mesh (the model broadcast, the
    gradients all-reduced and lambda checked over NCCL) against the same
    ``fit`` without a mesh, on the specband route (lambda 128) for one
    epoch of 2 steps, the second padded: the records and every tensor of
    the state bit for bit."""
    import torch.distributed as dist

    from dmel_tpu_torch.parallel import mesh as pmesh
    from dmel_tpu_torch.parallel.dryrun import free_port
    config = dict(FIT_CONFIG, init_lambd=128.0, max_epochs=1, n_samples=20)
    trainset, validset, _ = get_dataset_by_config(config)
    assert -(-len(trainset) // config["batch_size"]) == 2
    state0, hist0 = fit(config, trainset, validset, seed=0, device=cuda)
    pmesh.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                 backend="nccl")
    try:
        before = specband.specband_drho.launches
        state1, hist1 = fit(config, trainset, validset, seed=0,
                            mesh=pmesh.make_mesh())
        assert specband.specband_drho.launches == before + 2
    finally:
        dist.destroy_process_group()
    assert hist1["records"] == hist0["records"]
    sd1 = state1["model"].state_dict()
    for key, value in state0["model"].state_dict().items():
        assert torch.equal(value, sd1[key]), key


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


# --- packs of trials: K1, K2, K3-K6 with a trial axis ----------------------

# (trials, batch, T, n_fft, win_length, hop, n_mels, lambdas): the FFT stage
# at 2048 and 4096, faithful mode's Bluestein stage (n_fft 1400), trials
# whose frame rows do not fill a block
PACK_FUSED_CASES = [
    (3, 2, 3000, 2048, 2048, 80, 64, (250.0, 300.0, 341.0)),
    (2, 3, 9000, 4096, 4096, 80, 64, (13.33, 400.0)),
    (2, 3, 700, 1400, 700, 1, 32, (60.0, 90.0)),
]
# (trials, batch, T, n_fft, hop, n_mels, lambdas): the framed FFT and
# direct (896) stages
PACK_FRAMED_CASES = [
    (3, 2, 2000, 512, 80, 64, (40.0, 46.7, 50.0)),
    (2, 3, 3000, 896, 80, 64, (100.0, 120.0)),
]
# (trials, batch, T, n_fft, hop, n_mels, lambdas, J, log)
PACK_SPECBAND_CASES = [
    (3, 2, 4000, 1024, 80, 64, (110.0, 120.0, 128.0), 24, True),
    (2, 3, 9000, 4096, 80, 64, (400.0, 420.0), 12, False),
    (2, 2, 2000, 896, 80, 64, (112.0, 120.0), 24, True),
]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _pack_geom(n_fft, hop, n_mels):
    return framed.Geom(n_fft, hop, n_mels, 8000, 0.0, 4000.0)


@pytest.mark.parametrize("case", PACK_FUSED_CASES,
                         ids=lambda c: f"nfft{c[3]}-k{c[0]}")
def test_packed_k5_k6_match_single_launches(cuda, case):
    """K5 and K6 on a pack: one launch each; trial k's outputs are the
    single launch's on its rows and window, forward bit for bit and dw
    within 1e-6 of its largest entry; the pack against its plain version
    (the plain function on each trial) within the single kernels' gates."""
    k, b, t, n_fft, win, hop, n_mels, lams = case
    g = _pack_geom(n_fft, hop, n_mels)
    x = _signal((k * b, t), seed=3).to(cuda)
    w = torch.stack([fused.pad_window(ops.gaussian_window(lam, win), n_fft)
                     for lam in lams]).to(cuda)
    before = fused.fused_fwd_packed.launches
    out, reim = fused.fused_fwd_packed(x, w, g)
    assert fused.fused_fwd_packed.launches == before + 1
    dmel = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                       ).to(cuda)
    before = fused.fused_dwindow_packed.launches
    dw = fused.fused_dwindow_packed(x, reim, dmel, g, k)
    assert fused.fused_dwindow_packed.launches == before + 1
    for i in range(k):
        rows = slice(i * b, (i + 1) * b)
        o1, r1 = fused.fused_fwd(x[rows].contiguous(), w[i].contiguous(), g)
        assert torch.equal(out[rows], o1)
        assert torch.equal(reim.chunk(k)[i], r1)
        d1 = fused.fused_dwindow(x[rows].contiguous(), r1,
                                 dmel[rows].contiguous(), g)
        assert _rel(dw[i], d1) <= 1e-6
    p_out, p_reim = framed._looped_fwd(framed.fwd_plain, x, w, g)
    assert (torch.log(out + 1e-10) - torch.log(p_out + 1e-10)).abs().max() \
        <= GATE
    p_dw = framed.framed_dwindow_plain_packed(x, p_reim, dmel, g, k)
    for i in range(k):
        assert _rel(dw[i], p_dw[i]) <= DW_GATE


@pytest.mark.parametrize("case", PACK_FRAMED_CASES,
                         ids=lambda c: f"nfft{c[3]}-k{c[0]}")
def test_packed_k3_k4_match_single_launches(cuda, case):
    """K3 and K4 take the trial axis through the same launchers: one
    launch each, trial k bit for bit the single launch's forward and
    within 1e-6 in dw."""
    k, b, t, n_fft, hop, n_mels, lams = case
    g = _pack_geom(n_fft, hop, n_mels)
    x = _signal((k * b, t), seed=4).to(cuda)
    w = torch.stack([ops.gaussian_window(lam, n_fft) for lam in lams]
                    ).to(cuda)
    before = (framed.framed_fwd_packed.launches,
              framed.framed_dwindow_packed.launches)
    out, reim = framed.framed_fwd_packed(x, w, g)
    dmel = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)
                       ).to(cuda)
    dw = framed.framed_dwindow_packed(x, reim, dmel, g, k)
    assert (framed.framed_fwd_packed.launches,
            framed.framed_dwindow_packed.launches) == (before[0] + 1,
                                                       before[1] + 1)
    for i in range(k):
        rows = slice(i * b, (i + 1) * b)
        o1, r1 = framed.framed_fwd(x[rows].contiguous(), w[i].contiguous(),
                                   g)
        assert torch.equal(out[rows], o1)
        d1 = framed.framed_dwindow(x[rows].contiguous(), r1,
                                   dmel[rows].contiguous(), g)
        assert _rel(dw[i], d1) <= 1e-6


@pytest.mark.parametrize("case", PACK_SPECBAND_CASES,
                         ids=lambda c: f"nfft{c[3]}-k{c[0]}")
def test_packed_k1_k2_match_single_launches(cuda, case):
    """K1 and K2 on a pack: one launch each; trial k bit for bit the
    single launch's forward, its taps' gradient within 1e-6; the pack
    against the plain functions on each trial within the gates."""
    k, b, t, n_fft, hop, n_mels, lams, j, log = case
    g = specband._Geom(n_fft, hop, n_mels, 8000, 0.0, 4000.0, j, log)
    x = _signal((k * b, t), seed=5).to(cuda)
    w = torch.stack([ops.gaussian_window(lam, n_fft) for lam in lams]
                    ).to(cuda)
    rho = specband.window_taps_sym(w, n_fft, j).contiguous()
    before = (specband.fwd_packed.launches,
              specband.specband_drho_packed.launches)
    out, xext = specband.fwd_packed(x, rho, g)
    fb = specband._fb(g, x.device)
    dmel = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                       ).to(cuda)
    logmel = out if log else None
    drho = specband.specband_drho_packed(xext, rho, fb, dmel, logmel, None, k)
    assert (specband.fwd_packed.launches,
            specband.specband_drho_packed.launches) == (before[0] + 1,
                                                        before[1] + 1)
    for i in range(k):
        rows = slice(i * b, (i + 1) * b)
        o1, e1 = specband._fwd(x[rows].contiguous(), rho[i].contiguous(), g)
        assert torch.equal(out[rows], o1)
        d1 = specband.specband_drho(e1, rho[i].contiguous(), fb,
                                    dmel[rows].contiguous(),
                                    o1 if log else None)
        assert _rel(drho[i], d1) <= 1e-6
        p_out, p_xext = specband._fwd_plain(x[rows], rho[i], g)
        mel_err = (out[rows] - p_out) if log else (
            torch.log(out[rows] + 1e-10) - torch.log(p_out + 1e-10))
        assert mel_err.abs().max() <= GATE
        p_d = specband.specband_drho_plain(p_xext, rho[i], fb, dmel[rows],
                                           p_out if log else None)
        assert _rel(drho[i], p_d) <= DRHO_GATE


def test_packed_k1_k2_multi_sigma(cuda):
    """K1 and K2 at k_sig 4 on a pack of 2: the trial axis beside the
    sigma one, one launch each, trial k bit for bit the single multi
    launch's forward."""
    k, b, t, n_fft, j = 2, 2, 4000, 1024, 24
    bm = tuple(int(v) for v in ops.default_band_map(64, 4))
    g = specband._Geom(n_fft, 80, 64, 8000, 0.0, 4000.0, j, False, bm)
    x = _signal((k * b, t), seed=6).to(cuda)
    lams = ((100.0, 110.0, 120.0, 128.0), (105.0, 112.0, 118.0, 125.0))
    w = torch.stack([torch.stack([ops.gaussian_window(lam, n_fft)
                                  for lam in ls]) for ls in lams]).to(cuda)
    rho = specband.window_taps_sym(w, n_fft, j).contiguous()
    before = specband.fwd_packed.multi_launches
    out, xext = specband.fwd_packed(x, rho, g)
    assert specband.fwd_packed.multi_launches == before + 1
    fb = specband._fb(g, x.device)
    dmel = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                       ).to(cuda)
    drho = specband.specband_drho_packed(xext, rho, fb, dmel, None, bm, k)
    for i in range(k):
        rows = slice(i * b, (i + 1) * b)
        o1, e1 = specband._fwd(x[rows].contiguous(), rho[i].contiguous(), g)
        assert torch.equal(out[rows], o1)
        d1 = specband.specband_drho(e1, rho[i].contiguous(), fb,
                                    dmel[rows].contiguous(), None, bm)
        assert _rel(drho[i], d1) <= 1e-6


@pytest.mark.parametrize("impl,wl,lams", [
    ("fused", 4096, (13.33, 46.67, 400.0)),
    ("framed", 512, (40.0, 46.7, 50.0)),
    ("specband", 1024, (110.0, 120.0, 128.0)),
    ("exact", 512, (13.33, 46.67, 60.0))])
def test_packed_mel_spectrogram_is_per_trial(cuda, impl, wl, lams):
    """``mel_spectrogram`` with lambda (K,) on the card: trial k's
    log-mel bit for bit the single call's on the framed and fused routes,
    within 1e-5 on the exact route (cuFFT plans a batch of K B rows apart
    from one of B) and the specband route (the taps sum a (K, n_fft,
    2J + 1) product over n_fft where the single call sums an (n_fft,
    2J + 1) one, and the card may sum the two in another order);
    dlambda within 1e-6; and the pack's forward launches its packed
    kernel once.  The signal's mean is taken off beforehand: a mean over
    (K, B) rows may sum in another order than over (B,)."""
    kw = dict(n_mels=64, sample_rate=8000, hop_length=80, optimized=True,
              window_length=wl, impl=impl, device=cuda, subtract_mean=False,
              lambd_hint=128.0 * 1.001 if impl == "specband" else None)
    x = _signal((len(lams), 2, 4000), seed=7).to(cuda)
    counters = {"fused": fused.fused_fwd_packed,
                "framed": framed.framed_fwd_packed,
                "specband": specband.fwd_packed}
    before = counters[impl].launches if impl in counters else 0
    lam = torch.tensor(lams, device=cuda, requires_grad=True)
    out = ops.log_mel_spectrogram(x, lam, **kw)
    if impl in counters:
        assert counters[impl].launches == before + 1
    out.sum().backward()
    for i, li in enumerate(lams):
        l1 = torch.tensor(li, device=cuda, requires_grad=True)
        o1 = ops.log_mel_spectrogram(x[i], l1, **kw)
        o1.sum().backward()
        if impl in ("exact", "specband"):
            assert (out[i] - o1).abs().max() <= 1e-5
        else:
            assert torch.equal(out[i], o1)
        assert abs(float(lam.grad[i] - l1.grad)) <= 1e-6 * abs(float(l1.grad))


def test_fit_trials_launches_k5_once_a_step(cuda):
    """``fit_trials`` on a bf16 CNN6 pack at 4096 (the esc50_synth
    grid's shape, cut to 3 trials of 64 clips): the fused route, one K5
    launch a train step, none of K1-K4, and per-trial histories."""
    from dmel_tpu_torch.parallel import fit_trials
    config = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
                  n_points=40000, hop_length=80, optimized=True, impl="pallas",
                  normalize_window=False, n_mels=64, resample_rate=8000,
                  optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
                  batch_size=16, max_epochs=1, patience=10,
                  model_dtype="bfloat16")
    configs = [dict(config, init_lambd=lam, trainable=tr)
               for lam, tr in ((13.33, True), (46.67, True), (400.0, False))]
    rng = np.random.default_rng(0)
    from dmel_tpu_torch.data import ArrayDataset
    train = ArrayDataset(rng.standard_normal((64, 40000)).astype(np.float32),
                         rng.integers(0, 10, 64).astype(np.int32), 8000)
    valid = ArrayDataset(rng.standard_normal((16, 40000)).astype(np.float32),
                         rng.integers(0, 10, 16).astype(np.int32), 8000)
    counters = (fused.fused_fwd_packed, specband.fwd_packed,
                framed.framed_fwd_packed, fused.fused_dwindow_packed)
    before = [c.launches for c in counters]
    state, hists = fit_trials(configs, train, valid, device=cuda)
    after = [c.launches - b for c, b in zip(counters, before)]
    assert state["window_length"] == 4096 and state["lambd_hint"] is None
    assert after == [64 // 16 + 1, 0, 0, 0]
    assert all(len(h["records"]) == 1 for h in hists)
    lam = state["pack"].params["spectrogram_layer.lambd"].detach().cpu()
    assert float(lam[2]) == 400.0 and float(lam[0]) != 13.33


#: the reference's literal geometries (n_fft = win = T, hop 80, 64 mels):
#: audio_mnist's T 8000 and esc50's T 40000 at the grids' lambda 46.67
#: and 400, two rows each
LITERAL_CASES = [(8000, 46.67), (8000, 400.0), (40000, 46.67),
                 (40000, 400.0)]
#: dlambda relative gate at the literal geometries, as
#: tests/test_reference_geometries.py's
LITERAL_GRAD_GATE = 1e-3


def _kernel_launches():
    """Every K1-K6 wrapper's launch count, single and packed."""
    return [specband.specband_mel_power.launches,
            specband.specband_mel_power_multi.launches,
            specband.specband_drho.launches,
            specband.specband_drho.multi_launches,
            framed.framed_mel_power.launches, framed.framed_dwindow.launches,
            fused.dmel_power.launches, fused.fused_dwindow.launches,
            specband.fwd_packed.launches,
            specband.specband_drho_packed.launches,
            framed.framed_fwd_packed.launches,
            framed.framed_dwindow_packed.launches,
            fused.fused_fwd_packed.launches,
            fused.fused_dwindow_packed.launches]


@pytest.mark.parametrize("t,lam", LITERAL_CASES,
                         ids=lambda v: str(v))
def test_literal_geometry_cufft_matches_cpu_oracle(cuda, t, lam):
    """n_fft = win = T through ``impl="auto"`` on the card: the exact
    route (cuFFT), no kernel launch, log-mel (1e-4) and dlambda (1e-3)
    against the torch oracle on the CPU."""
    from tests.reference_impl import torch_logmel_oracle
    x_np = np.random.default_rng(0).standard_normal((2, t)).astype(
        np.float32)
    before = _kernel_launches()
    lam_t = torch.tensor(lam, device=cuda, requires_grad=True)
    feat = ops.mel_spectrogram(
        torch.from_numpy(x_np).to(cuda), lam_t, n_mels=64,
        sample_rate=8000, hop_length=80, optimized=True, window_length=t,
        impl="auto", lambd_hint=lam, log_output=True)
    feat.sum().backward()
    torch.cuda.synchronize()
    assert _kernel_launches() == before
    ref, ref_grad = torch_logmel_oracle(x_np, lam, t, 80, 64, 8000)
    assert feat.shape == ref.shape == (2, 64, t // 80 + 1)
    err = float((feat.detach().cpu() - torch.from_numpy(ref)).abs().max())
    assert err <= GATE, err
    g = float(lam_t.grad)
    assert abs(g - ref_grad) <= LITERAL_GRAD_GATE * abs(ref_grad), (
        g, ref_grad)


def test_data_example_spectrograms_on_card(cuda):
    """The figures' data half on the card against the CPU."""
    from dmel_tpu_torch.eval.figures import data_example_spectrograms
    got = data_example_spectrograms(device=cuda)
    want = data_example_spectrograms(device="cpu")
    assert got.shape == want.shape == (3, 3, 129, 129)
    assert float(np.max(np.abs(got - want))) <= GATE * float(
        np.max(np.abs(want)))
