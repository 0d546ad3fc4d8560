"""Card-only tests of dmel_tpu_torch: the specband CUDA kernels (K1
forward, K2 the taps' gradient) against their plain PyTorch versions at
edge shapes, a train step through both, and the GPU rules of the entry
points.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from dmel_tpu_torch import build_optimizer, get_model_by_config, ops
from dmel_tpu_torch.ops import specband
from dmel_tpu_torch.training import train_step

pytestmark = pytest.mark.gpu

#: log-mel max-abs gate, as in bench.py
GATE = 1e-4
#: dlambda relative gate, as in bench.py
GRAD_GATE = 1e-2
#: K2 against its plain version: max |error| over the largest tap's
#: gradient (fp32 sums over every frame row in another order)
DRHO_GATE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
