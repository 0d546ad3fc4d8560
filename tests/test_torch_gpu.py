"""Card-only tests of dmel_tpu_torch: the specband CUDA kernel against
its plain PyTorch version at edge shapes, and the GPU rules of the
entry points.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from dmel_tpu_torch import ops
from dmel_tpu_torch.ops import specband

pytestmark = pytest.mark.gpu

#: log-mel max-abs gate, as in bench.py
GATE = 1e-4


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


def test_grad_on_specband_route_raises(cuda):
    x = _signal((1, 4000)).to(cuda)
    lam = torch.tensor(128.0, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        ops.mel_spectrogram(x, lam, n_mels=64, sample_rate=8000,
                            hop_length=80, optimized=True,
                            window_length=1024, impl="specband")


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
