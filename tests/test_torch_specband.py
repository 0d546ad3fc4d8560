"""The port's specband module against dmel_tpu's specband kernel, on the
CPU.

The plain version ``specband_mel_power_plain`` is held against the JAX
kernel run in Pallas interpret mode and against its plain reference
``_specband_xla_ref``, on log-mel max-abs <= 1e-4 (bench.py's gate);
the lambda gradient through ``window_taps_sym`` against ``jax.grad``
within 1e-2 relative (bench.py's dlambda gate).  The CUDA kernel runs
only on a card (tests/test_torch_gpu.py); here its launcher's data
layout is emulated in PyTorch and checked, and the wrapper must take
the plain version for CPU tensors.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import ops as jops
from dmel_tpu.ops import stft as jstft
from dmel_tpu.ops.pallas import specband_dmel as jsb
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.ops import _cuda
from dmel_tpu_torch.ops import specband as tsb

GATE = 1e-4
GRAD_GATE = 1e-2
SR = 8000


def _mel_key(n_mels):
    return (n_mels, SR, 0.0, float(SR // 2))


def _jax_ref_logmel(x, lam, n_fft, hop, n_mels, j):
    w = jops.gaussian_window(lam, n_fft)
    tmat = jsb.band_matrix(jsb.window_taps_sym(w, n_fft, j), j)
    mel = jsb._specband_xla_ref(jnp.asarray(x), tmat, n_fft, hop, j,
                                _mel_key(n_mels))
    return np.log(np.asarray(mel).transpose(0, 2, 1) + 1e-10)


def _plain_logmel(x, lam, n_fft, hop, n_mels, j):
    return tsb.specband_mel_power_plain(
        torch.from_numpy(x), tops.gaussian_window(lam, n_fft), n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, j_taps=j,
        log_epilogue=True).numpy()


# (n_fft, hop, n_mels, lambd, J, T): lambd picks J on the tap ladder
CASES = [(256, 16, 32, 24.0, 12, 1500),
         (256, 16, 32, 32.0, 24, 1500),
         (1024, 80, 64, 100.0, 12, 4000),
         (1024, 80, 64, 128.0, 24, 4000)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[0]}-J{c[4]}")
def test_plain_matches_jax_kernel_and_ref(rng, case):
    n_fft, hop, n_mels, lam, j, t = case
    assert jstft.specband_j_taps(lam, n_fft) == j
    x = rng.standard_normal((2, t)).astype(np.float32)
    got = _plain_logmel(x, lam, n_fft, hop, n_mels, j)
    kern = np.asarray(jsb.specband_mel_power(
        jnp.asarray(x), jops.gaussian_window(lam, n_fft), n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, j_taps=j,
        interpret=True, log_epilogue=True))
    ref = _jax_ref_logmel(x, lam, n_fft, hop, n_mels, j)
    assert got.shape == kern.shape == ref.shape
    assert float(np.max(np.abs(got - kern))) <= GATE
    assert float(np.max(np.abs(got - ref))) <= GATE


def test_plain_matches_jax_ref_at_2048(rng):
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    got = _plain_logmel(x, 250.0, 2048, 80, 64, 12)
    ref = _jax_ref_logmel(x, 250.0, 2048, 80, 64, 12)
    assert float(np.max(np.abs(got - ref))) <= GATE


def test_lambda_grad_matches_jax(rng):
    n_fft, hop, n_mels, j = 1024, 80, 64, 24
    x = rng.standard_normal((2, 4000)).astype(np.float32)

    def jax_loss(lam):
        w = jops.gaussian_window(lam, n_fft)
        return jnp.sum(jsb.specband_mel_power(
            jnp.asarray(x), w, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
            sample_rate=SR, j_taps=j, interpret=True, log_epilogue=True))

    g_j = float(jax.grad(jax_loss)(jnp.float32(128.0)))
    lam = torch.tensor(128.0, requires_grad=True)
    tsb.specband_mel_power_plain(
        torch.from_numpy(x), tops.gaussian_window(lam, n_fft), n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, j_taps=j,
        log_epilogue=True).sum().backward()
    assert abs(float(lam.grad) - g_j) <= GRAD_GATE * abs(g_j)


@pytest.mark.parametrize("n_fft,j", [(256, 12), (1024, 24), (4096, 12)])
def test_taps_band_and_bases_match_jax(n_fft, j):
    w = jops.gaussian_window(n_fft / 8.0, n_fft)
    rho_j = np.asarray(jsb.window_taps_sym(w, n_fft, j))
    rho_t = tsb.window_taps_sym(torch.tensor(np.asarray(w)), n_fft, j)
    np.testing.assert_allclose(rho_t.numpy(), rho_j, rtol=1e-5,
                               atol=1e-6 * np.abs(rho_j).max())
    np.testing.assert_array_equal(
        tsb.band_matrix(torch.from_numpy(rho_j), j).numpy(),
        np.asarray(jsb.band_matrix(jnp.asarray(rho_j), j)))
    _, _, _, kpad = tsb._geom(n_fft, j)
    for a, b in zip(tsb._bases_np(n_fft, j, kpad),
                    jsb._bases_np(n_fft, j, kpad)):
        np.testing.assert_array_equal(a, b)


def _emulate_launcher(x, window, n_fft, hop, n_mels, j, log):
    """The CUDA launcher's data layout, step by step in PyTorch: X' rows
    (b * n_frames + t) from the unpadded signal with the centre padding
    masked, cos plane in columns [0, kp), sin plane in [kp, 2 kp); the
    band sum S[k] = sum_i rho[i] X'[k + 2J - i]; output (B, n_mels,
    n_frames)."""
    b, t = x.shape
    nfr = tops.num_frames(t, hop)
    n_bins, k_ext, _, _ = tsb._geom(n_fft, j)
    basis, fb, kp = tsb._kernel_consts(n_fft, j, n_mels, SR, 0.0,
                                       float(SR // 2), x.device)
    assert basis.shape == (n_fft, 2 * kp) and (2 * kp) % 128 == 0
    assert fb.shape == (n_bins, n_mels) and k_ext <= kp
    r = torch.arange(b * nfr)
    pos = ((r % nfr) * hop - n_fft // 2)[:, None] + torch.arange(n_fft)
    ok = (pos >= 0) & (pos < t)
    frames = torch.where(ok, x[(r // nfr)[:, None], pos.clamp(0, t - 1)],
                         torch.zeros(()))
    xext = frames @ basis
    rho = tsb.window_taps_sym(window, n_fft, j)
    n_taps = 2 * j + 1
    s_re = sum(rho[i] * xext[:, 2 * j - i:2 * j - i + n_bins]
               for i in range(n_taps))
    s_im = sum(rho[i] * xext[:, kp + 2 * j - i:kp + 2 * j - i + n_bins]
               for i in range(n_taps))
    mel = (s_re * s_re + s_im * s_im) @ fb
    if log:
        mel = torch.log(mel + 1e-10)
    return mel.reshape(b, nfr, n_mels).transpose(1, 2)


@pytest.mark.parametrize("n_fft,hop,n_mels,j,t,log", [
    (256, 16, 32, 12, 1001, True), (1024, 80, 64, 24, 4000, False),
    (384, 32, 40, 24, 700, True)])
def test_launcher_layout_matches_plain(rng, n_fft, hop, n_mels, j, t, log):
    x = torch.from_numpy(rng.standard_normal((3, t)).astype(np.float32))
    w = tops.gaussian_window(n_fft / 8.0, n_fft)
    got = _emulate_launcher(x, w, n_fft, hop, n_mels, j, log)
    want = tsb.specband_mel_power_plain(x, w, n_fft=n_fft, hop_length=hop,
                                        n_mels=n_mels, sample_rate=SR,
                                        j_taps=j, log_epilogue=log)
    if log:
        assert float((got - want).abs().max()) <= GATE
    else:
        assert float(((got - want).abs() / want).max()) <= GATE


def test_wrapper_takes_plain_version_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 1500)).astype(np.float32))
    w = tops.gaussian_window(32.0, 256)
    kw = dict(n_fft=256, hop_length=16, n_mels=32, sample_rate=SR,
              j_taps=24, log_epilogue=True)
    before = tsb.specband_mel_power.launches
    got = tsb.specband_mel_power(x, w, **kw)
    assert tsb.specband_mel_power.launches == before
    assert got.shape == (2, 3, 32, 94)
    torch.testing.assert_close(got, tsb.specband_mel_power_plain(x, w, **kw),
                               rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    kw = dict(n_fft=1024, hop_length=80, n_mels=64, sample_rate=SR)
    x = torch.zeros((1, 2000))
    with pytest.raises(ValueError, match="win_length"):
        tsb.specband_mel_power(x, torch.ones(512), **kw)
    with pytest.raises(ValueError, match="unsupported geometry"):
        tsb.specband_mel_power(x, torch.ones(1000),
                               **dict(kw, n_fft=1000))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tsb.specband_mel_power(x.to("meta"), torch.ones(1024, device="meta"),
                               **kw)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_renames_into_place_once(tmp_path, monkeypatch):
    """The builder: nvcc writes a temporary name that is renamed into
    place, keyed by the source hash, and not rebuilt once present."""
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, f'echo x >> {calls}\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\necho "ptxas info: Used 8 registers"\n')
    monkeypatch.setattr(_cuda, "nvcc", lambda: nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    path, seconds, log = _cuda._build("specband_fwd")
    assert path.parent == tmp_path / "_build" and path.exists()
    assert "registers" in log and seconds > 0.0
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    again, seconds, _ = _cuda._build("specband_fwd")
    assert again == path and seconds == 0.0
    assert calls.read_text().count("x") == 1


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: nope"\nexit 2\n')
    monkeypatch.setattr(_cuda, "nvcc", lambda: nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_cuda, "_libs", {})
    with pytest.raises(RuntimeError, match="nope"):
        _cuda.load("specband_fwd")
    assert os.listdir(tmp_path / "_build") == []
    assert _cuda._libs == {}
