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

The same holds for K2, the gradient in the taps: its plain version
``specband_drho_plain`` is held against torch autograd, and dlambda
through the autograd Function (K1's and K2's plain versions on the CPU)
against ``jax.grad`` of the JAX kernels in interpret mode (1e-2, the
bench gate; their adjoint is bf16) and of ``_specband_xla_ref`` (1e-4).
"""

import os
import re
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


def _tap_instance(n_taps):
    """The tap count of the band-stage kernel instance that serves
    ``n_taps`` taps (``band_tap_instance``)."""
    return next(nt for nt in (25, 33, 49, 127) if n_taps <= nt)


def emulate_band_stage(xext, rho, fb, plan, log=False):
    """K1's band stage (``group_mel_kernel``) group by group, as the
    kernel runs it: each group's sigma's taps ``i = 0 .. 2J`` over its bins
    in chunks of ``BAND_CHUNK`` bins from its first bin moved back to where
    its first tap's column is a multiple of 4 (an empty group: one chunk of
    one bin), the power, and each band's sum over its own nonzero bins
    within the chunk, carried from chunk to chunk.  ``xext`` (rows, 2 kp),
    ``rho`` (2J + 1,) or (K, 2J + 1), ``fb`` (n_bins, n_mels), ``plan`` a
    :func:`band_plan`; (rows, n_mels), NaN where no group wrote, so a band
    left out shows."""
    kp = xext.shape[1] // 2
    rho2 = rho[None] if rho.dim() == 1 else rho
    n_taps = rho2.shape[1]
    pad = (_tap_instance(n_taps) - n_taps) // 2
    out = torch.full((xext.shape[0], fb.shape[1]), float("nan"))
    for sigma, lo, hi, m0, m1 in plan.groups.tolist():
        acc = torch.zeros((xext.shape[0], m1 - m0))
        for c_lo in range(lo - (lo - pad) % 4, max(hi, lo + 1),
                          tsb.BAND_CHUNK):
            c_hi = min(max(hi, lo + 1), c_lo + tsb.BAND_CHUNK)
            # the chunk's X' columns and their halo, inside one plane (a
            # column below 0 is staged as 0)
            assert c_hi + n_taps - 1 <= kp
            k = torch.arange(c_lo, c_hi)
            plane = torch.nn.functional.pad(xext, (pad + 3, 0))
            sr = sum(rho2[sigma, i] * plane[:, pad + 3 + k + n_taps - 1 - i]
                     for i in range(n_taps))
            si = sum(rho2[sigma, i]
                     * plane[:, pad + 3 + kp + k + n_taps - 1 - i]
                     for i in range(n_taps))
            p = sr * sr + si * si
            for m in range(m0, m1):
                k0 = max(int(plan.bands[m, 0]), c_lo)
                k1 = min(int(plan.bands[m, 1]), c_hi)
                if k1 > k0:
                    acc[:, m - m0] += p[:, k0 - c_lo:k1 - c_lo] @ fb[k0:k1, m]
        out[:, m0:m1] = acc
    return torch.log(out + 1e-10) if log else out


def check_band_plan(plan, fb, band_map=None):
    """``plan`` is a band plan of filterbank ``fb`` under ``band_map``:
    every band in exactly one group, in order; one sigma a group; every
    nonzero ``fb[k, m]`` inside its band's range and its group's; the cap
    one chunk where no band spans more than half a chunk, else two; a
    group spans at most the cap from its first bin rounded down to a
    multiple of 4 unless it holds one nonempty band; two neighbouring
    groups of one sigma could not be one; an all-zero column has the
    empty range."""
    n_mels = fb.shape[1]
    cap = plan.cap
    widest = int((plan.bands[:, 1] - plan.bands[:, 0]).max())
    assert cap == (tsb.BAND_CHUNK if 2 * widest <= tsb.BAND_CHUNK
                   else 2 * tsb.BAND_CHUNK)
    sigma = (0,) * n_mels if band_map is None else band_map
    groups, bands = plan.groups, plan.bands
    assert groups.dtype == bands.dtype == np.int32
    assert bands.shape == (n_mels, 2) and groups.shape[1] == 5
    assert groups[0, 3] == 0 and groups[-1, 4] == n_mels
    assert (groups[1:, 3] == groups[:-1, 4]).all()
    assert (groups[:, 4] > groups[:, 3]).all()
    assert plan.max_bands == int((groups[:, 4] - groups[:, 3]).max())
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        want = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        assert tuple(bands[m]) == want
    for gi, (s, lo, hi, m0, m1) in enumerate(groups.tolist()):
        assert all(sigma[m] == s for m in range(m0, m1))
        full = [m for m in range(m0, m1) if bands[m, 1] > bands[m, 0]]
        if full:
            assert lo == min(bands[m, 0] for m in full)
            assert hi == max(bands[m, 1] for m in full)
        else:
            assert lo == hi == 0
        assert hi - (lo & ~3) <= cap or len(full) == 1
        if gi and full and groups[gi - 1, 0] == s:
            plo, phi = groups[gi - 1, 1:3]
            assert plo < phi and max(phi, hi) - (min(plo, lo) & ~3) > cap


def _emulate_launcher(x, window, n_fft, hop, n_mels, j, log):
    """The CUDA launcher's data layout, step by step in PyTorch: X' rows
    (b * n_frames + t) from the unpadded signal with the centre padding
    masked, cos plane in columns [0, kp), sin plane in [kp, 2 kp); the
    band stage group by group over the geometry's band plan
    (:func:`emulate_band_stage`); output (B, n_mels, n_frames)."""
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
    plan = tsb.band_plan(n_fft, n_mels, SR, 0.0, float(SR // 2))
    mel = emulate_band_stage(xext, rho, fb, plan, log)
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


def test_band_plan_chunk_is_the_kernels():
    """The plan's chunk is the number of bins the band stage convolves at
    a time, so a group within one chunk is one pass of the kernel."""
    src = (_cuda.SRC_DIR / "specband_fwd.cu").read_text()
    assert re.search(r"constexpr int CHUNK = (\d+);", src).group(1) == str(
        tsb.BAND_CHUNK)


@pytest.mark.parametrize("own_sigma", [False, True], ids=["one", "own"])
@pytest.mark.parametrize("n_fft", [256, 384, 512])
def test_band_plan_empty_columns(rng, n_fft, own_sigma):
    """At 44.1 kHz and 64 mels the lowest bands of a short FFT have no
    nonzero bin: they get the empty range and join a group of their sigma
    or, as sigma 1 of their own, make groups with no bin; the band stage
    gives them log(1e-10) as the plain version does."""
    sr, n_mels, j, hop = 44100, 64, 12, 32
    fb = tsb.melscale_fbanks_np(n_fft // 2 + 1, 0.0, float(sr // 2), n_mels,
                                sr)
    empty = ~(fb != 0).any(0)
    assert empty.any()
    bm = tuple(int(e) for e in empty) if own_sigma else None
    plan = tsb.band_plan(n_fft, n_mels, sr, 0.0, float(sr // 2), bm)
    check_band_plan(plan, fb, bm)
    assert (plan.groups[:, 1] == plan.groups[:, 2]).any() == own_sigma
    g = tsb._Geom(n_fft, hop, n_mels, sr, 0.0, float(sr // 2), j, True, bm)
    x = torch.from_numpy(rng.standard_normal((2, 1500)).astype(np.float32))
    w = tops.gaussian_window(n_fft / 8.0, n_fft)
    rho = tsb.window_taps_sym(torch.stack([w, w ** 2]) if own_sigma else w,
                              n_fft, j)
    want, xext = tsb._fwd_plain(x, rho, g)
    got = emulate_band_stage(xext, rho, torch.from_numpy(fb.copy()), plan,
                             True).reshape(2, -1, n_mels).transpose(1, 2)
    assert float((got - want).abs().max()) <= GATE
    assert (got[:, torch.from_numpy(empty)] == float(np.log(
        np.float32(1e-10)))).all()


@pytest.mark.parametrize("sr,n_mels", [(8000, 64), (44100, 32)])
def test_band_stage_wide_bands(rng, sr, n_mels):
    """At 4096 the top bands span more than half a chunk (136 bins at 8
    kHz and 64 mels, 402 at 44.1 kHz and 32): groups span up to two
    chunks, a wider band is a group of its own, and the kernel walks them
    in chunks, each band's sum carried between them; the emulated stage
    against ``band_mel_plain``."""
    n_fft, j = 4096, 12
    plan = tsb.band_plan(n_fft, n_mels, sr, 0.0, float(sr // 2))
    fb = tsb.melscale_fbanks_np(n_fft // 2 + 1, 0.0, float(sr // 2), n_mels,
                                sr)
    check_band_plan(plan, fb)
    assert plan.cap == 2 * tsb.BAND_CHUNK
    assert (plan.groups[:, 2] - plan.groups[:, 1] > tsb.BAND_CHUNK).any()
    g = tsb._Geom(n_fft, 80, n_mels, sr, 0.0, float(sr // 2), j, True)
    x = torch.from_numpy(rng.standard_normal((1, 2400)).astype(np.float32))
    rho = tsb.window_taps_sym(tops.gaussian_window(400.0, n_fft), n_fft, j)
    _, xext = tsb._fwd_plain(x, rho, g)
    want = tsb.band_mel_plain(xext, rho, g, 1)
    got = emulate_band_stage(xext, rho, torch.from_numpy(fb.copy()), plan,
                             True).reshape(1, -1, n_mels).transpose(1, 2)
    assert float((got - want).abs().max()) <= GATE


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


# --- K2, the gradient in the taps ------------------------------------

def _geom(n_fft, hop, n_mels, j, log):
    return tsb._Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2), j, log)


def _cotangent(rng, b, n_mels, nfr):
    """Positive cotangent, so that dlambda does not cancel to ~0."""
    return rng.uniform(0.5, 1.5, (b, n_mels, nfr)).astype(np.float32)


def _port_chain_dlambd(x, lam, case, log, cot):
    """dlambda through the autograd Function on the CPU: K1's and K2's
    plain versions in the kernels' layouts, the window by autograd."""
    n_fft, hop, n_mels, _, j, _ = case
    lam_t = torch.tensor(lam, requires_grad=True)
    rho = tsb.window_taps_sym(tops.gaussian_window(lam_t, n_fft), n_fft, j)
    out = tsb._SpecbandMel.apply(torch.from_numpy(x), rho,
                                 _geom(n_fft, hop, n_mels, j, log))
    (out * torch.from_numpy(cot)).sum().backward()
    return float(lam_t.grad)


def _jax_loss(x, case, log, cot, kernel):
    n_fft, hop, n_mels, _, j, _ = case

    def loss(lam):
        w = jops.gaussian_window(lam, n_fft)
        if kernel:
            mel = jsb.specband_mel_power(
                jnp.asarray(x), w, n_fft=n_fft, hop_length=hop,
                n_mels=n_mels, sample_rate=SR, j_taps=j, interpret=True,
                log_epilogue=log)
        else:
            tmat = jsb.band_matrix(jsb.window_taps_sym(w, n_fft, j), j)
            mel = jnp.swapaxes(jsb._specband_xla_ref(
                jnp.asarray(x), tmat, n_fft, hop, j, _mel_key(n_mels)), 1, 2)
            if log:
                mel = jnp.log(mel + 1e-10)
        return jnp.sum(mel * cot)
    return loss


def _case_inputs(rng, case):
    n_fft, hop, n_mels, lam, j, t = case
    x = rng.standard_normal((2, t)).astype(np.float32)
    x -= x.mean(-1, keepdims=True)
    return x, _cotangent(rng, 2, n_mels, tops.num_frames(t, hop))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[0]}-J{c[4]}")
@pytest.mark.parametrize("log", [False, True])
def test_k2_chain_matches_jax_ref(rng, case, log):
    """dlambda through K2's plain version against jax.grad of the JAX
    package's plain rebuild ``_specband_xla_ref``: relative 1e-4 (both
    fp32; they differ only in summation order)."""
    x, cot = _case_inputs(rng, case)
    got = _port_chain_dlambd(x, case[3], case, log, cot)
    want = float(jax.grad(_jax_loss(x, case, log, cot, kernel=False))(
        jnp.float32(case[3])))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("case,log", [(CASES[0], False), (CASES[1], True),
                                      (CASES[2], True), (CASES[3], False)],
                         ids=lambda c: str(c))
def test_k2_chain_matches_jax_kernel(rng, case, log):
    """dlambda against jax.grad through the Pallas kernels in interpret
    mode: relative 1e-2, bench.py's gate (the TPU adjoint casts dS and
    the tap matrix to bf16)."""
    x, cot = _case_inputs(rng, case)
    got = _port_chain_dlambd(x, case[3], case, log, cot)
    want = float(jax.grad(_jax_loss(x, case, log, cot, kernel=True))(
        jnp.float32(case[3])))
    assert abs(got - want) <= GRAD_GATE * abs(want), (got, want)


def _residual(rng, case, log):
    """K1's plain outputs at one geometry and K2's operands: (xext, rho,
    fb, dmel, logmel), plus the rho leaf of the plain mel for autograd."""
    n_fft, hop, n_mels, lam, j, t = case
    x, _ = _case_inputs(rng, case)
    x = torch.from_numpy(x)
    g = _geom(n_fft, hop, n_mels, j, log)
    rho = tsb.window_taps_sym(tops.gaussian_window(lam, n_fft), n_fft, j)
    out, xext = tsb._fwd_plain(x, rho, g)
    _, fb, _ = tsb._consts(g, x.device)
    dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    return x, g, (xext, rho, fb, dmel, out if log else None)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"nfft{c[0]}-J{c[4]}")
@pytest.mark.parametrize("log", [False, True])
def test_k2_plain_matches_autograd(rng, case, log):
    """``specband_drho_plain`` against torch autograd of the plain mel in
    the taps: max error within 1e-5 of the largest tap gradient."""
    x, g, (xext, rho, fb, dmel, logmel) = _residual(rng, case, log)
    got = tsb.specband_drho_plain(xext, rho, fb, dmel, logmel)
    rho_leaf = rho.clone().requires_grad_()
    mel = tsb._mel_from_taps_plain(x, rho_leaf, g)
    (mel * dmel).sum().backward()
    want = rho_leaf.grad
    assert got.shape == want.shape == (2 * case[4] + 1,)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def k2_constants() -> dict:
    """K2's work geometry, read from ``csrc/specband_bwd.cu``: frame rows
    (``ROWS``) and bins (``TB``) a work item, and the fixed grid
    (``GRAD_BLOCKS``)."""
    src = (tsb._cuda.SRC_DIR / "specband_bwd.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def emulate_k2(xext, rho, fb, dmel, logmel=None, band_map=None):
    """K2's launcher and kernels, step by step in PyTorch, in the order
    the kernel sums: each bin's band range and each sigma's bin range
    from the filterbank; work items of ``ROWS`` frame rows x ``TB``
    bins over the tiles that meet some sigma's range, numbered row block
    by row block; block ``b`` of ``GRAD_BLOCKS`` takes the contiguous run
    ``[b n / GRAD_BLOCKS, (b + 1) n / GRAD_BLOCKS)`` and sums its items'
    tap products in order (per sigma, only on the tiles that meet that
    sigma's range; dP over each bin's own bands, the other sigmas'
    masked); then the blocks' partials are summed.  The cotangent of
    row ``b n_frames + t`` is ``dmel[b, :, t]``; only the spectra columns
    ``[0, k_ext)`` and ``[kp, kp + k_ext)`` are read.  Returns drho as
    the wrapper does: ``(2J + 1,)``, or ``(K, 2J + 1)`` with a band
    map."""
    k = k2_constants()
    rows_a, tb, n_grid = k["ROWS"], k["TB"], k["GRAD_BLOCKS"]
    rho2 = rho[None] if rho.dim() == 1 else rho
    k_sig, n_taps = rho2.shape
    rows, ncol = xext.shape
    kp = ncol // 2
    n_bins, n_mels = fb.shape
    two_j = n_taps - 1
    k_ext = n_bins + two_j
    b, _, nfr = dmel.shape
    g = dmel if logmel is None else dmel * torch.exp(-logmel)
    r = torch.arange(rows)
    g = g[r // nfr, :, r % nfr]                        # (rows, n_mels)
    sigma = torch.zeros(n_mels, dtype=torch.long) if band_map is None \
        else torch.tensor(band_map)
    nz = fb != 0
    ranges = []
    for s in range(k_sig):
        hit = torch.nonzero(nz[:, sigma == s].any(1)).flatten()
        ranges.append((int(hit.min()), int(hit.max()) + 1) if hit.numel()
                      else (0, 0))
    live = [(lo, hi) for lo, hi in ranges if lo < hi]
    lo = min(v[0] for v in live)
    hi = max(v[1] for v in live)
    t_lo = lo // tb
    n_tiles = (hi - 1) // tb + 1 - t_lo
    n_rb = -(-rows // rows_a)
    n_items = n_rb * n_tiles
    xr, xi = xext[:, :k_ext], xext[:, kp:kp + k_ext]
    # each item's tap products, (k_sig, n_taps, n_rb, n_tiles)
    items = torch.zeros(k_sig, n_taps, n_rb, n_tiles)
    for s, (s_lo, s_hi) in enumerate(ranges):
        if s_lo >= s_hi:
            continue
        dp = (g * (sigma == s)) @ fb.T                 # (rows, n_bins)
        sr = sum(rho2[s, d] * xr[:, two_j - d:two_j - d + n_bins]
                 for d in range(n_taps))
        si = sum(rho2[s, d] * xi[:, two_j - d:two_j - d + n_bins]
                 for d in range(n_taps))
        wr, wi = 2.0 * dp * sr, 2.0 * dp * si
        for d in range(n_taps):
            prod = (wr * xr[:, two_j - d:two_j - d + n_bins]
                    + wi * xi[:, two_j - d:two_j - d + n_bins])
            prod = prod[:, t_lo * tb:]
            prod = torch.nn.functional.pad(
                prod, (0, n_tiles * tb - prod.shape[1],
                       0, n_rb * rows_a - rows))
            items[s, d] = prod.reshape(n_rb, rows_a, n_tiles, tb).sum((1, 3))
        # tiles that miss the sigma's range do none of its work
        tiles = torch.arange(t_lo, t_lo + n_tiles) * tb
        miss = (tiles + tb <= s_lo) | (tiles >= s_hi)
        assert not items[s][..., miss].any()
    items = items.reshape(k_sig, n_taps, n_items)
    partials = torch.zeros(k_sig, n_taps, n_grid)
    for blk in range(n_grid):
        for it in range(n_items * blk // n_grid,
                        n_items * (blk + 1) // n_grid):
            partials[..., blk] += items[..., it]
    drho = partials.sum(-1)
    return drho[0] if rho.dim() == 1 else drho


@pytest.mark.parametrize("case,log", [(CASES[0], True), (CASES[3], False),
                                      ((384, 32, 40, 40.0, 24, 700), True)],
                         ids=lambda c: str(c))
def test_k2_launcher_layout_matches_plain(rng, case, log):
    _, _, (xext, rho, fb, dmel, logmel) = _residual(rng, case, log)
    # the padding columns of each plane are never read
    kp = xext.shape[1] // 2
    k_ext = fb.shape[0] + rho.shape[0] - 1
    xext = xext.clone()
    xext[:, k_ext:kp] = float("nan")
    xext[:, kp + k_ext:] = float("nan")
    got = emulate_k2(xext, rho, fb, dmel, logmel)
    want = tsb.specband_drho_plain(xext, rho, fb, dmel, logmel)
    assert torch.isfinite(want).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("log", [False, True])
def test_function_dx_matches_plain_autograd(rng, log):
    """dx of the autograd Function (a vjp through the plain rebuild) and
    its taps' gradient against autograd of the plain version."""
    case = CASES[3]
    n_fft, hop, n_mels, lam, j, t = case
    x, cot = _case_inputs(rng, case)
    cot = torch.from_numpy(cot)
    w = tops.gaussian_window(lam, n_fft)
    g = _geom(n_fft, hop, n_mels, j, log)
    xa = torch.from_numpy(x).requires_grad_()
    rho_a = tsb.window_taps_sym(w, n_fft, j).requires_grad_()
    (tsb._SpecbandMel.apply(xa, rho_a, g) * cot).sum().backward()
    xb = torch.from_numpy(x).requires_grad_()
    rho_b = tsb.window_taps_sym(w, n_fft, j).requires_grad_()
    (tsb._mel_from_taps_plain(xb, rho_b, g) * cot).sum().backward()
    assert float((xa.grad - xb.grad).abs().max()
                 / xb.grad.abs().max()) <= 1e-5
    assert float((rho_a.grad - rho_b.grad).abs().max()
                 / rho_b.grad.abs().max()) <= 1e-5


def test_frozen_lambda_gets_no_gradient(rng, monkeypatch):
    """A lambda that needs no gradient asks nothing of K2, through the
    Function and through the public route."""
    def no_k2(*args):
        raise AssertionError("K2 called for a frozen lambda")
    monkeypatch.setattr(tsb, "specband_drho", no_k2)
    case = CASES[2]
    n_fft, hop, n_mels, lam, j, t = case
    x, cot = _case_inputs(rng, case)
    lam_t = torch.tensor(lam, requires_grad=False)
    xt = torch.from_numpy(x).requires_grad_()
    rho = tsb.window_taps_sym(tops.gaussian_window(lam_t, n_fft), n_fft, j)
    out = tsb._SpecbandMel.apply(xt, rho, _geom(n_fft, hop, n_mels, j, True))
    (out * torch.from_numpy(cot)).sum().backward()
    assert lam_t.grad is None and xt.grad is not None
    xt.grad = None
    tops.log_mel_spectrogram(
        xt, lam_t, n_mels=n_mels, sample_rate=SR, hop_length=hop,
        optimized=True, window_length=n_fft, impl="specband",
        lambd_hint=lam, device="cpu").sum().backward()
    assert lam_t.grad is None and xt.grad is not None


def test_k2_wrapper_takes_plain_version_on_cpu(rng):
    _, _, operands = _residual(rng, CASES[0], True)
    before = tsb.specband_drho.launches
    got = tsb.specband_drho(*operands)
    assert tsb.specband_drho.launches == before
    torch.testing.assert_close(got, tsb.specband_drho_plain(*operands),
                               rtol=0, atol=0)
