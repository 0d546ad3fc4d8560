"""The FFT spectra stage of K1 and K5 (``dmel_tpu_torch/ops/fft_plan.py``,
``csrc/frame_fft.cuh``) on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_gpu.py``).  Here
the pieces the kernels take from the host, and their arithmetic, are
held against independent references:

- the plan: every power-of-two n_fft from 128 to 4096 takes the FFT
  stage, any other even n_fft as its radices allow, the rest the
  direct DFT;
- ``rfft_mirror``, the kernel's Stockham stages and real post-pass step
  by step at the same float32 table entries, against ``numpy.fft.rfft``
  in float64 at every planned n_fft (within 1e-5 of the largest
  magnitude; float32 sums of up to 4096 terms);
- K1's extended-bin map applied to ``torch.fft.rfft`` of the frames
  against the plain version's ``xext``, and K5's packed Re|Im against
  the plain version's residual, zero columns included (1e-5 of the
  largest entry);
- K1 and K5 emulated end to end through the mirror, against their plain
  versions, dmel_tpu's plain reference ``_specband_xla_ref`` and its
  fused kernel in Pallas interpret mode (log-mel 1e-4, bench.py's gate;
  1e-5 against the fused kernel, which also runs its DFT in float32);
- the FFT stage's accuracy against a float64 reference, beside the
  direct DFT's, on a band-limited clip.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu.ops.pallas import fused_dmel as jfu
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.data import make_esc50_synth_dataset
from dmel_tpu_torch.ops import _cuda, fft_plan, framed, fused, specband
from dmel_tpu_torch.ops.stft import frame_signal, num_frames
from tests.test_torch_specband import _jax_ref_logmel

GATE = 1e-4
RESIDUAL_GATE = 1e-5
SR = 8000
POW2 = [128, 256, 512, 1024, 2048, 4096]


def _signal(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x - x.mean(-1, keepdims=True)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


#: every n_fft that takes the FFT stage
PLANNED = [n for n in range(2, fft_plan.MAX_N_FFT + 1, 2)
           if fft_plan.plan(n) is not None]


# --- the plan ------------------------------------------------------------

@pytest.mark.parametrize("n_fft", POW2)
def test_plan_takes_every_power_of_two(n_fft):
    radices = fft_plan.plan(n_fft)
    assert radices is not None and fft_plan.stage_name(n_fft) == "fft"
    assert int(np.prod(radices)) == n_fft // 2
    fours = n_fft.bit_length() // 2 - 1
    assert radices == (4,) * fours + (2,) * (len(radices) - fours)
    assert radices.count(2) <= 1


@pytest.mark.parametrize("n_fft,want", [
    (384, (4, 4, 4, 3)), (640, (4, 4, 4, 5)), (768, (4, 4, 4, 2, 3)),
    (3000, (4, 3, 5, 5, 5)), (1500, (2, 3, 5, 5, 5)), (6, (3,)), (2, ()),
    (1400, None), (896, None), (1023, None), (0, None), (4098, None),
    (8192, None)])
def test_plan_of_other_nffts(n_fft, want):
    """Radix 3 and 5 take what the powers of two leave; a prime factor
    above 5 (1400 = 2^3 5^2 7, 896 = 2^7 7), an odd n_fft or one outside
    [2, 4096] keeps the direct stage."""
    assert fft_plan.plan(n_fft) == want
    assert fft_plan.stage_name(n_fft) == ("direct" if want is None
                                          else "fft")


def test_planned_nffts_are_plans_the_kernel_accepts():
    """Every plan is one ``fft_plan_from`` accepts: radices in {2, 3, 4,
    5} whose product is n_fft / 2, at most MAX_STAGES of them, the
    header's own limit; the n_fft K1 takes are all planned but 896."""
    header = (_cuda.SRC_DIR / "frame_fft.cuh").read_text()
    max_stages = int(re.search(r"FFT_MAX_STAGES = (\d+);", header)[1])
    assert max_stages == fft_plan.MAX_STAGES
    for n in PLANNED:
        radices = fft_plan.plan(n)
        assert int(np.prod(radices)) == n // 2
        assert set(radices) <= {2, 3, 4, 5} and len(radices) <= max_stages
    k1 = [n for n in range(128, 4097, 128)
          if specband.supported(n, 80, 64)]
    assert [n for n in k1 if n not in PLANNED] == [896]


# --- the arithmetic --------------------------------------------------------

def _mirror_bins(frames, n_fft):
    return fft_plan.rfft_mirror(frames, fft_plan.plan(n_fft),
                                torch.tensor(fft_plan.table_np(n_fft)))


@pytest.mark.parametrize("n_fft", PLANNED)
def test_mirror_matches_numpy_rfft(n_fft):
    x = _signal(n_fft, (3, n_fft))
    re_, im = _mirror_bins(torch.from_numpy(x), n_fft)
    want = np.fft.rfft(x.astype(np.float64))
    scale = np.abs(want).max()
    assert re_.dtype == torch.float32 and re_.shape == want.shape
    assert np.abs(re_.numpy() - want.real).max() <= RESIDUAL_GATE * scale
    assert np.abs(im.numpy() - want.imag).max() <= RESIDUAL_GATE * scale


def _k1_geom(n_fft, hop, n_mels, j, log=False, band_map=None):
    return specband._Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2), j,
                          log, band_map)


def _xext_from_bins(re_, im, n_fft, j):
    """K1's spectra buffer from FFT bins through the extended-bin map."""
    kp = specband._kp(n_fft, j)
    bins, signs = fft_plan.ext_bin_map(n_fft, j, kp)
    b = torch.tensor(bins).long().clamp(min=0)
    signs = torch.tensor(signs)
    return torch.cat([signs[0] * re_[:, b], signs[1] * im[:, b]], 1)


@pytest.mark.parametrize("j", [12, 24])
@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024])
def test_ext_bin_map_matches_plain_xext(n_fft, j):
    x = torch.from_numpy(_signal(1, (2, 1200)))
    hop = n_fft // 8
    g = _k1_geom(n_fft, hop, 32, j)
    rho = specband.window_taps_sym(tops.gaussian_window(n_fft / 8, n_fft),
                                   n_fft, j)
    _, want = specband._fwd_plain(x, rho, g)
    y = torch.fft.rfft(frame_signal(x, n_fft, hop).reshape(-1, n_fft)
                       .double())
    got = _xext_from_bins(y.real, y.imag, n_fft, j).float()
    assert got.shape == want.shape
    assert _rel(got, want) <= RESIDUAL_GATE
    kp, k_ext = want.shape[1] // 2, n_fft // 2 + 1 + 2 * j
    for cols in (slice(k_ext, kp), slice(kp + k_ext, 2 * kp)):
        assert not got[:, cols].any() and not want[:, cols].any()


def _pack_reim(re_, im, n_fft):
    """K5's residual layout: Re in [0, n_bins), Im in [kp, kp + n_bins),
    zeros elsewhere."""
    n_bins, kp = n_fft // 2 + 1, framed.kp_of(n_fft)
    reim = torch.zeros((re_.shape[0], 2 * kp), dtype=re_.dtype)
    reim[:, :n_bins], reim[:, kp:kp + n_bins] = re_, im
    return reim


def _k5_geom(n_fft, hop, n_mels):
    return framed.Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2))


@pytest.mark.parametrize("n_fft,win,hop", [
    (128, 128, 16), (512, 512, 40), (1024, 1024, 80), (2048, 2048, 160),
    (3000, 1500, 80)])
def test_packed_residual_matches_plain_reim(n_fft, win, hop):
    x = torch.from_numpy(_signal(2, (2, max(1500, n_fft))))
    w = fused.pad_window(tops.gaussian_window(win / 8, win), n_fft)
    _, want = framed.fwd_plain(x, w, _k5_geom(n_fft, hop, 32))
    y = torch.fft.rfft((frame_signal(x, n_fft, hop) * w)
                       .reshape(-1, n_fft).double())
    got = _pack_reim(y.real, y.imag, n_fft).float()
    assert got.shape == want.shape
    assert _rel(got, want) <= RESIDUAL_GATE
    n_bins, kp = n_fft // 2 + 1, framed.kp_of(n_fft)
    for cols in (slice(n_bins, kp), slice(kp + n_bins, 2 * kp)):
        assert not got[:, cols].any() and not want[:, cols].any()


# --- the kernels, emulated through the mirror -------------------------------

def emulate_k1_fft(x2, rho, g):
    """K1 with the FFT stage, step by step: the mirror's bins of each
    unwindowed frame, the extended-bin map into ``xext``, then the band
    stage: ``(out, xext)`` as :func:`specband._fwd_plain` gives them."""
    frames = frame_signal(x2, g.n_fft, g.hop_length).reshape(-1, g.n_fft)
    xext = _xext_from_bins(*_mirror_bins(frames, g.n_fft), g.n_fft,
                           g.j_taps)
    return specband.band_mel_plain(xext, rho, g, x2.shape[0]), xext


def emulate_k5_fft(x2, window, g):
    """K5 with the FFT stage, step by step: the mirror's bins of each
    windowed frame packed into the residual, the power, the mel
    projection: ``(out, reim)`` as :func:`framed.fwd_plain` gives them."""
    frames = (frame_signal(x2, g.n_fft, g.hop_length) * window).reshape(
        -1, g.n_fft)
    re_, im = _mirror_bins(frames, g.n_fft)
    mel = (re_ * re_ + im * im) @ framed._fb(g, x2.device)
    nfr = num_frames(x2.shape[1], g.hop_length)
    out = mel.reshape(x2.shape[0], nfr, g.n_mels).transpose(1, 2)
    return out, _pack_reim(re_, im, g.n_fft)


# (n_fft, hop, n_mels, lambd, J, T, log, groups)
K1_CASES = [(256, 16, 32, 24.0, 12, 1001, True, 1),
            (1024, 80, 64, 128.0, 24, 4000, False, 1),
            (384, 32, 40, 40.0, 24, 700, True, 1),
            (1024, 80, 64, 120.0, 24, 3000, False, 4)]


@pytest.mark.parametrize("case", K1_CASES,
                         ids=lambda c: f"nfft{c[0]}-J{c[4]}-k{c[7]}")
def test_emulated_k1_fft_stage_matches_plain(case):
    n_fft, hop, n_mels, lam, j, t, log, k = case
    x = torch.from_numpy(_signal(3, (3, t)))
    ws = torch.stack([tops.gaussian_window(lam * (1 - 0.05 * s), n_fft)
                      for s in range(k)])
    rho = specband.window_taps_sym(ws, n_fft, j)
    bm = None if k == 1 else tuple(int(v) for v in
                                   tops.default_band_map(n_mels, k))
    g = _k1_geom(n_fft, hop, n_mels, j, log, bm)
    rho = rho[0] if k == 1 else rho
    got, xext = emulate_k1_fft(x, rho, g)
    want, xext_p = specband._fwd_plain(x, rho, g)
    assert _rel(xext, xext_p) <= RESIDUAL_GATE
    if not log:
        got, want = torch.log(got + 1e-10), torch.log(want + 1e-10)
    assert float((got - want).abs().max()) <= GATE


@pytest.mark.parametrize("n_fft,win,hop,t", [
    (128, 128, 20, 1000), (1024, 1024, 80, 4000), (3000, 1500, 80, 1500),
    (4096, 4096, 400, 6000)])
def test_emulated_k5_fft_stage_matches_plain(n_fft, win, hop, t):
    x = torch.from_numpy(_signal(4, (2, t)))
    w = fused.pad_window(tops.gaussian_window(win / 8, win), n_fft)
    g = _k5_geom(n_fft, hop, 64)
    got, reim = emulate_k5_fft(x, w, g)
    want, reim_p = framed.fwd_plain(x, w, g)
    assert _rel(reim, reim_p) <= RESIDUAL_GATE
    assert float((torch.log(got + 1e-10) - torch.log(want + 1e-10))
                 .abs().max()) <= RESIDUAL_GATE


@pytest.mark.parametrize("n_fft,hop,n_mels,lam,j,t", [
    (256, 16, 32, 32.0, 24, 1500), (1024, 80, 64, 128.0, 24, 4000)])
def test_emulated_k1_matches_jax_ref(n_fft, hop, n_mels, lam, j, t):
    x = _signal(5, (2, t))
    w = tops.gaussian_window(lam, n_fft)
    g = _k1_geom(n_fft, hop, n_mels, j, True)
    got, _ = emulate_k1_fft(torch.from_numpy(x),
                            specband.window_taps_sym(w, n_fft, j), g)
    want = _jax_ref_logmel(x, lam, n_fft, hop, n_mels, j)
    assert np.abs(got.numpy() - want).max() <= GATE


@pytest.mark.parametrize("t,win,n_fft,hop,n_mels", [
    (1000, 128, 128, 20, 16), (1500, 512, 512, 80, 64)])
def test_emulated_k5_matches_jax_kernel(t, win, n_fft, hop, n_mels):
    x = _signal(6, (2, t))
    lam = win / 8.0
    kw = dict(win_length=win, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
              sample_rate=SR)
    want = np.asarray(jfu.dmel_power(jnp.asarray(x), lam, interpret=True,
                                     **kw))
    w = fused.pad_window(tops.gaussian_window(lam, win), n_fft)
    got, _ = emulate_k5_fft(torch.from_numpy(x), w,
                            _k5_geom(n_fft, hop, n_mels))
    assert got.shape == want.shape
    assert np.abs(np.log(got.numpy() + 1e-10)
                  - np.log(want + 1e-10)).max() <= RESIDUAL_GATE


def test_fft_stage_is_closer_to_float64_than_the_direct_dft():
    """On band-limited clips (esc50_synth, whose quietest mel band sits
    ~1e-7 below the loudest) the FFT stage's spectra are at least twice
    as near a float64 reference as the plain direct DFT's: where the two
    versions' log-mel differ, the error is the direct DFT's."""
    x = make_esc50_synth_dataset(seed=0, n_samples=4).xs
    x = torch.from_numpy(np.asarray(x, np.float32))
    x = x - x.mean(-1, keepdim=True)
    n_fft, hop, j = 1024, 80, 24
    frames = frame_signal(x, n_fft, hop).reshape(-1, n_fft)
    ref = torch.fft.rfft(frames.double())
    ref = _xext_from_bins(ref.real, ref.imag, n_fft, j)
    xext_fft = _xext_from_bins(*_mirror_bins(frames, n_fft), n_fft, j)
    rho = specband.window_taps_sym(tops.gaussian_window(128.0, n_fft),
                                   n_fft, j)
    _, xext_direct = specband._fwd_plain(x, rho, _k1_geom(n_fft, hop, 64, j))
    err_fft = float((xext_fft.double() - ref).abs().max())
    err_direct = float((xext_direct.double() - ref).abs().max())
    assert err_fft * 2 <= err_direct, (err_fft, err_direct)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    x = torch.from_numpy(_signal(7, (2, 3000)))
    counters = (specband.specband_mel_power, fused.dmel_power)
    before = [(c.launches, c.fft_launches) for c in counters]
    w = tops.gaussian_window(128.0, 1024)
    got = specband.specband_mel_power(x, w, n_fft=1024, hop_length=80,
                                      n_mels=64, sample_rate=SR)
    assert torch.equal(got, specband.specband_mel_power_plain(
        x, w, n_fft=1024, hop_length=80, n_mels=64, sample_rate=SR))
    got = fused.dmel_power(x, 300.0, win_length=2048, n_fft=2048,
                           hop_length=80, n_mels=64, sample_rate=SR)
    assert torch.equal(got, fused.dmel_power_plain(
        x, 300.0, win_length=2048, n_fft=2048, hop_length=80, n_mels=64,
        sample_rate=SR))
    assert [(c.launches, c.fft_launches) for c in counters] == before
