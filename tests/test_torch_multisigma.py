"""The port's multi-sigma DMEL against dmel_tpu's, on the CPU: the
multi-sigma specband function (K1/K2 at ``k_sig = K``), the multi-sigma
route and its exact path, the layer in MelPANNsNet, one train step and
``fit`` with a vector lambda.

The same numpy-seeded inputs go through both packages.  Gates:

- log-mel max-abs <= 1e-4 (bench.py's gate) against the JAX kernel in
  Pallas interpret mode and against its plain rebuild
  ``_specband_xla_ref`` with the concatenated tap matrix.  The port's
  float32 plain version sits ~1e-6 from ``_specband_xla_ref``; the JAX
  kernel itself sits 5e-5 to 1e-4 from it (its bf16 operand splits), so
  the kernel comparison runs at production lambdas of each bucket;
- dlambda (K,) within relative 1e-2 (bench.py's gate) of ``jax.grad``
  through the interpret kernel (its adjoint is bf16) and within 1e-4 of
  ``jax.grad`` through the JAX package's XLA multi-sigma path.

The CUDA kernels run only on a card (tests/test_torch_gpu.py); here the
multi-sigma launchers' band groups and bin ranges are emulated in PyTorch
and checked against the plain versions, for a contiguous and a scattered
band map, and K1's band plan (``band_plan``) is checked at every n_fft the
kernel takes, for the band maps the routes build.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmel_tpu import models as jmodels
from dmel_tpu import ops as jops
from dmel_tpu.ops import dmel as jdmel
from dmel_tpu.ops import stft as jstft
from dmel_tpu.ops.pallas import specband_dmel as jsb
from dmel_tpu.training import train as jtrain
from dmel_tpu_torch import build_optimizer, fit, from_jax_variables
from dmel_tpu_torch import models as tmodels
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.data import get_dataset_by_config
from dmel_tpu_torch.eval import predict as tpredict
from dmel_tpu_torch.models import panns as tpanns
from dmel_tpu_torch.ops import specband as tsb
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.training import train as ttrain
from tests.test_torch_specband import (check_band_plan,
                                      emulate_band_stage, emulate_k2)
from tests.test_torch_training import (_NoDropout, _grad_capture,
                                       _norm_err)

GATE = 1e-4
GRAD_GATE = 1e-2
EXACT_GRAD_GATE = 1e-4
SR = 8000

# (n_fft, hop, n_mels, lambdas, J, T, B): the lambdas lie in each
# bucket's production range, J is the largest the hints need
CASE_256 = (256, 16, 32, (28.0, 32.0, 36.0), 24, 1500, 2)
CASE_1024 = (1024, 80, 64, (100.0, 110.0, 120.0, 128.0), 24, 4000, 2)
#: a band map that is not contiguous: groups interleaved, sigma 3 empty
SCATTERED_32 = tuple((i * 7) % 3 for i in range(32))


def _log(a):
    return np.log(np.asarray(a) + 1e-10)


def _windows(lams, n_fft):
    return torch.stack([tops.gaussian_window(float(l), n_fft) for l in lams])


def _jax_ref(x, lams, n_fft, hop, n_mels, j, band_map):
    """``_specband_xla_ref`` with the concatenated tap matrix,
    (B, n_mels, n_frames)."""
    ws = jnp.stack([jops.gaussian_window(float(l), n_fft) for l in lams])
    rhos = jax.vmap(lambda w: jsb.window_taps_sym(w, n_fft, j))(ws)
    tmat = jnp.concatenate([jsb.band_matrix(rhos[k], j)
                            for k in range(len(lams))], axis=1)
    key = (n_mels, SR, 0.0, float(SR // 2), tuple(int(v) for v in band_map))
    mel = jsb._specband_xla_ref(jnp.asarray(x), tmat, n_fft, hop, j, key)
    return np.asarray(mel).transpose(0, 2, 1)


def _inputs(rng, case):
    n_fft, hop, n_mels, lams, j, t, b = case
    x = rng.standard_normal((b, t)).astype(np.float32)
    x -= x.mean(-1, keepdims=True)
    cot = rng.uniform(0.5, 1.5, (b, n_mels, t // hop + 1)).astype(np.float32)
    return x, cot


def _geom(case, band_map):
    n_fft, hop, n_mels, _, j, _, _ = case
    return tsb._Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2), j, False,
                     tuple(int(v) for v in band_map))


def _port_chain(x, case, band_map, cot):
    """log-mel and dlambda (K,) through the autograd Function on the
    CPU: K1's and K2's plain versions in the kernels' layouts."""
    n_fft, _, _, lams, j, _, _ = case
    lam = torch.tensor(lams, requires_grad=True)
    ws = torch.stack([tops.gaussian_window(l, n_fft) for l in lam])
    out = tsb._SpecbandMel.apply(torch.from_numpy(x),
                                 tsb.window_taps_sym(ws, n_fft, j),
                                 _geom(case, band_map))
    logmel = torch.log(out + 1e-10)
    (logmel * torch.from_numpy(cot)).sum().backward()
    return logmel.detach().numpy(), lam.grad.numpy()


def test_plain_matches_jax_kernel_and_ref_256(rng):
    n_fft, hop, n_mels, lams, j, t, b = CASE_256
    x, _ = _inputs(rng, CASE_256)
    bm = tops.default_band_map(n_mels, len(lams))
    got = tsb.specband_mel_power_multi_plain(
        torch.from_numpy(x), _windows(lams, n_fft), bm, n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, j_taps=j)
    ws = jnp.asarray(_windows(lams, n_fft).numpy())
    kern = jsb.specband_mel_power_multi(
        jnp.asarray(x), ws, bm, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
        sample_rate=SR, j_taps=j, interpret=True)
    ref = _jax_ref(x, lams, n_fft, hop, n_mels, j, bm)
    assert got.shape == kern.shape == ref.shape == (b, n_mels, t // hop + 1)
    assert float(np.max(np.abs(_log(got) - _log(kern)))) <= GATE
    assert float(np.max(np.abs(_log(got) - _log(ref)))) <= GATE


def test_chain_matches_jax_kernel_1024(rng):
    """At the bench geometry (K = 4): one ``jax.vjp`` through the Pallas
    kernel in interpret mode gives its log-mel and dlambda (K,); the
    port's plain function, its kernel-layout chain and the reference
    rebuild are held to them."""
    n_fft, hop, n_mels, lams, j, t, b = CASE_1024
    x, cot = _inputs(rng, CASE_1024)
    bm = tops.default_band_map(n_mels, len(lams))

    def jax_logmel(lam):
        ws = jax.vmap(lambda l: jops.gaussian_window(l, n_fft))(lam)
        return jnp.log(jsb.specband_mel_power_multi(
            jnp.asarray(x), ws, bm, n_fft=n_fft, hop_length=hop,
            n_mels=n_mels, sample_rate=SR, j_taps=j, interpret=True) + 1e-10)

    kern, pull = jax.vjp(jax_logmel, jnp.asarray(lams, jnp.float32))
    g_kern = np.asarray(pull(jnp.asarray(cot))[0])
    plain = tsb.specband_mel_power_multi_plain(
        torch.from_numpy(x), _windows(lams, n_fft), bm, n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, j_taps=j)
    chain, g_port = _port_chain(x, CASE_1024, bm, cot)
    ref = _log(_jax_ref(x, lams, n_fft, hop, n_mels, j, bm))
    for got in (_log(plain), chain):
        assert float(np.max(np.abs(got - np.asarray(kern)))) <= GATE
        assert float(np.max(np.abs(got - ref))) <= GATE
    assert g_port.shape == g_kern.shape == (4,)
    assert np.all(np.abs(g_port - g_kern) <= GRAD_GATE * np.abs(g_kern)), (
        g_port, g_kern)


def _jax_xla_dlambd(x, case, cot, band_map=None):
    n_fft, hop, n_mels, lams, _, _, _ = case

    def loss(lam):
        mel = jdmel.multi_sigma_mel_spectrogram(
            jnp.asarray(x), lam, n_mels=n_mels, sample_rate=SR,
            hop_length=hop, optimized=True, window_length=n_fft,
            subtract_mean=False, band_map=band_map, method="matmul")
        return jnp.sum(jnp.log(mel + 1e-10) * cot)
    return np.asarray(jax.grad(loss)(jnp.asarray(lams, jnp.float32)))


@pytest.mark.parametrize("case,scattered", [(CASE_256, False),
                                            (CASE_256, True),
                                            (CASE_1024, False)],
                         ids=["256", "256-scattered", "1024"])
def test_chain_dlambda_matches_jax_xla(rng, case, scattered):
    """dlambda (K,) through K1's and K2's plain versions against
    ``jax.grad`` of the JAX package's XLA multi-sigma path: relative
    1e-4 per group (both float32; the specband truncation at J = 24
    sits far below it)."""
    n_mels = case[2]
    bm = (SCATTERED_32 if scattered
          else tops.default_band_map(n_mels, len(case[3])))
    x, cot = _inputs(rng, case)
    _, got = _port_chain(x, case, bm, cot)
    want = _jax_xla_dlambd(x, case, cot, np.asarray(bm))
    assert np.all(np.abs(got - want) <= EXACT_GRAD_GATE * np.abs(want)), (
        got, want)


def test_scattered_band_map_matches_jax_ref(rng):
    """A band map that is neither contiguous nor onto (sigma 2 of 3 has
    no band): the plain version against the reference rebuild."""
    n_fft, hop, n_mels, lams, j, t, _ = CASE_256
    x, _ = _inputs(rng, CASE_256)
    bm = tuple(v if v != 2 else 0 for v in SCATTERED_32)
    got = tsb.specband_mel_power_multi_plain(
        torch.from_numpy(x), _windows(lams, n_fft), bm, n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, j_taps=j)
    ref = _jax_ref(x, lams, n_fft, hop, n_mels, j, bm)
    assert float(np.max(np.abs(_log(got) - _log(ref)))) <= GATE


# --- the launchers' band groups and bin ranges, emulated ----------------

def _emulate_k1(xext, rho, fb, band_map, kp):
    """``group_mel_kernel`` at k_sig = K (``emulate_band_stage``): the
    geometry's band groups, each with its one sigma's taps over its own
    bins, each band's sum over its own nonzero bins; NaN where no group
    wrote."""
    assert xext.shape[1] == 2 * kp
    n_fft = 2 * (fb.shape[0] - 1)
    plan = tsb.band_plan(n_fft, fb.shape[1], SR, 0.0, float(SR // 2),
                         band_map)
    return emulate_band_stage(xext, rho, fb, plan)


def _emulate_k2(xext, rho, fb, dmel, band_map, kp):
    """``tap_grad_kernel`` at k_sig = K (``emulate_k2``): per sigma only
    the tiles that meet its bin range, dP over its own bands (the others
    masked), w = 2 dP S, the work items' sums in the blocks' order; then
    one sum per (sigma, tap)."""
    assert xext.shape[1] == 2 * kp
    return emulate_k2(xext, rho, fb, dmel, None, band_map)


@pytest.mark.parametrize("band_map", [None, SCATTERED_32],
                         ids=["contiguous", "scattered"])
def test_multi_launchers_match_plain(rng, band_map):
    """K1's and K2's multi-sigma launchers, emulated with their band
    groups and bin ranges, against ``_fwd_plain`` and
    ``specband_drho_plain``."""
    case = CASE_256
    n_fft, hop, n_mels, lams, j, t, b = case
    k_sig = 4 if band_map is not None else len(lams)
    lams = (lams + (48.0,))[:k_sig]
    bm = band_map or tuple(tops.default_band_map(n_mels, k_sig))
    x, _ = _inputs(rng, case)
    g = _geom(case, bm)
    rho = tsb.window_taps_sym(_windows(lams, n_fft), n_fft, j)
    out, xext = tsb._fwd_plain(torch.from_numpy(x), rho, g)
    _, fb, kp = tsb._consts(g, torch.device("cpu"))
    mel = _emulate_k1(xext, rho, fb, bm, kp)
    want = out.transpose(1, 2).reshape(-1, n_mels)
    assert torch.isfinite(mel).all()
    assert float(((mel - want).abs() / want.abs()).max()) <= 1e-5
    dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    got = _emulate_k2(xext, rho, fb, dmel, bm, kp)
    want = tsb.specband_drho_plain(xext, rho, fb, dmel, None, bm)
    assert want.shape == (k_sig, 2 * j + 1)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


#: (n_mels, band map) of the plan checks: one sigma, the routes'
#: contiguous groups at k_sig 2, 4 and 8, and interleaved groups
PLAN_MAPS = ([(64, None)]
             + [(64, tuple(int(v) for v in tops.default_band_map(64, k)))
                for k in (2, 4, 8)]
             + [(32, SCATTERED_32)])


@pytest.mark.parametrize("n_fft", [256, 384, 896, 1024, 2048, 4096])
@pytest.mark.parametrize("n_mels,band_map", PLAN_MAPS,
                         ids=["one", "k2", "k4", "k8", "scattered"])
def test_band_plan(n_fft, n_mels, band_map):
    """K1's band plan at every n_fft the kernel takes (the FFT and the
    direct stage's), for each band map (``check_band_plan``)."""
    fb = tsb.melscale_fbanks_np(n_fft // 2 + 1, 0.0, float(SR // 2), n_mels,
                                SR)
    plan = tsb.band_plan(n_fft, n_mels, SR, 0.0, float(SR // 2), band_map)
    check_band_plan(plan, fb, band_map)
    assert plan is tsb.band_plan(n_fft, n_mels, SR, 0.0, float(SR // 2),
                                 band_map)


def test_k2_multi_plain_matches_autograd(rng):
    """``specband_drho_plain`` with (K, 2J + 1) taps against torch
    autograd of the plain mel in the taps."""
    case = CASE_256
    n_fft, _, _, lams, j, _, _ = case
    bm = SCATTERED_32
    x, _ = _inputs(rng, case)
    g = _geom(case, bm)
    rho = tsb.window_taps_sym(_windows(lams, n_fft), n_fft, j)
    out, xext = tsb._fwd_plain(torch.from_numpy(x), rho, g)
    _, fb, _ = tsb._consts(g, torch.device("cpu"))
    dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    got = tsb.specband_drho(xext, rho, fb, dmel, None, bm)
    leaf = rho.clone().requires_grad_()
    (tsb._mel_from_taps_plain(torch.from_numpy(x), leaf, g)
     * dmel).sum().backward()
    assert float((got - leaf.grad).abs().max()
                 / leaf.grad.abs().max()) <= 1e-5


def test_wrappers_take_plain_version_on_cpu(rng):
    case = CASE_256
    n_fft, hop, n_mels, lams, j, t, _ = case
    x = torch.from_numpy(rng.standard_normal((2, 3, t)).astype(np.float32))
    bm = tops.default_band_map(n_mels, 3)
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=n_mels, sample_rate=SR,
              j_taps=j)
    counts = (tsb.specband_mel_power_multi.launches,
              tsb.specband_drho.multi_launches)
    got = tsb.specband_mel_power_multi(x, _windows(lams, n_fft), bm, **kw)
    assert got.shape == (2, 3, n_mels, t // hop + 1)
    torch.testing.assert_close(got, tsb.specband_mel_power_multi_plain(
        x, _windows(lams, n_fft), bm, **kw), rtol=0, atol=0)
    assert counts == (tsb.specband_mel_power_multi.launches,
                      tsb.specband_drho.multi_launches)


def test_bad_inputs_raise():
    x = torch.zeros((1, 2000))
    kw = dict(n_fft=256, hop_length=16, n_mels=32, sample_rate=SR)
    ws = torch.ones((9, 256))
    with pytest.raises(ValueError, match="too many sigma groups"):
        tsb.specband_mel_power_multi(x, ws, [0] * 32, **kw)
    with pytest.raises(ValueError, match="too many sigma groups"):
        tops.multi_sigma_mel_spectrogram(
            x, [40.0] * 9, n_mels=32, sample_rate=SR, hop_length=16,
            optimized=True, window_length=256, device="cpu")
    with pytest.raises(ValueError, match="band_map"):
        tsb.specband_mel_power_multi(x, ws[:3], ([0, 1, 3] * 11)[:32],
                                     **kw)
    with pytest.raises(ValueError, match="band_map"):
        tsb.specband_mel_power_multi(x, ws[:3], [0] * 31, **kw)
    with pytest.raises(ValueError, match="win_length"):
        tsb.specband_mel_power_multi(x, ws[:3, :128], [0] * 32, **kw)
    with pytest.raises(ValueError, match=r"\(K, n_fft\)"):
        tsb.specband_mel_power_multi(x, ws[0], [0] * 32, **kw)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.multi_sigma_mel_spectrogram(x, [40.0, 50.0], n_mels=32,
                                         sample_rate=SR, impl="pallas",
                                         device="cpu")


# --- the route and the exact path -----------------------------------------

#: (lambda, bucket, route, J) at hop 80, 64 mels, T = 40000, the hint
#: of the mean lambda as the trainer builds it
ROUTES = [(13.3, 128, "exact", None), (30.0, 256, "exact", None),
          (46.7, 512, "exact", None), (100.0, 1024, "specband", 12),
          (128.0, 1024, "specband", 24), (150.0, 1024, "exact", None),
          (175.0, 2048, "specband", 12), (200.0, 2048, "specband", 12),
          (300.0, 2048, "exact", None), (342.0, 4096, "specband", 12),
          (400.0, 4096, "specband", 12), (600.0, 4096, "exact", None),
          (700.0, 8192, "exact", None)]


class _Taken(Exception):
    pass


def _jax_route(monkeypatch, lams, wl, hint, impl):
    """The route the JAX package's ``multi_sigma_mel_spectrogram`` takes:
    its kernel and its exact path are replaced by spies that record and
    stop the call."""
    def kernel(*args, j_taps, **kwargs):
        raise _Taken("specband", j_taps)

    def exact(*args, **kwargs):
        raise _Taken("exact", None)

    monkeypatch.setattr(jsb, "specband_mel_power_multi", kernel)
    monkeypatch.setattr(jdmel, "spectrogram", exact)
    with pytest.raises(_Taken) as taken:
        jdmel.multi_sigma_mel_spectrogram(
            jnp.zeros((1, 2000)), jnp.asarray(lams), n_mels=64,
            sample_rate=SR, hop_length=80, optimized=True, window_length=wl,
            impl=impl, lambd_hint=hint)
    return taken.value.args


@pytest.mark.parametrize("lam,bucket,route,j", ROUTES,
                         ids=[str(r[0]) for r in ROUTES])
def test_route_matches_jax(monkeypatch, lam, bucket, route, j):
    wl = bucketed_window_length(lam, 40000)
    hint = jstft.pallas_compile_hint(lam, wl, 80)
    assert wl == bucket
    assert tops.pallas_compile_hint(lam, wl, 80) == hint
    lams = [lam * 0.98, lam, lam, lam * 1.02]
    for hints in (hint, None if hint is None else [hint] * 4):
        got = tops.multi_sigma_route(hop_length=80, n_mels=64,
                                     optimized=True, window_length=wl,
                                     lambd_hint=hints, impl="auto")
        assert got == (route, j)
        assert _jax_route(monkeypatch, lams, wl, hints, "pallas") == got
    # every other impl name takes the exact route, in both packages
    assert tops.multi_sigma_route(
        hop_length=80, n_mels=64, optimized=True, window_length=wl,
        lambd_hint=hint, impl="specband") == ("exact", None)
    assert _jax_route(monkeypatch, lams, wl, hint,
                      "pallas_specband") == ("exact", None)


def test_route_takes_largest_j_of_the_hints():
    """One tap width serves every group: the widest window spectrum
    (the smallest lambda) sets J."""
    hints = [100.0, 128.0, 120.0]
    assert [jstft.specband_j_taps(h, 1024) for h in hints] == [12, 24, 24]
    assert tops.multi_sigma_route(hop_length=80, n_mels=64, optimized=True,
                                  window_length=1024, lambd_hint=hints,
                                  impl="auto") == ("specband", 24)


@pytest.mark.parametrize("scattered", [False, True])
def test_exact_route_matches_jax_xla(rng, scattered):
    """The exact route (K torch.stft spectrograms, the band-masked
    filterbank) against the JAX package's XLA path: log-mel within 1e-5
    and dlambda (K,) within relative 1e-4."""
    t, hop, n_mels = 1200, 16, 32
    x = rng.standard_normal((2, t)).astype(np.float32)
    lams = np.array([20.0, 30.0, 44.0], np.float32)
    bm = np.asarray(SCATTERED_32) if scattered else None
    cot = rng.uniform(0.5, 1.5, (2, n_mels, t // hop + 1)).astype(np.float32)
    kw = dict(n_mels=n_mels, sample_rate=SR, hop_length=hop, optimized=True,
              window_length=256, band_map=bm)

    def jax_loss(lam):
        return jnp.sum(jnp.log(jdmel.multi_sigma_mel_spectrogram(
            jnp.asarray(x), lam, **kw) + 1e-10) * cot)

    want = jdmel.multi_sigma_mel_spectrogram(jnp.asarray(x), lams, **kw)
    g_want = np.asarray(jax.grad(jax_loss)(jnp.asarray(lams)))
    lam = torch.tensor(lams, requires_grad=True)
    got = tops.multi_sigma_mel_spectrogram(x, lam, device="cpu", **kw)
    (torch.log(got + 1e-10) * torch.from_numpy(cot)).sum().backward()
    assert float(np.max(np.abs(_log(got.detach()) - _log(want)))) <= 1e-5
    assert np.all(np.abs(lam.grad.numpy() - g_want)
                  <= EXACT_GRAD_GATE * np.abs(g_want))


@pytest.mark.parametrize("impl,lam,wl", [("exact", 46.7, 512),
                                         ("auto", 128.0, 1024)])
def test_one_sigma_is_mel_spectrogram(rng, impl, lam, wl):
    """K = 1 reduces to ``mel_spectrogram``: on the exact route and, at
    the bench bucket, on the specband route (``k_sig = 1``)."""
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    hint = tops.pallas_compile_hint(lam, wl, 80)
    kw = dict(n_mels=64, sample_rate=SR, hop_length=80, optimized=True,
              window_length=wl, impl=impl, lambd_hint=hint, device="cpu")
    got = tops.multi_sigma_mel_spectrogram(x, [lam], **kw)
    want = tops.mel_spectrogram(x, lam, **kw)
    assert float(np.max(np.abs(_log(got) - _log(want)))) <= 1e-5


# --- the slice as a whole ---------------------------------------------

T = 4000
CONFIG = dict(model_name="panns_cnn6", dataset_name="esc50_synth",
              init_lambd=128.0, n_points=T, hop_length=80, optimized=True,
              normalize_window=False, n_mels=64, resample_rate=8000,
              energy_normalize=True, impl="pallas", model_dtype="float32",
              n_sigma=4, optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
              trainable=True)


def test_model_from_jax_variables(rng, monkeypatch):
    """MelPANNsNet with a multi-sigma front end at the published CNN6
    widths, its weights and (4,) lambda crossed from dmel_tpu by
    ``from_jax_variables``, at lambda 128 (the specband route: the JAX
    kernel in interpret mode, the port's plain version): features and
    scores within 1e-4 of dmel_tpu's."""
    calls = []
    real = tsb.specband_mel_power_multi_plain
    monkeypatch.setattr(tsb, "specband_mel_power_multi_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    wl = bucketed_window_length(128.0, T)
    hint = jstft.pallas_compile_hint(128.0, wl, 80)
    jmodel = jmodels.get_model_by_config(CONFIG, window_length=wl,
                                         lambd_hint=hint)
    x = rng.standard_normal((2, T)).astype(np.float32)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((2, T), jnp.float32)))
    lams = np.array([100.0, 110.0, 120.0, 128.0], np.float32)
    variables["params"]["spectrogram_layer"]["lambd"] = lams
    model = tmodels.get_model_by_config(CONFIG, window_length=wl,
                                        lambd_hint=hint, device="cpu").eval()
    sd = from_jax_variables(variables["params"], variables["batch_stats"])
    assert sd["spectrogram_layer.lambd"].shape == (4,)
    model.load_state_dict(sd)
    out_j, s_j = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out_t, s_t = model(torch.from_numpy(x))
    assert calls == [1]
    assert float(np.max(np.abs(s_t.numpy() - np.asarray(s_j)))) <= GATE
    assert float(np.max(np.abs(out_t.numpy() - np.asarray(out_j)))) <= GATE


@pytest.mark.parametrize("lam,route", [(128.0, "specband"),
                                       (46.7, "exact")])
def test_predict_multi_sigma(rng, lam, route):
    """``predict`` with a multi-sigma model on the CPU, batched: the
    same scores as one eval-mode forward, finite probabilities, the
    route the layer's hint selects."""
    config = dict(CONFIG, init_lambd=lam)
    wl = bucketed_window_length(lam, T)
    hint = tmodels.dispatch_hint_for(config, wl, lam)
    assert tops.multi_sigma_route(hop_length=80, n_mels=64, optimized=True,
                                  window_length=wl, lambd_hint=hint,
                                  impl="auto")[0] == route
    model = tmodels.get_model_by_config(config, wl, hint, device="cpu")
    xs = rng.standard_normal((5, T)).astype(np.float32)
    preds, scores = tpredict(model, xs, batch_size=2, device="cpu")
    with torch.no_grad():
        want, _ = model.eval()(torch.from_numpy(xs))
    assert scores.shape == (5, 10) and preds.shape == (5,)
    assert np.all((scores >= 0) & (scores <= 1))
    np.testing.assert_allclose(scores, want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(preds, scores.argmax(-1))


def test_train_step_matches_jax(rng, monkeypatch):
    """One train step of the multi-sigma MelPANNsNet against dmel_tpu's
    ``make_train_step`` at lambda 46.7 (the 512 bucket, the exact
    multi-sigma route in both), from the same weights and batch: loss
    within relative 1e-5 and every gradient, dlambda (4,) included,
    within 3e-2 in norm.  dmel_tpu's own float32 gradients sit 0.7-1.4 %
    in norm from a float64 computation of this step (the port's within
    3e-6; PERF.md notes the same of its CNN6 on the CPU), so the port
    is held to the mathematics by ``test_train_step_matches_float64``
    and to dmel_tpu only as closely as dmel_tpu holds to it."""
    monkeypatch.setattr(nn, "Dropout", _NoDropout)
    monkeypatch.setattr(tpanns, "dropout",
                        lambda x, p, training, generator=None: x)
    config = dict(CONFIG, init_lambd=46.7)
    wl = bucketed_window_length(46.7, T)
    hint = jstft.pallas_compile_hint(46.7, wl, 80)
    jmodel = jmodels.get_model_by_config(config, window_length=wl,
                                         lambd_hint=hint)
    x = rng.standard_normal((4, T)).astype(np.float32)
    ys = np.array([0, 3, 5, 9], np.int32)
    mask = np.ones(4, bool)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((4, T))))
    params, stats = variables["params"], variables["batch_stats"]
    params["spectrogram_layer"]["lambd"] = np.array(
        [40.0, 44.0, 48.0, 52.0], np.float32)
    capture = _grad_capture()
    step = jtrain.make_train_step(jmodel, capture, True, 10)
    _, grads, _, _, metrics = step(
        params, capture.init(params), stats, jax.random.PRNGKey(1),
        jnp.asarray(x), jnp.asarray(ys), jnp.asarray(mask))
    grads = from_jax_variables(jax.device_get(grads))

    model = tmodels.get_model_by_config(config, wl, hint, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats))
    opt = build_optimizer(config, model)
    got = ttrain.train_step(model, opt, torch.from_numpy(x),
                            torch.from_numpy(ys), torch.from_numpy(mask),
                            one_hot=True, n_classes=10)
    want_loss = float(metrics["loss"])
    assert abs(float(got["loss"]) - want_loss) <= 1e-5 * want_loss
    named = dict(model.named_parameters())
    lam = "spectrogram_layer.lambd"
    assert named[lam].grad.shape == (4,)
    for key, p in named.items():
        assert _norm_err(p.grad, grads[key]) <= 3e-2, key
    # the vector is one parameter of the lr_tf group
    assert opt.param_groups[0]["params"] == [named[lam]]


@pytest.mark.parametrize("lam", [46.7, 128.0])
def test_train_step_matches_float64(rng, monkeypatch, lam):
    """The port's float32 train-step gradients with four groups (the
    exact route at 46.7, the specband route at 128) against the same
    model in float64 through the exact route: dlambda (4,) and every
    other parameter's gradient within 1e-2 in norm (as
    ``test_torch_training.test_train_step_matches_float64``; at 128 the
    specband function's J = 24 truncation alone moves these small
    dlambdas by ~0.5 %)."""
    monkeypatch.setattr(tpanns, "dropout",
                        lambda x, p, training, generator=None: x)
    config = dict(CONFIG, init_lambd=lam)
    wl = bucketed_window_length(lam, T)
    hint = jstft.pallas_compile_hint(lam, wl, 80)
    x = torch.from_numpy(rng.standard_normal((4, T)).astype(np.float32))
    ys = torch.tensor([0, 3, 5, 9])
    mask = torch.ones(4, dtype=torch.bool)
    model = tmodels.get_model_by_config(config, wl, hint, device="cpu",
                                        seed=1).train()
    with torch.no_grad():
        model.spectrogram_layer.lambd.mul_(
            torch.tensor([0.86, 0.94, 1.03, 1.11]))
    ref = tmodels.get_model_by_config(dict(config, impl="xla"), wl,
                                      device="cpu").train()
    ref.load_state_dict(model.state_dict())
    ref.double()

    def grads(m, xs):
        loss, _, _ = ttrain.loss_and_metrics(m, xs, ys, mask, one_hot=True,
                                             n_classes=10)
        return dict(zip([k for k, _ in m.named_parameters()],
                        torch.autograd.grad(loss, list(m.parameters()))))

    got, want = grads(model, x), grads(ref, x.double())
    assert got["spectrogram_layer.lambd"].shape == (4,)
    for key in got:
        assert _norm_err(got[key].double(), want[key]) <= 1e-2, key


def test_fit_moves_vector_lambda():
    """A tiny ``fit`` with n_sigma = 4 from lambda 128 (the specband
    route): lambda stays (4,) and moves, the records hold its mean and
    each group's value."""
    config = dict(CONFIG, n_points=4096, batch_size=4, max_epochs=2,
                  patience=100, n_samples=20, data_seed=0,
                  sigma_ref=8000 * 0.035 / 6, noise_std=0.05)
    trainset, validset, _ = get_dataset_by_config(config)
    state, history = fit(config, trainset, validset, seed=0, device="cpu")
    lam = state["model"].spectrogram_layer.lambd.detach()
    assert lam.shape == (4,) and bool((lam != 128.0).any())
    for r in history["records"]:
        assert len(r["lambd_est_bands"]) == 4
        assert r["lambd_est"] == pytest.approx(np.mean(r["lambd_est_bands"]))
    assert history["est_lambd"] == pytest.approx(float(lam.mean()))
