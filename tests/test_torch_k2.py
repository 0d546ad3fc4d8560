"""K2, the specband backward into the taps (``csrc/specband_bwd.cu``), on
the CPU through ``emulate_k2``: the kernel's work items (frame rows x bin
tiles over the tiles that meet some sigma's bin range), its per-sigma
masking, the blocks' runs of items and the order their partials are
summed in, step by step in PyTorch.

- Against ``specband_drho_plain`` on the same operands, at k_sig 1 and
  4, with the log epilogue on and off, at J 12, 16 and 24, with a band
  map that is not contiguous (one sigma without a band), and at n_fft
  4096 with more work items than the kernel's fixed grid has blocks:
  within 1e-5 of the largest tap's gradient (float32 sums over every
  frame row in another order).  The spectra's padding columns hold NaN,
  so a read of them would show.
- Against ``dmel_tpu``'s specband backward in Pallas interpret mode
  (``jax.vjp`` of ``specband_mel_power`` and ``specband_mel_power_multi``
  in the window), one single-sigma and one multi-sigma case: the
  window's gradient through the emulated K2 within 1e-2 of its largest
  entry (bench.py's gradient gate; the TPU adjoint casts dS and the tap
  matrix to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import ops as jops
from dmel_tpu.ops.pallas import specband_dmel as jsb
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.ops import specband as tsb
from tests.test_torch_specband import emulate_k2, k2_constants

SR = 8000
#: the mirror against the plain version: of the largest tap's gradient
DRHO_GATE = 1e-5
#: against the JAX kernels' backward: of the largest window gradient
JAX_GATE = 1e-2
#: a band map that is not contiguous: groups interleaved, sigma 3 empty
SCATTERED_64 = tuple((i * 5) % 3 for i in range(64))

# (n_fft, n_mels, J, rows as (B, n_frames), k_sig, band map kind, log)
CASES = [
    (256, 32, 12, (2, 94), 1, None, False),
    (256, 32, 12, (2, 94), 1, None, True),
    (512, 32, 16, (3, 51), 1, None, True),
    (1024, 64, 24, (2, 38), 1, None, False),
    (1024, 64, 24, (2, 38), 1, None, True),
    (1024, 64, 24, (2, 38), 4, "contiguous", False),
    (1024, 64, 24, (2, 38), 4, "contiguous", True),
    (512, 64, 16, (2, 60), 4, "scattered", False),
    (4096, 64, 12, (2, 600), 1, None, True),
]


def _operands(case, seed=0):
    """Spectra with NaN in their padding columns, taps from Gaussian
    windows, a cotangent and, with the log epilogue, a log-mel."""
    n_fft, n_mels, j, (b, nfr), k_sig, kind, log = case
    rng = np.random.default_rng(seed)
    n_bins = n_fft // 2 + 1
    k_ext = n_bins + 2 * j
    kp = tsb._kp(n_fft, j)
    xext = torch.from_numpy(rng.standard_normal(
        (b * nfr, 2 * kp)).astype(np.float32))
    xext[:, k_ext:kp] = float("nan")
    xext[:, kp + k_ext:] = float("nan")
    lams = np.linspace(n_fft / 10, n_fft / 8, k_sig)
    ws = torch.stack([tops.gaussian_window(float(lam), n_fft)
                      for lam in lams])
    rho = tsb.window_taps_sym(ws, n_fft, j)
    band_map = None
    if kind == "contiguous":
        band_map = tuple(int(v) for v in tops.default_band_map(n_mels,
                                                               k_sig))
    elif kind == "scattered":
        band_map = SCATTERED_64[:n_mels]
    if band_map is None:
        rho = rho[0]
    fb = tsb._fb_dense(n_fft, n_mels, SR, 0.0, float(SR // 2),
                       torch.device("cpu"))
    dmel = torch.from_numpy(rng.standard_normal(
        (b, n_mels, nfr)).astype(np.float32))
    logmel = (torch.from_numpy(rng.uniform(-3.0, 1.0, (b, n_mels, nfr))
                               .astype(np.float32)) if log else None)
    return xext, rho, fb, dmel, logmel, band_map


@pytest.mark.parametrize(
    "case", CASES,
    ids=lambda c: f"nfft{c[0]}-J{c[2]}-k{c[4]}-{c[5]}-log{int(c[6])}")
def test_emulated_k2_matches_plain(case):
    xext, rho, fb, dmel, logmel, band_map = _operands(case)
    got = emulate_k2(xext, rho, fb, dmel, logmel, band_map)
    want = tsb.specband_drho_plain(xext, rho, fb, dmel, logmel, band_map)
    assert got.shape == want.shape == rho.shape
    assert torch.isfinite(want).all()
    assert float((got - want).abs().max() / want.abs().max()) <= DRHO_GATE


def test_work_items_outnumber_blocks_at_4096():
    """The 4096 case above gives more work items than the fixed grid has
    blocks, so blocks sum runs of several items."""
    k = k2_constants()
    n_fft, _, j, (b, nfr), _, _, _ = CASES[-1]
    n_bins = n_fft // 2 + 1
    items = -(-b * nfr // k["ROWS"]) * -(-n_bins // k["TB"])
    assert items > k["GRAD_BLOCKS"], (items, k)


def _dwindow(x, windows, g, cot):
    """The window's gradient through K1's plain forward and the emulated
    K2: the taps' gradient pulled back through ``window_taps_sym``."""
    w = windows.clone().requires_grad_()
    rho = tsb.window_taps_sym(w, g.n_fft, g.j_taps)
    if g.band_map is None:
        rho = rho[0]
    out, xext = tsb._fwd_plain(torch.from_numpy(x), rho.detach(), g)
    _, fb, _ = tsb._consts(g, torch.device("cpu"))
    drho = emulate_k2(xext, rho.detach(), fb, torch.from_numpy(cot),
                      out if g.log_epilogue else None, g.band_map)
    rho.backward(drho)
    return w.grad.numpy()


def test_emulated_k2_matches_jax_single_sigma():
    n_fft, hop, n_mels, j, t, lam = 256, 16, 32, 12, 1500, 24.0
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, t)).astype(np.float32)
    x -= x.mean(-1, keepdims=True)
    cot = rng.uniform(0.5, 1.5, (2, n_mels, t // hop + 1)).astype(
        np.float32)
    w = tops.gaussian_window(lam, n_fft)[None]
    g = tsb._Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2), j, True)
    got = _dwindow(x, w, g, cot)[0]

    def loss(wj):
        return jnp.sum(jsb.specband_mel_power(
            jnp.asarray(x), wj, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
            sample_rate=SR, j_taps=j, interpret=True, log_epilogue=True)
            * cot)
    want = np.asarray(jax.grad(loss)(jnp.asarray(w[0].numpy())))
    assert got.shape == want.shape == (n_fft,)
    assert np.abs(got - want).max() <= JAX_GATE * np.abs(want).max()


def test_emulated_k2_matches_jax_multi_sigma():
    n_fft, hop, n_mels, j, t = 256, 16, 32, 12, 1500
    lams = (24.0, 28.0, 32.0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, t)).astype(np.float32)
    x -= x.mean(-1, keepdims=True)
    cot = rng.uniform(0.5, 1.5, (2, n_mels, t // hop + 1)).astype(
        np.float32)
    band_map = SCATTERED_64[:n_mels]
    ws = torch.stack([tops.gaussian_window(lam, n_fft) for lam in lams])
    g = tsb._Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2), j, False,
                  band_map)
    got = _dwindow(x, ws, g, cot)

    def loss(wj):
        return jnp.sum(jsb.specband_mel_power_multi(
            jnp.asarray(x), wj, band_map, n_fft=n_fft, hop_length=hop,
            n_mels=n_mels, sample_rate=SR, j_taps=j, interpret=True) * cot)
    want = np.asarray(jax.grad(loss)(jnp.asarray(ws.numpy())))
    assert got.shape == want.shape == (len(lams), n_fft)
    assert np.abs(got - want).max() <= JAX_GATE * np.abs(want).max()
