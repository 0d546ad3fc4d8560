"""The port's framed module (K3 forward, K4 the window's gradient) against
dmel_tpu's framed kernel, on the CPU.

The same numpy-seeded inputs go through both packages.  Tolerances:

- log-mel max-abs <= 1e-4 (bench.py's gate) against the JAX kernel in
  Pallas interpret mode, whose DFT runs as bf16 hi/lo splits;
- log-mel max-abs <= 1e-5 against the JAX package's exact matmul route
  and the port's ``torch.stft`` route (all float32; they differ in the
  order of the DFT's sums);
- dlambda relative <= 1e-2 (bench.py's gate) against ``jax.grad``
  through the interpret-mode kernel (its adjoint GEMMs are single-pass
  bf16), and <= 1e-4 against ``jax.grad`` of the exact route.

The CUDA kernels run only on a card (tests/test_torch_gpu.py).  Here the
launchers' data layout is emulated in PyTorch and checked: the frame
rows read from the unpadded signal, the DFT bases generated at running
integer phase indices, the mel and dP products over the filterbank's
nonzero ranges, and K4's per-block partial sums.  The wrappers must take
the plain versions for CPU tensors.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import ops as jops
from dmel_tpu.ops.pallas import framed_dmel as jfr
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.ops import _cuda
from dmel_tpu_torch.ops import framed as tfr

GATE = 1e-4
EXACT_GATE = 1e-5
GRAD_GATE = 1e-2
EXACT_GRAD_GATE = 1e-4
SR = 8000

#: the hop / n_fft phase classes of the JAX package's framed tests
#: (tests/test_pallas.py TestFramedKernel)
PHASES = [(16, 256), (48, 256), (8, 128), (32, 384)]


def _signal(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x - x.mean(-1, keepdims=True)


def _geom(n_fft, hop, n_mels):
    return tfr.Geom(n_fft, hop, n_mels, SR, 0.0, float(SR // 2))


def _log(a):
    return np.log(np.asarray(a) + 1e-10)


@pytest.mark.parametrize("n_fft,hop,n_mels", [
    (1024, 80, 64), (1000, 80, 64), (1024, 7, 64), (4096, 80, 64),
    (512, 80, 64), (512, 80, 129), (128, 48, 32), (384, 32, 40)])
def test_supported_matches_jax(n_fft, hop, n_mels):
    assert tfr.supported(n_fft, hop, n_mels) == jfr.supported(n_fft, hop,
                                                              n_mels)


@pytest.mark.parametrize("hop,n_fft", PHASES)
def test_forward_matches_jax_kernel_and_exact(rng, hop, n_fft):
    x = _signal(rng, (2, 1500))
    lam = n_fft / 8.0
    kw = dict(n_fft=n_fft, hop_length=hop, n_mels=32, sample_rate=SR)
    kern = jfr.framed_mel_power(jnp.asarray(x), jops.gaussian_window(
        lam, n_fft), interpret=True, **kw)
    exact_j = jops.mel_spectrogram(
        jnp.asarray(x), lam, n_mels=32, sample_rate=SR, hop_length=hop,
        optimized=True, window_length=n_fft, method="matmul",
        subtract_mean=False)
    exact_t = tops.mel_spectrogram(
        x, lam, n_mels=32, sample_rate=SR, hop_length=hop, optimized=True,
        window_length=n_fft, subtract_mean=False, device="cpu")
    w = tops.gaussian_window(lam, n_fft)
    plain = tfr.framed_mel_power_plain(torch.from_numpy(x), w, **kw)
    port = tfr.framed_mel_power(torch.from_numpy(x), w, **kw)
    assert plain.shape == port.shape == kern.shape == (2, 32, 1500 // hop + 1)
    for got in (plain, port):
        lg = _log(got)
        assert float(np.max(np.abs(lg - _log(kern)))) <= GATE
        assert float(np.max(np.abs(lg - _log(exact_j)))) <= EXACT_GATE
        assert float(np.max(np.abs(lg - _log(exact_t)))) <= EXACT_GATE


def _port_dlambd(x, lam, n_fft, hop, n_mels, cot, impl="framed"):
    lam_t = torch.tensor(lam, requires_grad=True)
    mel = tops.mel_spectrogram(
        x, lam_t, n_mels=n_mels, sample_rate=SR, hop_length=hop,
        optimized=True, window_length=n_fft, impl=impl, log_output=True,
        device="cpu")
    (mel * torch.from_numpy(cot)).sum().backward()
    return float(lam_t.grad)


def _jax_dlambd(x, lam, n_fft, hop, n_mels, cot, kernel):
    def loss(l):
        if kernel:
            xm = jnp.asarray(x) - jnp.mean(jnp.asarray(x), -1, keepdims=True)
            mel = jfr.framed_mel_power(
                xm, jops.gaussian_window(jnp.abs(l), n_fft), n_fft=n_fft,
                hop_length=hop, n_mels=n_mels, sample_rate=SR,
                interpret=True)
        else:
            mel = jops.mel_spectrogram(
                jnp.asarray(x), l, n_mels=n_mels, sample_rate=SR,
                hop_length=hop, optimized=True, window_length=n_fft,
                method="matmul")
        return jnp.sum(jnp.log(mel + 1e-10) * cot)
    return float(jax.grad(loss)(jnp.float32(lam)))


@pytest.mark.parametrize("n_fft,hop,lam", [(256, 16, 32.0), (512, 80, 46.7),
                                           (512, 80, 30.0)])
def test_dlambda_matches_jax(rng, n_fft, hop, lam):
    """dlambda through the port's autograd function (K3's and K4's plain
    versions) against jax.grad through the interpret-mode kernel and
    through the exact route."""
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    cot = rng.uniform(0.5, 1.5, (2, 64, 3000 // hop + 1)).astype(np.float32)
    got = _port_dlambd(x, lam, n_fft, hop, 64, cot)
    kern = _jax_dlambd(x, lam, n_fft, hop, 64, cot, kernel=True)
    exact = _jax_dlambd(x, lam, n_fft, hop, 64, cot, kernel=False)
    assert abs(got - kern) <= GRAD_GATE * abs(kern), (got, kern)
    assert abs(got - exact) <= EXACT_GRAD_GATE * abs(exact), (got, exact)


def _residual(rng, n_fft, hop, n_mels, t, lam, b=2):
    x = torch.from_numpy(_signal(rng, (b, t)))
    w = tops.gaussian_window(lam, n_fft)
    g = _geom(n_fft, hop, n_mels)
    out, reim = tfr.fwd_plain(x, w, g)
    dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    return x, w, g, reim, dmel


@pytest.mark.parametrize("n_fft,hop,n_mels,t,lam", [
    (256, 16, 32, 1001, 32.0), (512, 80, 64, 3000, 46.7),
    (384, 32, 40, 700, 40.0)])
def test_dwindow_plain_matches_autograd(rng, n_fft, hop, n_mels, t, lam):
    """``framed_dwindow_plain`` against torch autograd of the plain mel in
    the window: max error within 1e-5 of the largest entry."""
    x, w, g, reim, dmel = _residual(rng, n_fft, hop, n_mels, t, lam)
    got = tfr.framed_dwindow_plain(x, reim, dmel, g)
    w_leaf = w.clone().requires_grad_()
    (tfr.mel_plain(x, w_leaf, g) * dmel).sum().backward()
    assert got.shape == w_leaf.grad.shape == (n_fft,)
    assert float((got - w_leaf.grad).abs().max()
                 / w_leaf.grad.abs().max()) <= 1e-5


def test_dx_and_frozen_window(rng, monkeypatch):
    """dx through the autograd function equals autograd of the plain
    version; with a frozen window K4's wrapper is not called."""
    calls = []
    real = tfr.framed_dwindow
    monkeypatch.setattr(tfr, "framed_dwindow",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(_signal(rng, (2, 1500))).requires_grad_()
    w = tops.gaussian_window(46.7, 512)
    kw = dict(n_fft=512, hop_length=80, n_mels=64, sample_rate=SR)
    dout = torch.from_numpy(rng.standard_normal((2, 64, 19)).astype(
        np.float32))
    (tfr.framed_mel_power(x, w, **kw) * dout).sum().backward()
    assert calls == []
    xp = x.detach().clone().requires_grad_()
    (tfr.framed_mel_power_plain(xp, w, **kw) * dout).sum().backward()
    assert float((x.grad - xp.grad).abs().max()
                 / xp.grad.abs().max()) <= 1e-5
    lam = torch.tensor(46.7, requires_grad=True)
    tfr.framed_mel_power(x.detach(), tops.gaussian_window(lam, 512),
                         **kw).sum().backward()
    assert calls == [1] and torch.isfinite(lam.grad)


# --- the launchers, emulated -------------------------------------------

def _constants(name: str) -> dict:
    src = (_cuda.SRC_DIR / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _dft_operand(n_fft, kp, n_bins, table, bk, adjoint):
    """The GEMM's B operand as the kernel's B loader builds it, step by
    step: running phase indices ``(m k) mod N`` advanced by ``(BK k)
    mod N`` (forward: per column, over the depth m) or by ``(BK m) mod
    N`` (adjoint: per column m, over the depth k, restarted where the
    -sin plane begins), two depth rows a thread (``b_k`` and ``b_k +
    8``), masked past n_fft and n_bins.  Forward: (depth, 2 kp);
    adjoint: (2 kp, n_fft)."""
    n = n_fft
    if not adjoint:
        j = np.arange(2 * kp)
        sin = j >= kp
        k = np.where(sin, j - kp, j)
        ok = k < n_bins
        kk = np.where(ok, k, 0)
        depth = -(-n // bk) * bk
        out = np.zeros((depth, 2 * kp), np.float32)
        for b_k in range(bk // 2):
            i0, i1, step = (b_k * kk) % n, ((b_k + 8) * kk) % n, (bk * kk) % n
            for k0 in range(0, n, bk):
                for m, idx in ((k0 + b_k, i0), (k0 + b_k + 8, i1)):
                    if m < n:
                        out[m] = np.where(ok, np.where(sin, table[1][idx],
                                                       table[0][idx]), 0.0)
                i0 = i0 + step
                i0 = np.where(i0 >= n, i0 - n, i0)
                i1 = i1 + step
                i1 = np.where(i1 >= n, i1 - n, i1)
        return out
    m = np.arange(n)
    step = (bk * m) % n
    out = np.zeros((2 * kp, n), np.float32)
    for b_k in range(bk // 2):
        f0, f1 = (b_k * m) % n, ((b_k + 8) * m) % n
        i0, i1 = f0, f1
        for k0 in range(0, 2 * kp, bk):
            if k0 == kp:
                i0, i1 = f0, f1
            sin = k0 >= kp
            kb = (k0 - kp if sin else k0) + b_k
            for d, k, idx in ((k0 + b_k, kb, i0), (k0 + b_k + 8, kb + 8, i1)):
                out[d] = table[1 if sin else 0][idx] if k < n_bins else 0.0
            i0 = i0 + step
            i0 = np.where(i0 >= n, i0 - n, i0)
            i1 = i1 + step
            i1 = np.where(i1 >= n, i1 - n, i1)
    return out


def _frames_from_signal(x, n_fft, hop, depth):
    """Frame rows ``b n_frames + t`` read from the unpadded signal with
    the centre padding masked, zero past n_fft: (rows, depth)."""
    b, t = x.shape
    nfr = tops.num_frames(t, hop)
    r = torch.arange(b * nfr)
    m = torch.arange(depth)
    pos = ((r % nfr) * hop - n_fft // 2)[:, None] + m
    ok = (pos >= 0) & (pos < t) & (m < n_fft)
    return torch.where(ok, x[(r // nfr)[:, None], pos.clamp(0, t - 1)],
                       torch.zeros(()))


def emulate_fwd(x, window, g, name="framed_fwd"):
    """The forward launcher and kernels in PyTorch: the windowed frames
    times the generated bases into the (rows, 2 kp) residual, then the
    power projected onto each band over its nonzero bin range, written
    to (B, n_mels, n_frames)."""
    k = _constants(name)
    n_bins, kp = g.n_fft // 2 + 1, tfr.kp_of(g.n_fft)
    assert (2 * kp) % k["BN"] == 0
    c = tfr._kernel_consts(g, x.device)
    bmat = _dft_operand(g.n_fft, kp, n_bins, c.table.numpy(), k["BK"],
                        adjoint=False)
    depth = bmat.shape[0]
    wpad = torch.nn.functional.pad(window, (0, depth - g.n_fft))
    a = _frames_from_signal(x, g.n_fft, g.hop_length, depth) * wpad
    reim = a @ torch.from_numpy(bmat)
    p = reim[:, :n_bins] ** 2 + reim[:, kp:kp + n_bins] ** 2
    mel = torch.stack([
        (p[:, lo:hi] * c.fb[lo:hi, j]).sum(1)
        for j, (lo, hi) in enumerate(zip(c.mel_lo.tolist(),
                                         c.mel_hi.tolist()))], 1)
    b, t = x.shape
    nfr = tops.num_frames(t, g.hop_length)
    return mel.reshape(b, nfr, g.n_mels).transpose(1, 2), reim


def emulate_k4(x, reim, dmel, g):
    """K4's launcher and kernels in PyTorch: dP over each bin's nonzero
    mel range into dRe|dIm (rows, 2 kp), the adjoint GEMM with the
    generated bases, the frame-weighted column sums of each BM-row block
    into an (n_fft, blocks) buffer, then one sum per window sample."""
    k = _constants("framed_bwd")
    n_bins, kp = g.n_fft // 2 + 1, tfr.kp_of(g.n_fft)
    c = tfr._kernel_consts(g, x.device)
    b, t = x.shape
    nfr = tops.num_frames(t, g.hop_length)
    rows = b * nfr
    r = torch.arange(rows)
    g2 = dmel[r // nfr, :, r % nfr]                    # (rows, n_mels)
    dp = torch.zeros((rows, kp))
    for kk, (lo, hi) in enumerate(zip(c.bin_lo.tolist(), c.bin_hi.tolist())):
        dp[:, kk] = (g2[:, lo:hi] * c.fb[kk, lo:hi]).sum(1)
    dreim = 2.0 * reim * torch.cat([dp, dp], 1)
    bmat = _dft_operand(g.n_fft, kp, n_bins, c.table.numpy(), k["BK"],
                        adjoint=True)
    dfw = dreim @ torch.from_numpy(bmat)              # (rows, n_fft)
    frames = _frames_from_signal(x, g.n_fft, g.hop_length, g.n_fft)
    n_blocks = -(-rows // k["BM"])
    prod = torch.nn.functional.pad(frames * dfw,
                                   (0, 0, 0, n_blocks * k["BM"] - rows))
    partials = prod.reshape(n_blocks, k["BM"], g.n_fft).sum(1).T
    assert partials.shape == (g.n_fft, n_blocks)
    return partials.sum(1)


LAUNCH_CASES = [(256, 16, 32, 1001, 32.0, 3), (512, 80, 64, 4000, 46.7, 2),
                (384, 32, 40, 700, 40.0, 3)]


@pytest.mark.parametrize("n_fft,hop,n_mels,t,lam,b", LAUNCH_CASES)
def test_k3_launcher_layout_matches_plain(rng, n_fft, hop, n_mels, t, lam,
                                          b):
    x = torch.from_numpy(_signal(rng, (b, t)))
    w = tops.gaussian_window(lam, n_fft)
    g = _geom(n_fft, hop, n_mels)
    got, reim = emulate_fwd(x, w, g)
    want, reim_p = tfr.fwd_plain(x, w, g)
    assert float((reim - reim_p).abs().max() / reim_p.abs().max()) <= 1e-5
    n_bins, kp = n_fft // 2 + 1, tfr.kp_of(n_fft)
    assert not reim[:, n_bins:kp].any() and not reim[:, kp + n_bins:].any()
    assert float(np.max(np.abs(_log(got) - _log(want)))) <= EXACT_GATE


@pytest.mark.parametrize("n_fft,hop,n_mels,t,lam,b", LAUNCH_CASES)
def test_k4_launcher_layout_matches_plain(rng, n_fft, hop, n_mels, t, lam,
                                          b):
    x, _, g, reim, dmel = _residual(rng, n_fft, hop, n_mels, t, lam, b)
    got = emulate_k4(x, reim, dmel, g)
    want = tfr.framed_dwindow_plain(x, reim, dmel, g)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_wrappers_take_plain_versions_on_cpu(rng):
    x, w, g, reim, dmel = _residual(rng, 256, 16, 32, 1500, 32.0)
    k3, k4 = tfr.framed_mel_power.launches, tfr.framed_dwindow.launches
    out, got_reim = tfr.framed_fwd(x, w, g)
    want, want_reim = tfr.fwd_plain(x, w, g)
    assert torch.equal(out, want) and torch.equal(got_reim, want_reim)
    assert torch.equal(tfr.framed_dwindow(x, reim, dmel, g),
                       tfr.framed_dwindow_plain(x, reim, dmel, g))
    y = tfr.framed_mel_power(x.reshape(1, 2, 1500), w, n_fft=256,
                             hop_length=16, n_mels=32, sample_rate=SR)
    assert y.shape == (1, 2, 32, 94)
    assert (tfr.framed_mel_power.launches, tfr.framed_dwindow.launches) == (
        k3, k4)


def test_bad_inputs_raise():
    kw = dict(n_fft=512, hop_length=80, n_mels=64, sample_rate=SR)
    x = torch.zeros((1, 2000))
    with pytest.raises(ValueError, match="win_length"):
        tfr.framed_mel_power(x, torch.ones(256), **kw)
    with pytest.raises(ValueError, match="unsupported"):
        tfr.framed_mel_power(x, torch.ones(2048), **dict(kw, n_fft=2048))
    with pytest.raises(ValueError, match="unsupported"):
        tfr.framed_mel_power(x, torch.ones(512), **dict(kw, hop_length=7))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfr.framed_fwd(x.to("meta"), torch.ones(512, device="meta"),
                       _geom(512, 80, 64))


@pytest.mark.parametrize("hop,optimized,expect_error", [
    (16, True, False), (7, True, True), (16, False, True)])
def test_explicit_impl_raises_where_jax_raises(rng, hop, optimized,
                                               expect_error):
    """``impl="framed"`` raises ValueError exactly where the JAX
    package's ``impl="pallas_framed"`` does, and otherwise matches it."""
    x = _signal(rng, (2, 1200))
    kw = dict(n_mels=32, sample_rate=SR, hop_length=hop, optimized=optimized,
              window_length=256 if optimized else None)
    if expect_error:
        with pytest.raises(ValueError):
            jops.mel_spectrogram(jnp.asarray(x), 32.0, impl="pallas_framed",
                                 **kw)
        with pytest.raises(ValueError):
            tops.mel_spectrogram(x, 32.0, impl="framed", device="cpu", **kw)
        return
    want = jops.mel_spectrogram(jnp.asarray(x), 32.0, impl="pallas_framed",
                                **kw)
    got = tops.mel_spectrogram(x, 32.0, impl="framed", device="cpu", **kw)
    assert float(np.max(np.abs(_log(got) - _log(want)))) <= GATE
