"""The FFT stage of K1, K3, K5 and K6 (``dmel_tpu_torch/ops/fft_plan.py``,
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
  magnitude; float32 sums of up to 4096 terms), and
  ``irfft_adjoint_mirror``, K6's inverse, against ``N numpy.fft.irfft``
  and the plain direct adjoint likewise;
- K1's extended-bin map applied to ``torch.fft.rfft`` of the frames
  against the plain version's ``xext``, and K5's packed Re|Im against
  the plain version's residual, zero columns included (1e-5 of the
  largest entry);
- K1 and K5 (and K3, which launches K5's kernel) emulated end to end
  through the mirror, against their plain versions, dmel_tpu's plain
  reference ``_specband_xla_ref``, its fused kernel and its framed kernel
  in Pallas interpret mode (log-mel 1e-4, bench.py's gate; 1e-5 against
  the fused kernel, which also runs its DFT in float32);
- K6 emulated through the inverse mirror, its dw summed in the kernel's
  block order, against the torch adjoint and dmel_tpu's fused dw kernel
  in interpret mode (1e-3 of the largest entry, ``chip_smoke.py``'s
  ``DW_GATE``: float32 sums over every frame in another order);
- the FFT stage's accuracy against a float64 reference, beside the
  direct DFT's, on a band-limited clip;
- K5's and K6's Bluestein stage (``fft_plan.fused_stage``) at the even
  n_fft with no plan: a stage the C check takes at every even n_fft in
  [2, 4096], the table its kernels read (``bluestein_table_np``: each
  twiddle and chirp entry one of ``table_np``'s) at every such n_fft,
  the kernels' register-resident passes emulated against the mirror bit
  for bit at every m_pad from 16 to 4096, its mirrors against numpy's
  float64 rfft and irfft (1e-5 of the largest entry), and K5 and K6
  emulated through them at faithful T
  521 and 700 (n_fft 1042 and 1400) against dmel_tpu's fused kernel and
  fused dw kernel in interpret mode (log-mel 1e-4, Re|Im 1e-5 of the
  largest entry, dlambda 1e-2, dw 1e-3), a pack of two trials bit for
  bit two single runs.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from dmel_tpu import ops as jops
from dmel_tpu.ops.pallas import framed_dmel as jfr
from dmel_tpu.ops.pallas import fused_dmel as jfu
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.data import make_esc50_synth_dataset
from dmel_tpu_torch.ops import _cuda, fft_plan, framed, fused, specband
from dmel_tpu_torch.ops.stft import frame_signal, num_frames
from tests.test_torch_framed import _constants, _frames_from_signal
from tests.test_torch_specband import _jax_ref_logmel

GATE = 1e-4
RESIDUAL_GATE = 1e-5
DW_GATE = 1e-3
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
#: n_fft / 2 of Bluestein's stage in the tests: the smallest m with a
#: prime factor above 5, faithful T 521 and 700, and two primes of m_pad
#: 2048 and 4096 (chip_smoke.py's faithful 1021 and 2039)
BLUESTEIN_M = [7, 521, 700, 1021, 2039]


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
    header's own limit; the n_fft K1 and K3 take are all planned but
    896."""
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
    k3 = [n for n in range(128, 4097, 128) if framed.supported(n, 80, 64)]
    assert k3 == list(range(128, 1025, 128))
    assert [n for n in k3 if n not in PLANNED] == [896]


def _header_int(src: str, name: str) -> int:
    """A ``constexpr int`` of a CUDA source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def _stage_accepted(stage, n_fft: int, header: str) -> bool:
    """``frame_fft.cuh:fft_stage_from`` (with ``fft_plan_from``) on the
    arguments ``framed._stage_args`` passes for ``stage``, its limits read
    from the header."""
    max_stages = _header_int(header, "FFT_MAX_STAGES")

    def plan_ok(radices, n):
        prod = 1
        for r in radices:
            if r not in (2, 3, 4, 5):
                return False
            prod *= r
            if prod > n // 2:
                return False
        return len(radices) <= max_stages and prod == n // 2

    if not isinstance(stage, fft_plan.Bluestein):
        return plan_ok(stage, n_fft)
    mp = stage.m_pad
    return (_header_int(header, "BLUESTEIN_MIN_POINTS") <= mp
            <= _header_int(header, "BLUESTEIN_MAX_POINTS")
            and mp & (mp - 1) == 0 and n_fft - 1 <= mp < 2 * (n_fft - 1)
            and plan_ok(stage.radices, 2 * mp)
            and all(r == 4 for r in stage.radices[:-1]))


def test_fused_stage_covers_every_even_nfft():
    """K5's and K6's stage (``fused_stage``) at every even n_fft in [2,
    4096] is one the C check takes: ``plan()``'s radices where it has
    them (unchanged, so K1, K3 and K4 take the stage they took), else
    Bluestein's at the smallest power of two ``>= n_fft - 1``; ``None``
    outside them.  Faithful mode's 513-2048 samples take Bluestein's at
    1494 lengths and a plan at 42."""
    header = (_cuda.SRC_DIR / "frame_fft.cuh").read_text()
    names = {}
    for n in range(2, fft_plan.MAX_N_FFT + 1, 2):
        stage = fft_plan.fused_stage(n)
        assert stage is not None and _stage_accepted(stage, n, header), n
        if fft_plan.plan(n) is not None:
            assert stage == fft_plan.plan(n)
        else:
            assert isinstance(stage, fft_plan.Bluestein)
            assert stage.m_pad == 1 << (n - 2).bit_length() <= 4096
        names[n] = fft_plan.fused_stage_name(n)
        assert fft_plan.stage_name(n) == ("direct" if names[n] == "bluestein"
                                          else "fft")
    faithful = [names[2 * t] for t in range(513, 2049)]
    assert faithful.count("bluestein") == 1494
    assert faithful.count("fft") == 42
    for n in (0, 1023, 4098, 8192):
        assert fft_plan.fused_stage(n) is None
        assert fft_plan.fused_stage_name(n) == "direct"
    # the checks refuse what is not Bluestein's stage of n_fft
    for bad in (fft_plan.Bluestein(4096, (4,) * 6),
                fft_plan.Bluestein(1024, (4, 4, 4, 4, 2)),
                fft_plan.Bluestein(2048, (4, 4, 4, 4, 4)),
                fft_plan.Bluestein(2048, (2, 4, 4, 4, 4, 4))):
        assert not _stage_accepted(bad, 1400, header)
    # the passes take two radix-4 stages at least: 8 points is refused
    assert _stage_accepted(fft_plan.Bluestein(16, (4, 4)), 10, header)
    assert not _stage_accepted(fft_plan.Bluestein(8, (4, 2)), 6, header)


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


@pytest.mark.parametrize("m", BLUESTEIN_M)
def test_bluestein_mirror_matches_numpy_rfft(m):
    """Bluestein's stage at n_fft 2 m (its mirror: the chirp, the
    m_pad-point Stockham stages, ``FFT(b) / m_pad``, the same stages
    again, the chirp) against numpy's float64 rfft within 1e-5 of the
    largest magnitude, printed beside the direct DFT's error (the plain
    version's float32 bases)."""
    n_fft = 2 * m
    assert fft_plan.fused_stage_name(n_fft) == "bluestein"
    x = _signal(n_fft, (3, n_fft))
    re_, im = _mirror_bins(torch.from_numpy(x), n_fft)
    want = np.fft.rfft(x.astype(np.float64))
    scale = np.abs(want).max()
    assert re_.dtype == torch.float32 and re_.shape == want.shape
    err = max(np.abs(re_.numpy() - want.real).max(),
              np.abs(im.numpy() - want.imag).max()) / scale
    c, s = framed._bases_np.__wrapped__(n_fft)
    err_direct = max(np.abs(x @ c - want.real).max(),
                     np.abs(x @ s - want.imag).max()) / scale
    print(f"n_fft {n_fft} (m_pad {fft_plan.fused_stage(n_fft).m_pad}): "
          f"Bluestein {err:.3e}, direct DFT {err_direct:.3e} of max |X|")
    assert err <= RESIDUAL_GATE


def test_bluestein_table_at_every_bluestein_nfft():
    """The table K5's and K6's Bluestein stage reads
    (``fft_plan.bluestein_table_np``) at every even n_fft up to 4096 that
    takes the stage: row ``l - 4 + (r - 1) l + k`` of each stage past the
    first is entry ``r k 2 m_pad / (l R)`` of ``table_np(2 m_pad)``, every
    row below ``m_pad`` is one stage entry or zero, and row ``m_pad + n``
    is entry ``n^2 mod n_fft`` of ``table_np(n_fft)``: the same float32
    values ``rfft_mirror`` reads, laid out for the card."""
    seen = 0
    for n_fft in range(2, fft_plan.MAX_N_FFT + 1, 2):
        stage = fft_plan.fused_stage(n_fft)
        if not isinstance(stage, fft_plan.Bluestein):
            continue
        mp, m = stage.m_pad, n_fft // 2
        got = fft_plan.bluestein_table_np(n_fft, mp)
        assert got.shape == (mp + m, 2) and got.dtype == np.float32
        big = fft_plan.table_np(2 * mp).T
        rows = np.zeros(mp, bool)
        ells = []
        for ell, radix, first in fft_plan.bluestein_stage_twiddles(mp):
            assert first == ell - 4
            ells.append(ell)
            r, k = np.meshgrid(np.arange(1, radix), np.arange(ell),
                               indexing="ij")
            at = first + (r - 1) * ell + k
            assert not rows[at].any()
            rows[at] = True
            assert np.array_equal(got[at], big[r * k * (2 * mp // (ell *
                                                                   radix))])
        assert ells == [4 ** s for s in range(1, len(stage.radices))]
        assert rows.sum() == mp - 4 and not got[:mp][~rows].any()
        assert np.array_equal(got[mp:], fft_plan.table_np(n_fft).T[
            fft_plan.chirp_index(n_fft)])
        seen += 1
    assert seen == 2048 - len([n for n in range(2, 4097, 2)
                               if fft_plan.plan(n) is not None])


def emulate_bluestein_passes(zr, zi, n_fft):
    """The complex DFT of length ``n_fft / 2`` of each row of ``(zr,
    zi)`` as ``frame_fft.cuh:bluestein_frames`` runs Bluestein's stage:
    thread ``t`` of a frame holds the points ``i0 + (P / 16) c`` in
    registers (``i0 = t``), passes of two stages ((4, 4), then the last
    (4, 4), (4, 2), (4, 1) or (2, 1)) on them, each pass's outputs to
    their points in a padded buffer of ``P + P / 16`` (a float2 every 16)
    read back by the next pass; the first FFT's input ``z c`` with the
    zero half never loaded (zeros here), ``B^`` and the conjugation in the
    hand-over between the FFTs (a renaming of registers), the chirp and
    the conjugation on the points below ``m`` of the last pass.  Every
    twiddle and chirp from ``bluestein_table_np``."""
    stage = fft_plan.fused_stage(n_fft)
    mp, m, rows = stage.m_pad, n_fft // 2, zr.shape[0]
    table = torch.from_numpy(fft_plan.bluestein_table_np(n_fft, mp).copy())
    tw, chirp = table[:mp], table[mp:]
    bh = torch.from_numpy(fft_plan.bluestein_kernel_np(n_fft, mp).copy())
    q16 = mp // 16
    i0 = torch.arange(q16)
    n4 = sum(r == 4 for r in stage.radices)
    two = stage.radices[-1] == 2
    rest = n4 - 2
    if rest % 2:
        last = (4, 2) if two else (4, 1)
    else:
        last = (2, 1) if two else (4, 4)
    n_mid = rest // 2 - (last == (4, 4))
    cmul = fft_plan._cmul

    def bl_tw(ell, r, k):
        row = tw[ell - 4 + (r - 1) * ell + k]
        return row[:, 0], row[:, 1]

    def bl_pass(v, radices, ell):
        r1, r2 = radices
        s_ = r1 * r2
        for u in range(16 // s_):
            k = (i0 + q16 * u) & (ell - 1)
            for rr in range(r2):
                a = [v[u * s_ + r * r2 + rr] for r in range(r1)]
                if ell > 1:
                    a = [a[0]] + [cmul(*a[r], *bl_tw(ell, r, k))
                                  for r in range(1, r1)]
                for q, o in enumerate(fft_plan._butterfly(r1, a, None)):
                    v[u * s_ + q * r2 + rr] = o
            if r2 > 1:
                for q in range(r1):
                    a = [v[u * s_ + q * r2 + rr] for rr in range(r2)]
                    a = [a[0]] + [cmul(*a[rr], *bl_tw(r1 * ell, rr,
                                                      q * ell + k))
                                  for rr in range(1, r2)]
                    for qq, o in enumerate(fft_plan._butterfly(r2, a, None)):
                        v[u * s_ + q * r2 + qq] = o

    def pad(i):
        return i + (i >> 4)

    def read(buf, radices):
        s_ = radices[0] * radices[1]
        return [tuple(b[:, pad(i0 + q16 * (c // s_) + (c % s_) * (mp // s_))]
                      for b in buf) for c in range(16)]

    def write(v, radices, ell):
        r1, r2 = radices
        s_ = r1 * r2
        buf = (torch.full((rows, mp + q16), float("nan")),
               torch.full((rows, mp + q16), float("nan")))
        for u in range(16 // s_):
            i = i0 + q16 * u
            k = i & (ell - 1)
            for q in range(r1):
                for qq in range(r2):
                    at = pad((i - k) * s_ + k + ell * (q + r1 * qq))
                    buf[0][:, at], buf[1][:, at] = v[u * s_ + q * r2 + qq]
        assert not torch.isnan(buf[0][:, pad(torch.arange(mp))]).any()
        return buf

    def fft(v):
        """The passes past the first; returns the last pass's registers."""
        if n_mid < 0:
            return v
        buf, ell = write(v, (4, 4), 1), 16
        for _ in range(n_mid):
            v = read(buf, (4, 4))
            bl_pass(v, (4, 4), ell)
            buf, ell = write(v, (4, 4), ell), ell * 16
        v = read(buf, last)
        bl_pass(v, last, ell)
        return v

    zero = torch.zeros((rows, q16))
    v = []
    for c in range(16):
        n = i0 + q16 * c
        ok = n < m
        nn = torch.where(ok, n, 0)
        a = cmul(zr[:, nn], zi[:, nn], chirp[nn, 0], chirp[nn, 1])
        v.append(tuple(torch.where(ok, x, zero) for x in a))
    bl_pass(v, (4, 4), 1)
    v = fft(v)
    s_ = last[0] * last[1]
    hand = [None] * 16
    for u in range(16 // s_):
        for q in range(last[0]):
            for qq in range(last[1]):
                c = u + (16 // s_) * (q + last[0] * qq)
                p_ = i0 + q16 * c
                br, bi = cmul(*v[u * s_ + q * last[1] + qq], bh[p_, 0],
                              bh[p_, 1])
                hand[c] = (br, -bi)
    v = hand
    bl_pass(v, (4, 4), 1)
    v = fft(v)
    outr, outi = torch.zeros((rows, m)), torch.zeros((rows, m))
    for u in range(16 // s_):
        for q in range(last[0]):
            for qq in range(last[1]):
                if 2 * (q + last[0] * qq) >= s_:
                    continue
                p_ = i0 + q16 * (u + (16 // s_) * (q + last[0] * qq))
                ok = p_ < m
                zr_, zi_ = v[u * s_ + q * last[1] + qq]
                o = cmul(zr_[:, ok], -zi_[:, ok], chirp[p_[ok], 0],
                         chirp[p_[ok], 1])
                outr[:, p_[ok]], outi[:, p_[ok]] = o
    return outr, outi


@pytest.mark.parametrize("m", [7, 14, 22, 44, 77, 154, 257, 700, 1021, 2039])
def test_bluestein_passes_give_the_mirror_bit_for_bit(m):
    """Bluestein's stage as the kernels run it (passes of two stages in
    registers, the padded buffer, the hand-over; ``emulate_bluestein_
    passes``) at every m_pad from 16 to 4096 gives ``fft_plan``'s mirror
    of the stage bit for bit: the same butterflies, twiddles and
    products, the additions of zero and the multiplies by twiddle entry
    0 (exactly 1) aside, which change no finite nonzero value."""
    n_fft = 2 * m
    stage = fft_plan.fused_stage(n_fft)
    assert isinstance(stage, fft_plan.Bluestein)
    z = torch.from_numpy(_signal(m, (3, n_fft))).reshape(3, m, 2)
    tc, ts = torch.tensor(fft_plan.table_np(n_fft))
    want = fft_plan._bluestein(z[..., 0], z[..., 1], stage, tc, ts)
    got = emulate_bluestein_passes(z[..., 0], z[..., 1], n_fft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_fft", PLANNED + [2 * m for m in BLUESTEIN_M])
def test_adjoint_mirror_matches_numpy_irfft_and_direct_adjoint(n_fft):
    """K6's inverse FFT against ``N irfft(Y)`` (``Y = (dRe + i dIm) / 2``
    inside, ``dRe`` itself at DC and Nyquist) in float64 and against the
    plain direct adjoint ``dre C^T + dim S^T`` of
    ``framed.framed_dwindow_plain``, at every planned n_fft (odd n_fft /
    2 included, where no bin pairs with itself) and on Bluestein's stage
    (no plan: the mirror takes ``fused_stage``'s)."""
    rng = np.random.default_rng(n_fft)
    n_bins = n_fft // 2 + 1
    dre, dim = rng.standard_normal((2, 3, n_bins)).astype(np.float32)
    got = fft_plan.irfft_adjoint_mirror(
        (torch.from_numpy(dre), torch.from_numpy(dim)),
        fft_plan.plan(n_fft), n_fft)
    y = (dre + 1j * dim.astype(np.float64)) / 2
    y[:, 0], y[:, -1] = dre[:, 0], dre[:, -1]
    want = n_fft * np.fft.irfft(y, n=n_fft)
    scale = np.abs(want).max()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= RESIDUAL_GATE * scale
    c, s = (torch.tensor(b) for b in framed._bases_np.__wrapped__(n_fft))
    direct = torch.from_numpy(dre) @ c.T + torch.from_numpy(dim) @ s.T
    assert float((got - direct).abs().max()) <= RESIDUAL_GATE * scale


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
    (4096, 4096, 400, 6000), (512, 512, 80, 3000), (1400, 700, 80, 700),
    (4078, 2039, 80, 2039), (14, 14, 4, 300)])
def test_emulated_k5_fft_stage_matches_plain(n_fft, win, hop, t):
    """K5's FFT stage, which K3 launches too (512, 1024), and Bluestein's
    (1400, 4078 at m_pad 4096, 14 at m_pad 16)."""
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
    (1000, 128, 128, 20, 16), (1500, 512, 512, 80, 64),
    (521, 521, 1042, 80, 64), (700, 700, 1400, 80, 64)])
def test_emulated_k5_matches_jax_kernel(t, win, n_fft, hop, n_mels):
    """The emulated K5 (Bluestein's stage at faithful T 521 and 700)
    against dmel_tpu's fused kernel in interpret mode: log-mel within
    1e-5 (both take the DFT in float32), Re|Im within 1e-5 of the plain
    version's largest entry, and dlambda of the summed log-mel, through
    the mirror's arithmetic and through the JAX kernel's vjp, within
    1e-2 (bench.py's gate)."""
    x = _signal(6, (2, t))
    lam = win / 8.0
    kw = dict(win_length=win, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
              sample_rate=SR)

    def jax_logmel(lj):
        return jnp.log(jfu.dmel_power(jnp.asarray(x), lj, interpret=True,
                                      **kw) + 1e-10)

    want, jvjp = jax.vjp(jax_logmel, jnp.float32(lam))
    want = np.asarray(want)
    lam_t = torch.tensor(lam, requires_grad=True)
    w = fused.pad_window(tops.gaussian_window(lam_t, win), n_fft)
    g = _k5_geom(n_fft, hop, n_mels)
    got, reim = emulate_k5_fft(torch.from_numpy(x), w, g)
    got = torch.log(got + 1e-10)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= RESIDUAL_GATE
    _, reim_p = framed.fwd_plain(torch.from_numpy(x), w.detach(), g)
    assert _rel(reim.detach(), reim_p) <= RESIDUAL_GATE
    got.sum().backward()
    dlam = float(jvjp(jnp.ones_like(jnp.asarray(want)))[0])
    assert abs(float(lam_t.grad) - dlam) <= 1e-2 * abs(dlam)


@pytest.mark.parametrize("n_fft,hop,n_mels,t,lam", [
    (512, 80, 64, 3000, 46.7), (1024, 80, 64, 4000, 150.0)])
def test_emulated_k3_matches_jax_kernel(n_fft, hop, n_mels, t, lam):
    """K3 launches K5's FFT kernel: emulated through the mirror, against
    dmel_tpu's framed kernel in interpret mode (bf16 hi/lo splits there)
    at bench.py's gate, and the plain version's residual."""
    x = _signal(8, (2, t))
    w = tops.gaussian_window(lam, n_fft)
    g = _k5_geom(n_fft, hop, n_mels)
    got, reim = emulate_k5_fft(torch.from_numpy(x), w, g)
    _, reim_p = framed.fwd_plain(torch.from_numpy(x), w, g)
    assert _rel(reim, reim_p) <= RESIDUAL_GATE
    want = np.asarray(jfr.framed_mel_power(
        jnp.asarray(x), jops.gaussian_window(lam, n_fft), n_fft=n_fft,
        hop_length=hop, n_mels=n_mels, sample_rate=SR, interpret=True))
    assert got.shape == want.shape
    assert np.abs(np.log(got.numpy() + 1e-10)
                  - np.log(want + 1e-10)).max() <= GATE


def emulate_k6_fft(x2, reim, dmel, g):
    """K6 with the FFT stage, step by step: dP over each bin's nonzero mel
    bands, the half spectrum dRe|dIm, the inverse mirror to dfw, the
    frame product; then the sums in the kernel's order: frame groups of
    ``max(1, FFT_BLOCK_POINTS / n_fft)`` rows, group ``i`` to block ``i
    mod blocks`` (``blocks = min(DW_BLOCKS, groups)``), a block's groups
    in order, then its frames, then the blocks' partials."""
    return _block_order_dw(
        _frames_from_signal(x2, g.n_fft, g.hop_length, g.n_fft)
        * _emulated_dfw(x2, reim, dmel, g), g.n_fft)


def _emulated_dfw(x2, reim, dmel, g):
    """K6's dfw ``(rows, n_fft)`` as its stage computes it: dP over each
    bin's nonzero mel bands, the half spectrum, the inverse mirror."""
    n, nfr = g.n_fft, num_frames(x2.shape[1], g.hop_length)
    n_bins, kp, rows = n // 2 + 1, framed.kp_of(n), reim.shape[0]
    c = framed._kernel_consts(g, x2.device)
    r = torch.arange(rows)
    g2 = dmel[r // nfr, :, r % nfr]                    # (rows, n_mels)
    dp = torch.zeros((rows, n_bins))
    for k, (lo, hi) in enumerate(zip(c.bin_lo.tolist(), c.bin_hi.tolist())):
        dp[:, k] = (g2[:, lo:hi] * c.fb[k, lo:hi]).sum(1)
    dre, dim = 2.0 * reim[:, :n_bins] * dp, 2.0 * reim[:, kp:kp + n_bins] * dp
    return fft_plan.irfft_adjoint_mirror((dre, dim), fft_plan.fused_stage(n),
                                         n)


def _block_order_dw(prod, n):
    """dw from the frame products ``prod`` (rows, n) summed in K6's block
    order: frame groups of the stage's frames a block (``frame_fft.cuh:
    fft_stage_frames``), group ``i`` to block ``i mod blocks`` (``blocks =
    min(DW_BLOCKS, groups)``, ``DW_BLOCKS_BLUESTEIN`` on Bluestein's
    stage), a block's groups in order, then its frames, then the blocks'
    partials."""
    rows = prod.shape[0]
    header = (_cuda.SRC_DIR / "frame_fft.cuh").read_text()
    points = _header_int(header, "FFT_BLOCK_POINTS")
    stage = fft_plan.fused_stage(n)
    bluestein = isinstance(stage, fft_plan.Bluestein)
    fr = max(1, points // (stage.m_pad if bluestein else n))
    groups = -(-rows // fr)
    blocks = min(_constants("framed_bwd")[
        "DW_BLOCKS_BLUESTEIN" if bluestein else "DW_BLOCKS"], groups)
    walks = -(-groups // blocks)
    prod = torch.nn.functional.pad(prod, (0, 0, 0, walks * blocks * fr - rows))
    partials = prod.reshape(walks, blocks, fr, n).sum(0).sum(1)
    return partials.sum(0)


#: (n_fft, win, hop, n_mels, T, B): fused buckets, faithful 3000, K4's
#: 512 (8 frames a group), and 4096 with more groups than DW_BLOCKS
K6_CASES = [(1024, 1024, 80, 64, 3000, 2), (2048, 2048, 160, 64, 4000, 2),
            (3000, 1500, 80, 64, 1500, 2), (512, 512, 40, 32, 2000, 3),
            (4096, 4096, 40, 64, 11000, 2)]
#: Bluestein's stage: faithful T 521 and 700 (m_pad 2048), faithful 2039
#: at hop 1 (m_pad 4096: more groups than DW_BLOCKS_BLUESTEIN), and 14
#: (m_pad 16, 256 frames a group)
K6_BLUESTEIN = [(1042, 521, 80, 64, 521, 2), (1400, 700, 80, 64, 700, 2),
                (4078, 2039, 1, 64, 2039, 1), (14, 14, 4, 4, 300, 2)]


def _k6_operands(n_fft, win, hop, n_mels, t, b, seed=9):
    x = torch.from_numpy(_signal(seed, (b, t)))
    w = fused.pad_window(tops.gaussian_window(win / 8, win), n_fft)
    g = _k5_geom(n_fft, hop, n_mels)
    out, reim = emulate_k5_fft(x, w, g)
    dmel = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(out.shape)).astype(np.float32))
    return x, w, g, reim, dmel


@pytest.mark.parametrize("case", K6_CASES + K6_BLUESTEIN,
                         ids=lambda c: f"nfft{c[0]}")
def test_emulated_k6_fft_stage_matches_plain(case):
    x, _, g, reim, dmel = _k6_operands(*case)
    got = emulate_k6_fft(x, reim, dmel, g)
    want = framed.framed_dwindow_plain(x, reim, dmel, g)
    assert _rel(got, want) <= DW_GATE


@pytest.mark.parametrize("case", K6_CASES[:3] + K6_BLUESTEIN[:2],
                         ids=lambda c: f"nfft{c[0]}")
def test_emulated_k6_matches_jax_fused_bwd(case, monkeypatch):
    """The window's gradient from emulated K5 and K6 against dmel_tpu's
    fused forward and its fused dw kernel (``USE_FUSED_BWD``), both in
    interpret mode, for the same cotangent."""
    x, w, g, reim, dmel = _k6_operands(*case)
    got = emulate_k6_fft(x, reim, dmel, g)
    monkeypatch.setattr(jfu, "USE_FUSED_BWD", True)
    fb = jops.melscale_fbanks(g.n_fft // 2 + 1, 0.0, SR // 2, g.n_mels, SR)
    _, vjp = jax.vjp(lambda wj: jfu._dmel_from_window(
        jnp.asarray(x.numpy()), wj, fb, g.n_fft, g.hop_length, True,
        jnp.float32), jnp.asarray(w.numpy()))
    want = np.asarray(vjp(jnp.asarray(dmel.transpose(1, 2).numpy()))[0])
    assert np.abs(got.numpy() - want).max() <= DW_GATE * np.abs(want).max()


@pytest.mark.parametrize("n_fft,win,t", [(1400, 700, 700), (3000, 1500, 1500),
                                         (14, 14, 300)])
def test_emulated_packed_k5_k6_match_single_runs(n_fft, win, t):
    """K5 and K6 on a pack of two trials emulated as one launch runs it:
    the mirror over both trials' frame rows at once, each windowed by its
    trial's window, then each trial's dw in the kernel's block order.
    Trial k's Re|Im, mel and dw are bit for bit a single run's on its
    rows (Bluestein's stage at 1400 and 14, a plan's at 3000)."""
    b, hop = 2, 80 if n_fft > 14 else 4
    x = torch.from_numpy(_signal(11, (2 * b, t)))
    ws = torch.stack([fused.pad_window(tops.gaussian_window(lam, win), n_fft)
                      for lam in (win / 8.0, win / 5.0)])
    g = _k5_geom(n_fft, hop, 64 if n_fft > 14 else 4)
    nfr = num_frames(t, hop)
    frames = (frame_signal(x, n_fft, hop).reshape(2, b * nfr, n_fft)
              * ws[:, None, :]).reshape(-1, n_fft)
    re_, im = _mirror_bins(frames, n_fft)
    reim = _pack_reim(re_, im, n_fft)
    mel = (re_ * re_ + im * im) @ framed._fb(g, x.device)
    dmel = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2 * b, g.n_mels, nfr)).astype(np.float32))
    dfw = _emulated_dfw(x, reim, dmel, g)
    prod = _frames_from_signal(x, n_fft, hop, n_fft) * dfw
    for k in range(2):
        rows, sig = slice(k * b * nfr, (k + 1) * b * nfr), slice(k * b,
                                                                  (k + 1) * b)
        out1, reim1 = emulate_k5_fft(x[sig], ws[k], g)
        assert torch.equal(reim[rows], reim1)
        assert torch.equal(mel[rows].reshape(b, nfr, -1).transpose(1, 2),
                           out1)
        assert torch.equal(_block_order_dw(prod[rows], n_fft),
                           emulate_k6_fft(x[sig], reim1, dmel[sig], g))


@pytest.mark.parametrize("n_fft", range(128, framed.FRAMED_MAX_NFFT + 1, 128))
def test_k4_takes_the_fft_stage_at_every_framed_nfft_but_896(n_fft):
    """K4's stage (``framed.dwindow_radices``): the inverse FFT of the
    forward's plan at every n_fft the framed guard takes, the direct
    adjoint only at 896 = 2^7 7."""
    assert framed.supported(n_fft, 80, 64)
    radices = framed.dwindow_radices(n_fft)
    assert radices == fft_plan.plan(n_fft)
    assert (radices is None) == (n_fft == 896)


@pytest.mark.parametrize("n_fft,hop,n_mels,t,b", [(512, 80, 64, 3000, 2),
                                                  (1024, 80, 64, 3000, 2)])
def test_emulated_k4_fft_stage_matches_jax_framed_bwd(n_fft, hop, n_mels, t,
                                                      b):
    """K4 on the inverse-FFT stage (K6's kernel, 8 and 4 frames a group),
    on K3's emulated residual, against the window's gradient of
    dmel_tpu's framed kernel through ``jax.vjp`` in interpret mode, for
    the same cotangent: within 1e-2 of the largest entry, bench.py's
    gradient gate (the TPU adjoint's GEMMs are single-pass bf16)."""
    x, w, g, reim, dmel = _k6_operands(n_fft, n_fft, hop, n_mels, t, b)
    got = emulate_k6_fft(x, reim, dmel, g)
    assert _rel(got, framed.framed_dwindow_plain(x, reim, dmel, g)) \
        <= DW_GATE
    _, vjp = jax.vjp(lambda wj: jfr.framed_mel_power(
        jnp.asarray(x.numpy()), wj, n_fft=n_fft, hop_length=hop,
        n_mels=n_mels, sample_rate=SR, interpret=True),
        jnp.asarray(w.numpy()))
    want = np.asarray(vjp(jnp.asarray(dmel.numpy()))[0])
    assert got.shape == want.shape == (n_fft,)
    assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()


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


@pytest.mark.parametrize("n_fft,lam", [(512, 46.7), (1024, 150.0)])
def test_k3_fft_stage_against_float64_on_band_limited_clips(n_fft, lam):
    """K3's FFT stage on the framed model path's input (esc50_synth clips,
    windowed): its spectra at least twice as near a float64 reference as
    the plain direct DFT's, and its log-mel, like the direct DFT's,
    within half bench.py's gate of the float64 log-mel.  The quietest
    bands set the log-mel error, so there the FFT need not be the nearer
    of the two."""
    x = make_esc50_synth_dataset(seed=0, n_samples=4).xs
    x = torch.from_numpy(np.asarray(x, np.float32))
    x = x - x.mean(-1, keepdim=True)
    w = tops.gaussian_window(lam, n_fft)
    g = _k5_geom(n_fft, 80, 64)
    frames = (frame_signal(x, n_fft, 80) * w).reshape(-1, n_fft)
    ref = torch.fft.rfft(frames.double())
    re_, im = _mirror_bins(frames, n_fft)
    n_bins, kp = n_fft // 2 + 1, framed.kp_of(n_fft)
    _, reim = framed.fwd_plain(x, w, g)
    fb = framed._fb(g, x.device).double()

    def errs(re_, im):
        re_, im = re_.double(), im.double()
        spec = max(float((re_ - ref.real).abs().max()),
                   float((im - ref.imag).abs().max()))
        mel = torch.log((re_ ** 2 + im ** 2) @ fb + 1e-10)
        mel_ref = torch.log((ref.real ** 2 + ref.imag ** 2) @ fb + 1e-10)
        return spec, float((mel - mel_ref).abs().max())

    spec_fft, mel_fft = errs(re_, im)
    spec_dir, mel_dir = errs(reim[:, :n_bins], reim[:, kp:kp + n_bins])
    assert spec_fft * 2 <= spec_dir, (spec_fft, spec_dir)
    assert max(mel_fft, mel_dir) <= GATE / 2, (mel_fft, mel_dir)


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
