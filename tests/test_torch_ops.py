"""dmel_tpu_torch's exact ops and dispatch against dmel_tpu, on the CPU.

The same numpy-seeded inputs go through both packages.  Tolerances:
windows, filterbanks and exact (log-)mel to rtol 1e-5 (float32 against
float32; log-mel values near 0 also get atol 1e-5); the host-side
guards must agree exactly.  Also: the port and ``chip_smoke.py`` load no
JAX module, and the entry points refuse to fall back to the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import ops as jops
from dmel_tpu.ops import stft as jstft
from dmel_tpu.ops.pallas import framed_dmel, fused_dmel, specband_dmel
from dmel_tpu_torch import ops as tops
from dmel_tpu_torch.ops import framed as tframed
from dmel_tpu_torch.ops import fused as tfused
from dmel_tpu_torch.ops import specband as tspecband
from dmel_tpu_torch.ops import stft as tstft

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack",
             "dmel_tpu")


class TestWindow:
    @pytest.mark.parametrize("lambd", [1.276, 6.38, 31.9, 128.0, 400.0])
    @pytest.mark.parametrize("norm", [False, True])
    @pytest.mark.parametrize("length", [128, 129, 1024])
    def test_matches_jax(self, lambd, norm, length):
        want = np.asarray(jops.gaussian_window(lambd, length, norm=norm))
        got = tops.gaussian_window(lambd, length, norm=norm).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)

    @pytest.mark.parametrize("norm", [False, True])
    def test_grad_matches_jax(self, rng, norm):
        wts = rng.standard_normal(128).astype(np.float32)
        lam = torch.tensor(6.38, requires_grad=True)
        (tops.gaussian_window(lam, 128, norm=norm)
         * torch.from_numpy(wts)).sum().backward()
        g = jax.grad(lambda l: jnp.sum(
            jops.gaussian_window(l, 128, norm=norm) * wts))(6.38)
        np.testing.assert_allclose(float(lam.grad), float(g), rtol=1e-5)


class TestMel:
    @pytest.mark.parametrize("n_freqs,n_mels,sr", [
        (65, 64, 8000), (513, 64, 8000), (2049, 64, 8000),
        (513, 128, 16000)])
    @pytest.mark.parametrize("scale", ["htk", "slaney"])
    def test_fbanks_match_jax(self, n_freqs, n_mels, sr, scale):
        want = np.asarray(jops.melscale_fbanks(n_freqs, 0.0, sr // 2,
                                               n_mels, sr, mel_scale=scale))
        got = tops.melscale_fbanks(n_freqs, 0.0, sr // 2, n_mels, sr,
                                   mel_scale=scale).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

    def test_hz_mel_roundtrip(self):
        f = np.linspace(0, 8000, 17)
        for scale in ("htk", "slaney"):
            np.testing.assert_allclose(tops.mel_to_hz(tops.hz_to_mel(
                f, scale), scale), f, rtol=1e-12, atol=1e-9)


# (optimized, window_length, T, hop, n_mels, lambd)
GEOMS = [(True, 256, 1500, 16, 32, 40.0),
         (True, 1024, 4000, 80, 64, 128.0),
         (True, 128, 1001, 10, 16, 13.3),
         (False, None, 300, 4, 16, 20.0)]


class TestExactPath:
    @pytest.mark.parametrize("geom", GEOMS, ids=str)
    @pytest.mark.parametrize("log", [False, True])
    def test_matches_jax(self, rng, geom, log):
        opt, wl, t, hop, n_mels, lam = geom
        x = rng.standard_normal((2, t)).astype(np.float32)
        kw = dict(n_mels=n_mels, sample_rate=8000, hop_length=hop,
                  optimized=opt, window_length=wl, log_output=log)
        want = np.asarray(jops.mel_spectrogram(jnp.asarray(x), lam, **kw))
        got = tops.mel_spectrogram(x, lam, impl="exact", device="cpu",
                                   **kw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 if log else 0)

    def test_normalized_window(self, rng):
        x = rng.standard_normal((2, 2000)).astype(np.float32)
        kw = dict(n_mels=32, sample_rate=8000, hop_length=40,
                  optimized=True, window_length=512, normalize_window=True)
        want = np.asarray(jops.log_mel_spectrogram(jnp.asarray(x), 60.0, **kw))
        got = tops.log_mel_spectrogram(x, 60.0, device="cpu", **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_lambda_grad_matches_jax(self, rng):
        x = rng.standard_normal((2, 4000)).astype(np.float32)
        kw = dict(n_mels=64, sample_rate=8000, hop_length=80,
                  optimized=True, window_length=1024)
        g_j = float(jax.grad(lambda l: jnp.sum(jops.log_mel_spectrogram(
            jnp.asarray(x), l, **kw)))(jnp.float32(128.0)))
        lam = torch.tensor(128.0, requires_grad=True)
        tops.log_mel_spectrogram(x, lam, device="cpu", **kw).sum().backward()
        np.testing.assert_allclose(float(lam.grad), g_j, rtol=1e-4)

    @pytest.mark.parametrize("n_fft,hop,t", [(256, 16, 1500), (1024, 80, 999),
                                             (512, 40, 80)])
    def test_framing_matches_jax(self, rng, n_fft, hop, t):
        x = rng.standard_normal((3, t)).astype(np.float32)
        want = np.asarray(jstft.frame_signal(jnp.asarray(x), n_fft, hop))
        got = tops.frame_signal(torch.from_numpy(x), n_fft, hop).numpy()
        np.testing.assert_array_equal(got, want)
        assert tops.num_frames(t, hop) == jstft.num_frames(t, hop)

    def test_spectrogram_buckets_match_jax(self):
        import importlib
        jspec = importlib.import_module("dmel_tpu.ops.spectrogram")
        for lam in np.geomspace(0.7, 900.0, 40):
            assert (tops.optimized_window_length(lam)
                    == jspec.optimized_window_length(lam))
            for n in (4000, 40000):
                assert (tops.bucketed_window_length(lam, n)
                        == jspec.bucketed_window_length(lam, n))


class TestGuards:
    """The dispatch guards are verbatim copies: they must agree exactly."""

    LAMBDAS = np.geomspace(4.0, 900.0, 73)
    NFFTS = (128, 256, 512, 1024, 2048, 4096, 8192)

    def test_constants(self):
        for name in ("SPECGEMM_J_TAPS", "PALLAS_AUTO_MIN_NFFT",
                     "SPECBAND_HIPREC_NFFTS", "FRAMED_AUTO_NFFTS",
                     "FRAMED_HIPREC_NFFTS", "SPECBAND_J_LADDER",
                     "LOWBIN_FIX_MAX_LAMBDA_FRAC",
                     "_SPECBAND_SIDELOBE_MAX_LAMBDA_FRAC"):
            assert getattr(tstft, name) == getattr(jstft, name), name
        assert tspecband.SPECBAND_MAX_NFFT == specband_dmel.SPECBAND_MAX_NFFT
        assert tops.LOG_EPS == specband_dmel.LOG_EPS

    @pytest.mark.parametrize("n_fft", NFFTS)
    def test_lambda_guards(self, n_fft):
        for lam in self.LAMBDAS:
            for hop in (16, 80):
                assert (tstft.specband_ok(lam, n_fft, n_fft, hop)
                        == jstft.specband_ok(lam, n_fft, n_fft, hop))
                assert (tstft.specband_compile_hint(lam, n_fft, hop)
                        == jstft.specband_compile_hint(lam, n_fft, hop))
                assert (tstft.pallas_compile_hint(lam, n_fft, hop)
                        == jstft.pallas_compile_hint(lam, n_fft, hop))
            assert (tstft.specband_j_taps(lam, n_fft)
                    == jstft.specband_j_taps(lam, n_fft))
            assert (tstft.lowbin_fix_needed(lam, n_fft)
                    == jstft.lowbin_fix_needed(lam, n_fft))

    def test_geometry_guard(self):
        for n_fft in (128, 256, 384, 512, 1000, 1024, 1536, 2048, 4096,
                      8192):
            for hop in (1, 10, 16, 40, 80, 100, 160, 1024):
                for n_mels, j in ((32, 12), (64, 24), (128, 63), (129, 24)):
                    assert (tspecband.supported(n_fft, hop, n_mels, j)
                            == specband_dmel.supported(n_fft, hop, n_mels,
                                                       j))
                assert (tframed.supported(n_fft, hop, 64)
                        == framed_dmel.supported(n_fft, hop, 64))
        assert tfused.MAX_N_FFT == fused_dmel.MAX_N_FFT


class _Routed(Exception):
    pass


def _jax_route(monkeypatch, x, lam, kw, hint):
    """The kernel dmel_tpu's auto dispatch calls, or 'exact'."""
    def spy(name):
        def call(*args, **kwargs):
            raise _Routed(name, kwargs.get("j_taps"))
        return call
    monkeypatch.setattr(specband_dmel, "specband_mel_power", spy("specband"))
    monkeypatch.setattr(framed_dmel, "framed_mel_power", spy("framed"))
    monkeypatch.setattr(fused_dmel, "dmel_power", spy("fused"))
    try:
        jops.mel_spectrogram(jnp.asarray(x), lam, impl="pallas",
                             lambd_hint=hint, **kw)
    except _Routed as r:
        return r.args
    return "exact", None


class TestAutoDispatch:
    """The esc50 grid's initial lambdas (window buckets 128, 512, 1024,
    4096), a hintless 2048 call and a faithful-mode call: the port
    takes the route dmel_tpu takes, and its kernel routes (their plain
    versions on the CPU) match the exact route within 1e-4 log-mel."""

    CASES = [
        # (lambd, optimized, hinted, expected route)
        (13.3, True, True, "exact"),
        (46.7, True, True, "framed"),
        (128.0, True, True, "specband"),
        (400.0, True, True, "specband"),
        (300.0, True, False, "fused"),
        (20.0, False, True, "exact"),
    ]

    @pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[3]}")
    def test_route_matches_jax(self, rng, monkeypatch, case):
        lam, opt, hinted, expected = case
        t = 4000 if opt else 300
        x = rng.standard_normal((1, t)).astype(np.float32)
        wl = tops.optimized_window_length(lam) if opt else None
        hint = (tops.pallas_compile_hint(lam, wl, 80)
                if hinted and opt else (lam if hinted else None))
        kw = dict(n_mels=64, sample_rate=8000, hop_length=80,
                  optimized=opt, window_length=wl)
        want = _jax_route(monkeypatch, x, lam, kw, hint)
        got = tops.auto_route(signal_length=t, hop_length=80, n_mels=64,
                              optimized=opt, window_length=wl,
                              lambd_hint=hint)
        assert got == want
        assert got[0] == expected
        if expected in ("framed", "fused") or (expected == "specband"
                                               and wl <= 1024):
            got_mel = tops.mel_spectrogram(x, lam, impl="auto",
                                           lambd_hint=hint, device="cpu",
                                           **kw)
            exact = tops.mel_spectrogram(x, lam, impl="exact", device="cpu",
                                         **kw)
            lg, le = torch.log(got_mel + 1e-10), torch.log(exact + 1e-10)
            assert float((lg - le).abs().max()) < 1e-4

    def test_specband_impl_needs_optimized_geometry(self, rng):
        x = rng.standard_normal((1, 2000)).astype(np.float32)
        with pytest.raises(ValueError):
            tops.mel_spectrogram(x, 20.0, n_mels=16, sample_rate=8000,
                                 hop_length=10, impl="specband",
                                 device="cpu")
        with pytest.raises(ValueError, match="unknown impl"):
            tops.mel_spectrogram(x, 20.0, n_mels=16, sample_rate=8000,
                                 impl="pallas", device="cpu")


def test_entry_points_need_a_card_unless_told(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rng.standard_normal((1, 1000)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.mel_spectrogram(x, 20.0, n_mels=16, sample_rate=8000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.log_mel_spectrogram(x, 20.0, n_mels=16, sample_rate=8000)
    out = tops.mel_spectrogram(x, 20.0, n_mels=16, sample_rate=8000,
                               device="cpu")
    assert out.device.type == "cpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "dmel_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_port_and_chip_smoke_load_no_jax_module():
    code = (
        "import pkgutil, runpy, sys\n"
        "import dmel_tpu_torch\n"
        "for m in pkgutil.walk_packages(dmel_tpu_torch.__path__,"
        " 'dmel_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_imports')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """No CUDA device, or chip_smoke.py alone in a directory: a non-zero
    exit and no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
