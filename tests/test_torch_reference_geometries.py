"""The port at the reference's literal executed geometries, on the CPU:
the cases of ``tests/test_reference_geometries.py``.

The published experiments run ``optimized=True`` with ``window_length =
len(x)``, so n_fft = win = T:

- audio_mnist: T 8000 (n_fft 8000), hop 80, 64 mels, at lambda 46.67
  (B 2) and 400 (B 1);
- esc50: T 40000 (n_fft 40000), hop 80, 64 mels, lambda 400 (B 1);
- the time_frequency task's faithful mode (``optimized=False``: win T,
  n_fft 2 T) at T 128, hop 1, lambda 6.38.

Each goes through the port's ``mel_spectrogram(..., impl="auto",
log_output=True, device="cpu")`` (``spectrogram`` for the faithful
case) and is held against dmel_tpu's ``ops.mel_spectrogram`` +
``accurate_log(m + 1e-10)`` on the same seeded input, and against the
torch oracle of ``tests/reference_impl.py``: log-mel max-abs 1e-4,
dlambda relative 1e-3.  The auto dispatch takes the exact route
(torch.stft) at all three, so the oracle runs the port's own FFT; the
comparison with dmel_tpu is the independent one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmel_tpu import ops as jops
from dmel_tpu_torch import ops
from tests.reference_impl import torch_logmel_oracle

SR, HOP, N_MELS = 8000, 80, 64
#: log-mel max-abs gate
GATE = 1e-4
#: dlambda relative gate
GRAD_GATE = 1e-3
#: (T, lambda, B), n_fft = win = T
CASES = [(8000, 46.67, 2), (8000, 400.0, 1), (40000, 400.0, 1)]


def _signal(t, b):
    return np.random.default_rng(0).standard_normal((b, t)).astype(
        np.float32)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _port(x_np, lam, t):
    """The port's log-mel and d(sum)/dlambda."""
    lam_t = torch.tensor(lam, requires_grad=True)
    feat = ops.mel_spectrogram(
        torch.from_numpy(x_np), lam_t, n_mels=N_MELS, sample_rate=SR,
        hop_length=HOP, optimized=True, window_length=t, impl="auto",
        lambd_hint=lam, log_output=True, device="cpu")
    feat.sum().backward()
    return feat.detach().numpy(), float(lam_t.grad)


def _jax(x_np, lam, t):
    """dmel_tpu's log-mel and d(sum)/dlambda, as
    ``tests/test_reference_geometries.py`` computes them."""
    x = jnp.asarray(x_np)

    def feat(lam_):
        m = jops.mel_spectrogram(x, lam_, n_mels=N_MELS, sample_rate=SR,
                                 hop_length=HOP, optimized=True,
                                 window_length=t)
        return jops.accurate_log(m + 1e-10)

    lam_j = jnp.float32(lam)
    return (np.asarray(feat(lam_j)),
            float(jax.grad(lambda v: feat(v).sum())(lam_j)))


@pytest.mark.parametrize("t,lam,b", CASES)
def test_literal_geometry_route_is_exact(t, lam, b):
    for hint in (None, lam):
        assert ops.auto_route(signal_length=t, hop_length=HOP,
                              n_mels=N_MELS, optimized=True,
                              window_length=t, lambd_hint=hint) == (
                                  "exact", None)


@pytest.mark.parametrize("t,lam,b", CASES)
def test_literal_geometry_matches_jax_and_oracle(t, lam, b):
    x_np = _signal(t, b)
    got, got_grad = _port(x_np, lam, t)
    want, want_grad = _jax(x_np, lam, t)
    ref, ref_grad = torch_logmel_oracle(x_np, lam, t, HOP, N_MELS, SR)
    assert got.shape == want.shape == ref.shape == (b, N_MELS,
                                                    t // HOP + 1)
    assert np.isfinite(got).all()
    assert float(np.max(np.abs(got - want))) <= GATE
    assert float(np.max(np.abs(got - ref))) <= GATE
    assert _rel(got_grad, want_grad) <= GRAD_GATE, (got_grad, want_grad)
    assert _rel(got_grad, ref_grad) <= GRAD_GATE, (got_grad, ref_grad)


def _oracle_spectrogram(x_np, lam, t):
    """Faithful-mode power spectrogram of each mean-subtracted row and
    d(sum)/dlambda, by torch.stft (win T, n_fft 2 T, hop 1)."""
    lam_t = torch.tensor(lam, requires_grad=True)
    m = torch.arange(t).float()
    w = torch.exp(-0.5 * ((m - t / 2) / (torch.abs(lam_t) + 1e-15)) ** 2)
    outs = []
    for row in x_np:
        xi = torch.from_numpy(row)
        s = torch.stft(xi - xi.mean(), n_fft=2 * t, hop_length=1,
                       win_length=t, window=w, return_complex=True,
                       pad_mode="constant")
        outs.append(torch.abs(s) ** 2)
    s = torch.stack(outs)
    s.sum().backward()
    return s.detach().numpy(), float(lam_t.grad)


def test_faithful_synthetic_geometry():
    t, lam = 128, 6.38
    x_np = np.random.default_rng(0).standard_normal((3, t)).astype(
        np.float32)
    assert ops.auto_route(signal_length=t, hop_length=1, n_mels=N_MELS,
                          optimized=False, window_length=None,
                          lambd_hint=None)[0] == "exact"
    lam_t = torch.tensor(lam, requires_grad=True)
    x = torch.from_numpy(x_np)
    got_t = ops.spectrogram(x - x.mean(-1, keepdim=True), lam_t,
                            optimized=False, hop_length=1)
    got_t.sum().backward()
    got, got_grad = got_t.detach().numpy(), float(lam_t.grad)

    xj = jnp.asarray(x_np)
    xj = xj - xj.mean(-1, keepdims=True)

    def spec(lam_):
        return jops.spectrogram(xj, lam_, optimized=False, hop_length=1)

    want = np.asarray(spec(jnp.float32(lam)))
    want_grad = float(jax.grad(lambda v: spec(v).sum())(jnp.float32(lam)))
    ref, ref_grad = _oracle_spectrogram(x_np, lam, t)
    assert got.shape == want.shape == ref.shape == (3, t + 1, t + 1)
    scale = max(1.0, float(np.max(np.abs(ref))))
    assert float(np.max(np.abs(got - want))) <= GATE * scale
    assert float(np.max(np.abs(got - ref))) <= GATE * scale
    assert _rel(got_grad, want_grad) <= GRAD_GATE, (got_grad, want_grad)
    assert _rel(got_grad, ref_grad) <= GRAD_GATE, (got_grad, ref_grad)
