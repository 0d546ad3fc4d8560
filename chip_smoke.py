#!/usr/bin/env python3
"""Drive dmel_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each announced by a flushed line when it starts and ends:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build: nvcc builds every kernel of the path from ``csrc/``, one
   process per source, all started together; each library's seconds
   and ptxas register and shared-memory lines.
3. K1 against its plain version: the specband forward kernel against
   ``specband_mel_power_plain`` on the same CUDA tensors at the bench
   workload (B=128 x 5 s at 8 kHz, n_fft 1024, hop 80, 64 mels,
   lambda 128), at the model path's batch of 32, and at the 4096 bucket
   (lambda 400); log-mel max-abs error gated at 1e-4.  Times with CUDA
   events: the kernel, the plain version and, as a yardstick, one
   torch.stft + mel matmul of the same function.
4. K2 against its plain version: the training hot path that bench.py
   measures, ``mel_spectrogram(..., impl="specband")`` forward and
   ``backward()`` into lambda, through the kernels and through autograd
   of the plain version on the same CUDA tensors, with and without the
   log epilogue, at the bench workload, at the train path's batch of 32
   and at the 4096 bucket; dlambda relative error gated at 1e-2
   (bench.py's gate).  K2's taps' gradient against
   ``specband_drho_plain`` on the same residual (gated at 1e-3 of the
   largest tap), and two K2 runs and two backward passes bit-identical.
   Times: K2, its plain version, the forward+backward of the kernel
   chain, of the plain chain and of the exact route (torch.stft + mel,
   autograd) with its backward alone as K2's yardstick.
5. model path: MelPANNsNet (DMEL + CNN6, esc50_synth geometry) built
   from its config with a seeded init, eval-mode inference through
   ``predict`` over 3 batches of 32; K1's launch count must equal the
   batch count, the scores must be finite probabilities, and the
   features and scores must match the plain specband function followed
   by the same log and CNN6 head within 1e-4.
6. train path: ``fit`` on ``get_dataset_by_config`` for esc50_synth at
   full CNN6 width, Adam (lr_model 1e-4, lr_tf 1.0), batch 32, 5 s
   clips, 2 epochs of 480 clips (11 train steps and 2 valid batches an
   epoch).  K2 must launch once per train step and K1 once per train
   step and valid batch; losses finite; lambda moved and stayed in the
   1024 bucket.  On one batch, the gradients of lambda and of
   ``fc_esc50.weight`` through the kernels must match the same model,
   batch and dropout masks through the plain specband function (dlambda
   relative 1e-3, weights 1e-4 of the largest).  ms per train step,
   first and steady.
7. a ``{"kernels": [...]}`` line, then the final
   ``{"ok": true, "device": {...}}`` line.

Any failed check raises, so the script exits non-zero before the final
line.  A watchdog ends a run that hangs with a traceback.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dmel_tpu_torch.data import get_dataset_by_config, make_esc50_synth_dataset
from dmel_tpu_torch.eval import predict
from dmel_tpu_torch.models import dispatch_hint_for, get_model_by_config
from dmel_tpu_torch.ops import _cuda, specband, stft
from dmel_tpu_torch.ops.dmel import LOG_EPS, auto_route, mel_spectrogram
from dmel_tpu_torch.ops.mel import melscale_fbanks
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.ops.window import gaussian_window
from dmel_tpu_torch.training import (bce_loss, build_optimizer, fit,
                                     loss_and_metrics, train_step)

WATCHDOG_S = 300
GATE = 1e-4                  # log-mel max-abs gate (bench.py's)
GRAD_GATE = 1e-2             # dlambda relative gate (bench.py's)
DRHO_GATE = 1e-3             # K2 vs plain, max |error| / max |drho|
TRAIN_GRAD_GATE = 1e-3       # one train step: dlambda, kernels vs plain
WEIGHT_GRAD_GATE = 1e-4      # one train step: fc weights, of max |grad|
KERNELS = ("specband_fwd", "specband_bwd")
SR, HOP, N_MELS, T = 8000, 80, 64, 40000
N_BATCHES, BATCH = 3, 32
#: one H100 SXM: fp32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

#: the flagship inference configuration: the esc50_synth space at
#: lambda 128 (window bucket 1024), in float32
CONFIG = {
    "model_name": "panns_cnn6", "dataset_name": "esc50_synth",
    "n_mels": N_MELS, "hop_length": HOP, "energy_normalize": True,
    "optimized": True, "impl": "pallas", "model_dtype": "float32",
    "normalize_window": False, "augment": False, "resample_rate": SR,
    "init_lambd": 128.0, "n_points": T,
}
#: the flagship training configuration: the esc50_synth space's
#: optimizer and trainable lambda at lambda 128.  Cut to 480 clips and 2
#: epochs (22 train steps): Adam at lr_tf 1.0 moves lambda by at most
#: about 1 a step, so 22 steps cannot leave the 1024 bucket
#: (85.3 < lambda <= 170.7), where the refresh could pick the 512 bucket
#: and the framed kernel, which is not ported.
TRAIN_CONFIG = dict(CONFIG, optimizer_name="adam", lr_model=1e-4,
                    lr_tf=1.0, batch_size=BATCH, trainable=True,
                    max_epochs=2, patience=100, n_samples=480,
                    sigma_ref=SR * 0.035 / 6, noise_std=0.05, data_seed=0)


def say(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    say(f"[phase] {name}: start")
    t0 = time.perf_counter()
    yield
    say(f"[phase] {name}: ok ({time.perf_counter() - t0:.1f} s)")


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_flops(batch: int, n_fft: int, j_taps: int, fb_nnz: int,
             log: bool = True) -> tuple[int, int]:
    """(least, direct): the operations the specband forward needs, and
    the operations of the direct extended-bin DFT that K1 runs.

    The least count: a real FFT of each unwindowed frame, 2.5 N log2 N
    (the extended bins -J .. n_bins-1+J are periodic repeats of its
    bins); the band convolution with the 2J+1 real taps, symmetric
    about 0, so 6J + 2 flops per bin; the power, 3 per bin; the mel
    projection over the filterbank's nonzeros, 2 each; the log."""
    rows = batch * stft.num_frames(T, HOP)
    n_bins = n_fft // 2 + 1
    k_ext = n_bins + 2 * j_taps
    tail = ((6 * j_taps + 2) * n_bins + 3 * n_bins + 2 * fb_nnz
            + (N_MELS if log else 0))
    least = rows * (2.5 * n_fft * math.log2(n_fft) + tail)
    direct = rows * (4 * n_fft * k_ext + 4 * (2 * j_taps + 1) * n_bins
                     + 3 * n_bins + 2 * n_bins * N_MELS
                     + (N_MELS if log else 0))
    return int(least), int(direct)


def k1_bound(batch: int, n_fft: int, j_taps: int, fb_nnz: int):
    """(ms, 'bytes' | 'operations'): the least time one H100 needs for
    the specband forward, from the operations the function needs
    (:func:`k1_flops`) at the fp32 peak and the bytes it must move (the
    signal, taps and filterbank read once, the log-mel written once) at
    the HBM rate."""
    least, _ = k1_flops(batch, n_fft, j_taps, fb_nnz)
    n_bins = n_fft // 2 + 1
    nbytes = 4 * (batch * T + 2 * j_taps + 1 + n_bins * N_MELS
                  + batch * N_MELS * stft.num_frames(T, HOP))
    t_ops = least / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1_case(seed: int, batch: int, n_fft: int, lambd: float,
            dev: torch.device) -> dict:
    """Kernel against plain version (and the exact STFT) at one
    geometry; returns errors and times."""
    hint = stft.pallas_compile_hint(lambd, n_fft, HOP)
    route, j = auto_route(signal_length=T, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=n_fft,
                          lambd_hint=hint)
    check(route == "specband", f"auto dispatch took {route} at {n_fft}")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, T)).astype(np.float32)).to(dev)
    x = x - x.mean(dim=-1, keepdim=True)
    w = gaussian_window(torch.tensor(lambd, device=dev), n_fft)
    kw = dict(n_fft=n_fft, hop_length=HOP, n_mels=N_MELS, sample_rate=SR,
              j_taps=j)
    fb = melscale_fbanks(n_fft // 2 + 1, 0.0, SR // 2, N_MELS, SR,
                         device=dev)

    def kernel(log=True):
        return specband.specband_mel_power(x, w, log_epilogue=log, **kw)

    def plain(log=True):
        return specband.specband_mel_power_plain(x, w, log_epilogue=log,
                                                 **kw)

    def library():
        p = stft.stft_power(x, w, n_fft, HOP)
        return torch.log((p.transpose(-1, -2) @ fb).transpose(-1, -2)
                         + LOG_EPS)

    with torch.no_grad():
        mel_k, mel_p = kernel(False), plain(False)
        log_k, log_p, log_x = kernel(), plain(), library()
        torch.cuda.synchronize()
        nfr = stft.num_frames(T, HOP)
        check(log_k.shape == (batch, N_MELS, nfr), f"shape {log_k.shape}")
        check(bool(torch.isfinite(log_k).all()), "non-finite log-mel")
        rel = float(((mel_k - mel_p).abs() / mel_p.abs()).max())
        err = float((log_k - log_p).abs().max())
        err_exact = float((log_k - log_x).abs().max())
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library)
    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by = k1_bound(batch, n_fft, j, fb_nnz)
    least, direct = k1_flops(batch, n_fft, j, fb_nnz)
    res = dict(batch=batch, n_fft=n_fft, lambd=lambd, j_taps=j,
               mel_rel_err=rel, logmel_max_abs_err=err,
               logmel_err_vs_exact_stft=err_exact, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               least_gflop=least / 1e9, direct_dft_gflop=direct / 1e9,
               direct_dft_tflops_achieved=direct / ms / 1e9)
    say("K1 " + json.dumps(res))
    check(err <= GATE, f"K1 vs plain {err:.3e} > {GATE} at {res}")
    check(err_exact <= GATE, f"K1 vs exact STFT {err_exact:.3e} > {GATE}")
    return res


def model_path(seed: int, dev: torch.device) -> dict:
    wl = bucketed_window_length(CONFIG["init_lambd"], CONFIG["n_points"])
    hint = dispatch_hint_for(CONFIG, wl, CONFIG["init_lambd"])
    route, j = auto_route(signal_length=T, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=wl,
                          lambd_hint=hint)
    say(f"model: window {wl}, hint {hint}, route {route}, J {j}")
    check(route == "specband", f"model front end takes {route}")
    model = get_model_by_config(CONFIG, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed)
    data = make_esc50_synth_dataset(seed=seed, n_samples=N_BATCHES * BATCH)

    specband.specband_mel_power.launches = 0
    t0 = time.perf_counter()
    preds, scores = predict(model, data.xs, batch_size=BATCH, device=dev)
    first_s = time.perf_counter() - t0
    launches = specband.specband_mel_power.launches
    check(launches == N_BATCHES,
          f"K1 launched {launches} times for {N_BATCHES} batches")
    check(scores.shape == (N_BATCHES * BATCH, 10), f"scores {scores.shape}")
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(bool(((scores >= 0) & (scores <= 1)).all()), "scores outside [0,1]")
    check(preds.shape == (N_BATCHES * BATCH,), f"preds {preds.shape}")

    t0 = time.perf_counter()
    predict(model, data.xs, batch_size=BATCH, device=dev)
    steady_s = time.perf_counter() - t0

    xb = torch.from_numpy(data.xs[:BATCH]).to(dev)
    with torch.no_grad():
        out, s = model(xb)
        xm = xb - xb.mean(dim=-1, keepdim=True)
        w = gaussian_window(model.spectrogram_layer.lambd.abs(), wl)
        mel = specband.specband_mel_power_plain(
            xm, w, n_fft=wl, hop_length=HOP, n_mels=N_MELS, sample_rate=SR,
            j_taps=j)
        s_plain = torch.log(mel + LOG_EPS)[:, None]
        out_plain = model.spectrogram_model(s_plain.transpose(2, 3))
        err_s = float((s - s_plain).abs().max())
        err_out = float((out - out_plain).abs().max())
    res = dict(launches=launches, batches=N_BATCHES,
               first_ms_per_batch=first_s * 1e3 / N_BATCHES,
               steady_ms_per_batch=steady_s * 1e3 / N_BATCHES,
               feature_err_vs_plain=err_s, score_err_vs_plain=err_out)
    say("model " + json.dumps(res))
    check(err_s <= GATE, f"features vs plain {err_s:.3e} > {GATE}")
    check(err_out <= GATE, f"scores vs plain {err_out:.3e} > {GATE}")
    return res




def k2_bound(batch: int, n_fft: int, j_taps: int, fb_nnz: int, log: bool):
    """(ms, 'bytes' | 'operations', gflop): the least time one H100
    needs for the taps' gradient from the spectra residual.

    Operations a frame row needs: dP over the filterbank's nonzeros
    (2 each); S recomputed with the symmetric real taps (6J + 2 a bin,
    both planes); dS = 2 dP S (3 a bin); the tap products, 2 planes x
    2 flops x (2J + 1) taps a bin; with the log epilogue, exp and a
    product a mel.  Bytes: X' (2 k_ext floats a row), the cotangent
    (and the saved log-mel), the taps and the dense filterbank read
    once; the taps' gradient written once."""
    rows = batch * stft.num_frames(T, HOP)
    n_bins = n_fft // 2 + 1
    n_taps = 2 * j_taps + 1
    k_ext = n_bins + 2 * j_taps
    per_row = (2 * fb_nnz + (6 * j_taps + 2) * n_bins + 3 * n_bins
               + 4 * n_taps * n_bins + (2 * N_MELS if log else 0))
    flops = rows * per_row
    nbytes = 4 * (rows * 2 * k_ext + rows * N_MELS * (2 if log else 1)
                  + n_taps + n_bins * N_MELS + n_taps)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def k2_case(seed: int, batch: int, n_fft: int, lambd: float, log: bool,
            dev: torch.device) -> dict:
    """The training hot path (forward + backward into lambda) through
    the kernels against the plain chain and the exact route, and K2
    against its plain version on the same residual; errors and times."""
    hint = stft.pallas_compile_hint(lambd, n_fft, HOP)
    route, j = auto_route(signal_length=T, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=n_fft,
                          lambd_hint=hint)
    check(route == "specband", f"auto dispatch took {route} at {n_fft}")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, T)).astype(
        np.float32)).to(dev)
    kw = dict(n_mels=N_MELS, sample_rate=SR, hop_length=HOP, optimized=True,
              window_length=n_fft, log_output=log, device=dev)

    def leaf():
        return torch.tensor(lambd, device=dev, requires_grad=True)

    def kernel_chain():
        lam = leaf()
        mel_spectrogram(x, lam, impl="specband", lambd_hint=hint,
                        **kw).sum().backward()
        return lam.grad

    def plain_chain():
        lam = leaf()
        xm = x - x.mean(dim=-1, keepdim=True)
        specband.specband_mel_power_plain(
            xm, gaussian_window(lam.abs(), n_fft), n_fft=n_fft,
            hop_length=HOP, n_mels=N_MELS, sample_rate=SR, j_taps=j,
            log_epilogue=log).sum().backward()
        return lam.grad

    def exact_chain():
        lam = leaf()
        mel_spectrogram(x, lam, impl="exact", **kw).sum().backward()
        return lam.grad

    g_k, g_k2, g_p, g_x = (kernel_chain(), kernel_chain(), plain_chain(),
                           exact_chain())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g_k)), f"non-finite dlambda {g_k}")
    dlam_rel = float((g_k - g_p).abs() / g_p.abs())
    dlam_rel_exact = float((g_k - g_x).abs() / g_x.abs())

    # K2 alone, on K1's residual of the same signal
    with torch.no_grad():
        xm = x - x.mean(dim=-1, keepdim=True)
        rho = specband.window_taps_sym(
            gaussian_window(torch.tensor(lambd, device=dev), n_fft), n_fft, j)
        geom = specband._Geom(n_fft, HOP, N_MELS, SR, 0.0, float(SR // 2), j,
                              log)
        out, xext = specband._fwd(xm, rho, geom)
        _, fb, _ = specband._consts(geom, dev)
        dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).to(dev)
        logmel = out if log else None

        def k2():
            return specband.specband_drho(xext, rho, fb, dmel, logmel)

        def k2_plain():
            return specband.specband_drho_plain(xext, rho, fb, dmel, logmel)

        d_k, d_k2, d_p = k2(), k2(), k2_plain()
        torch.cuda.synchronize()
        diff = (d_k - d_p).abs()
        drho_abs = float(diff.max())
        drho_rel = drho_abs / float(d_p.abs().max())
        drho_tap_rel = float((diff / d_p.abs()).max())
        ms = time_ms(k2)
        plain_ms = time_ms(k2_plain)

    lam = leaf()
    exact_out = mel_spectrogram(x, lam, impl="exact", **kw).sum()
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    del exact_out
    chain_ms = time_ms(kernel_chain)
    plain_chain_ms = time_ms(plain_chain)
    exact_chain_ms = time_ms(exact_chain)

    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by, least_gflop = k2_bound(batch, n_fft, j, fb_nnz, log)
    res = dict(batch=batch, n_fft=n_fft, lambd=lambd, j_taps=j, log=log,
               dlambd=float(g_k), dlambd_rel_err=dlam_rel,
               dlambd_rel_err_vs_exact=dlam_rel_exact,
               dlambd_repeat_bit_identical=bool(torch.equal(g_k, g_k2)),
               drho_repeat_bit_identical=bool(torch.equal(d_k, d_k2)),
               drho_max_abs_err=drho_abs, drho_err_of_max=drho_rel,
               drho_max_tap_rel_err=drho_tap_rel, ms=ms, plain_ms=plain_ms,
               library_bwd_ms=library_bwd_ms, chain_ms=chain_ms,
               plain_chain_ms=plain_chain_ms, exact_chain_ms=exact_chain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               least_gflop=least_gflop,
               least_tflops_achieved=least_gflop / ms)
    say("K2 " + json.dumps(res))
    check(dlam_rel <= GRAD_GATE, f"dlambda vs plain {dlam_rel:.3e}")
    check(dlam_rel_exact <= GRAD_GATE,
          f"dlambda vs exact route {dlam_rel_exact:.3e}")
    check(drho_rel <= DRHO_GATE, f"K2 vs plain {drho_rel:.3e} of max")
    check(res["dlambd_repeat_bit_identical"], "dlambda differs on repeat")
    check(res["drho_repeat_bit_identical"], "K2 differs on repeat")
    return res


def _batch(ds, dev):
    xs = torch.from_numpy(np.ascontiguousarray(ds.xs[:BATCH])).to(dev)
    ys = torch.from_numpy(np.asarray(ds.ys[:BATCH])).to(dev)
    return xs, ys, torch.ones(BATCH, dtype=torch.bool, device=dev)


def train_step_ms(seed: int, dev: torch.device, trainset, wl, hint,
                  steady_steps: int = 10) -> dict:
    """ms per train step of a fresh model at the train configuration on
    one batch, first and steady, on the host clock around synchronised
    steps; and, with CUDA events, the CNN6 head's forward + backward
    alone on that batch's features (the part of the step that is
    neither K1 nor K2)."""
    model = get_model_by_config(TRAIN_CONFIG, window_length=wl,
                                lambd_hint=hint, device=dev, seed=seed)
    opt = build_optimizer(TRAIN_CONFIG, model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs, ys, mask = _batch(trainset, dev)

    def step():
        train_step(model, opt, xs, ys, mask, one_hot=True, n_classes=10,
                   generator=gen)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(steady_steps):
        step()
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) * 1e3 / steady_steps

    with torch.no_grad():
        s = model.features(xs)
    labels = F.one_hot(ys.long(), 10).to(s.dtype)

    def cnn6_fwd_bwd():
        out = model.spectrogram_model(s.transpose(2, 3), gen)
        bce_loss(out, labels, mask).backward()

    return dict(first_ms_per_step=first, steady_ms_per_step=steady,
                cnn6_fwd_bwd_ms=time_ms(cnn6_fwd_bwd))


def train_grad_check(seed: int, dev: torch.device, trainset, wl, hint,
                     j: int) -> dict:
    """Gradients of lambda and fc_esc50.weight on one batch: the model
    through the kernels against the same model, batch and dropout masks
    through the plain specband function, the same log and CNN6 head."""
    model = get_model_by_config(TRAIN_CONFIG, window_length=wl,
                                lambd_hint=hint, device=dev,
                                seed=seed).train()
    xs, ys, mask = _batch(trainset, dev)
    params = [model.spectrogram_layer.lambd,
              model.spectrogram_model.fc_esc50.weight]
    gen = torch.Generator(device=dev).manual_seed(seed)
    gen_state = gen.get_state()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    loss_k, _, _ = loss_and_metrics(model, xs, ys, mask, one_hot=True,
                                    n_classes=10, generator=gen)
    grads_k = torch.autograd.grad(loss_k, params)

    model.load_state_dict(saved)
    gen.set_state(gen_state)
    xm = xs - xs.mean(dim=-1, keepdim=True)
    mel = specband.specband_mel_power_plain(
        xm, gaussian_window(model.spectrogram_layer.lambd.abs(), wl),
        n_fft=wl, hop_length=HOP, n_mels=N_MELS, sample_rate=SR, j_taps=j)
    s = torch.log(mel + LOG_EPS)[:, None]
    out = model.spectrogram_model(s.transpose(2, 3), gen)
    loss_p = bce_loss(out, F.one_hot(ys.long(), 10).to(out.dtype), mask)
    grads_p = torch.autograd.grad(loss_p, params)

    dlam_rel = float((grads_k[0] - grads_p[0]).abs() / grads_p[0].abs())
    w_err = float((grads_k[1] - grads_p[1]).abs().max()
                  / grads_p[1].abs().max())
    res = dict(loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
               dlambd_kernel=float(grads_k[0]), dlambd_plain=float(grads_p[0]),
               dlambd_rel_err=dlam_rel, fc_weight_grad_err_of_max=w_err)
    say("train grad " + json.dumps(res))
    check(dlam_rel <= TRAIN_GRAD_GATE, f"train dlambda {dlam_rel:.3e}")
    check(w_err <= WEIGHT_GRAD_GATE, f"fc_esc50 weight grad {w_err:.3e}")
    return res


def train_path(seed: int, dev: torch.device) -> dict:
    trainset, validset, _ = get_dataset_by_config(TRAIN_CONFIG)
    lam0 = TRAIN_CONFIG["init_lambd"]
    wl = bucketed_window_length(lam0, T)
    hint = dispatch_hint_for(TRAIN_CONFIG, wl, lam0)
    route, j = auto_route(signal_length=T, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=wl,
                          lambd_hint=hint)
    check(route == "specband", f"train front end takes {route}")
    steps = -(-len(trainset) // BATCH)
    valid_batches = -(-len(validset) // BATCH)
    say(f"train: {len(trainset)} train / {len(validset)} valid clips, "
        f"{steps} steps and {valid_batches} valid batches an epoch, "
        f"window {wl}, hint {hint}, J {j}")
    times = train_step_ms(seed, dev, trainset, wl, hint)
    grads = train_grad_check(seed, dev, trainset, wl, hint, j)

    specband.specband_mel_power.launches = 0
    specband.specband_drho.launches = 0
    t0 = time.perf_counter()
    state, history = fit(TRAIN_CONFIG, trainset, validset, seed=seed,
                         device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1 = specband.specband_mel_power.launches
    k2 = specband.specband_drho.launches

    records = history["records"]
    for r in records:
        say("record " + json.dumps(r))
    epochs = len(records)
    res = dict(epochs=epochs, steps_per_epoch=steps,
               valid_batches_per_epoch=valid_batches, k1_launches=k1,
               k2_launches=k2, fit_s=fit_s, **times,
               init_lambd=history["init_lambd"],
               est_lambd=history["est_lambd"],
               window_length=state["window_length"], **grads)
    say("train " + json.dumps(res))
    check(epochs == TRAIN_CONFIG["max_epochs"], f"{epochs} epochs ran")
    check(k2 == epochs * steps,
          f"K2 launched {k2} times for {epochs * steps} train steps")
    check(k1 == epochs * (steps + valid_batches),
          f"K1 launched {k1} times for {epochs * (steps + valid_batches)} "
          "forward passes")
    check(all(math.isfinite(r[k]) for r in records
              for k in ("loss", "valid_loss", "energy")),
          "non-finite loss")
    check(history["est_lambd"] != history["init_lambd"], "lambda did not move")
    check(state["window_length"] == wl
          and all(bucketed_window_length(r["lambd_est"], T) == wl
                  for r in records), "lambda left the 1024 bucket")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    with phase("device"):
        if not torch.cuda.is_available():
            print("no CUDA device: this script needs one GPU",
                  file=sys.stderr, flush=True)
            sys.exit(1)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        say(smi)
        kind = torch.cuda.get_device_name(0)
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {kind}, count {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)

    with phase("build"):
        with ThreadPoolExecutor(len(KERNELS)) as ex:
            libs = list(ex.map(_cuda.load, KERNELS))
        for name, lib in zip(KERNELS, libs):
            say(f"built {name} in {lib.seconds:.1f} s -> {lib.path.name}")
            for line in lib.log.splitlines():
                if "registers" in line or "Compiling entry" in line \
                        or "spill" in line:
                    say("  " + line.strip())

    with phase("K1 vs plain"):
        cases = [k1_case(args.seed, 128, 1024, 128.0, dev),
                 k1_case(args.seed, BATCH, 1024, 128.0, dev),
                 k1_case(args.seed, BATCH, 4096, 400.0, dev)]

    with phase("K2 vs plain"):
        cases2 = [k2_case(args.seed, 128, 1024, 128.0, True, dev),
                  k2_case(args.seed, 128, 1024, 128.0, False, dev),
                  k2_case(args.seed, BATCH, 1024, 128.0, False, dev),
                  k2_case(args.seed, BATCH, 4096, 400.0, True, dev)]

    with phase("model path"):
        model = model_path(args.seed, dev)

    with phase("train path"):
        train = train_path(args.seed, dev)

    main_case = cases[1]            # the model path's shape
    main_case2 = cases2[2]          # the train path's shape (no log)
    kernels = [{
        "name": "specband_fwd",
        "route": "cuda",
        "source": "dmel_tpu_torch/csrc/specband_fwd.cu",
        "replaces": "dmel_tpu/ops/pallas/specband_dmel.py:476",
        "launches": model["launches"] + train["k1_launches"],
        "launches_by_path": {"inference": model["launches"],
                             "train": train["k1_launches"]},
        "max_abs_err": max(c["logmel_max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }, {
        "name": "specband_bwd",
        "route": "cuda",
        "source": "dmel_tpu_torch/csrc/specband_bwd.cu",
        "replaces": "dmel_tpu/ops/pallas/specband_dmel.py:749",
        "launches": train["k2_launches"],
        "launches_by_path": {"inference": 0, "train": train["k2_launches"]},
        "max_abs_err": max(c["drho_max_abs_err"] for c in cases2),
        "ms": main_case2["ms"],
        "plain_ms": main_case2["plain_ms"],
        "bound_ms": main_case2["bound_ms"],
        "bound_by": main_case2["bound_by"],
        "library_ms": main_case2["library_bwd_ms"],
    }]
    say(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
