#!/usr/bin/env python3
"""Drive dmel_tpu_torch's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N]

Phases, each announced by a flushed line when it starts and ends:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  The script sets no precision flag: ``fit`` and ``predict``
   set their own (``dmel_tpu_torch.precision_scope``), and the phases
   that call a model directly run inside that scope too.
2. build: nvcc builds every kernel of the paths from ``csrc/``, one
   process per source, all started together; each library's seconds
   and ptxas register, spill and shared-memory lines.
3. K1 against its plain version: the specband forward kernel against
   ``specband_mel_power_plain`` on the same CUDA tensors at the bench
   workload (B=128 x 5 s at 8 kHz, n_fft 1024, hop 80, 64 mels,
   lambda 128), at the model path's batch of 32, and at the 4096 bucket
   (lambda 400); log-mel max-abs error gated at 1e-4.  Times with CUDA
   events: the kernel, the plain version and, as a yardstick, one
   torch.stft + mel matmul of the same function.  Every such time is the
   median of 5 blocks of 10 calls after 3 warm-up calls; each kernel and
   yardstick time also carries its blocks' range and the host's time to
   issue a call, which shows when the card waited on the host.
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
5. K3/K4 against their plain versions: the framed route at lambda 46.7
   (the 512 bucket, B=32), lambda 150 (1024, B=32 and B=128) and the
   deep-fade lambda 30 (512, the framed_hiprec route).  K3 (log-mel
   max-abs 1e-4 against ``fwd_plain`` and torch.stft + mel), K4 against
   ``framed_dwindow_plain`` on K3's residual (1e-3 of the largest entry,
   two runs bit-identical), dlambda through the kernels against autograd
   of the plain chain and of the exact route (1e-2).  Times as for
   K1/K2; the exact route's backward is K4's yardstick.
6. K5 against its plain version: the fused route at lambda 300 (2048)
   and 600 (4096), B=32, and faithful mode at T=1500 (n_fft 3000, the
   window centred in it).  The same forward gates; dlambda through K5
   and the torch adjoint against autograd of the plain chain and of the
   exact route (1e-2).
7. model paths: MelPANNsNet (DMEL + CNN6, esc50_synth geometry) built
   from its config with a seeded init, eval-mode inference through
   ``predict`` over 3 batches of 32, at lambda 128 (specband) and 46.7
   (framed); the route's forward kernel must launch once per batch, the
   scores must be finite probabilities, and the features and scores
   must match the route's plain function followed by the same log and
   CNN6 head within 1e-4.
8. train paths: ``fit`` on ``get_dataset_by_config`` for esc50_synth at
   full CNN6 width, Adam (lr_model 1e-4, lr_tf 1.0), batch 32, 5 s
   clips, 2 epochs of 480 clips (11 train steps and 2 valid batches an
   epoch), at lambda 128 (specband), 46.7 (framed) and 600 (fused).
   Counted by epoch, from the route each epoch's refresh picked: on a
   specband epoch K2 launches once per train step and K1 once per train
   step and valid batch; on a framed epoch K4 once per train step and K3
   once per train step and valid batch; on a fused epoch K5 once per
   train step and valid batch.  Losses finite; lambda moved.  At lambda
   128, on one batch, the gradients of lambda and of ``fc_esc50.weight``
   through the kernels must match the same model, batch and dropout
   masks through the plain specband function (dlambda relative 1e-3,
   weights 1e-4 of the largest).  ms per train step, first and steady,
   on each route; at lambda 128 also with cuDNN's deterministic
   algorithms off and on, in turns, and which gradients differ between
   identical steps in each setting; at lambda 46.7 a second ``fit`` with
   the same seed must be bit-identical in lambda and every weight.
9. a ``{"kernels": [...]}`` line, then the final
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

from dmel_tpu_torch import precision_scope
from dmel_tpu_torch.data import get_dataset_by_config, make_esc50_synth_dataset
from dmel_tpu_torch.eval import predict
from dmel_tpu_torch.models import dispatch_hint_for, get_model_by_config
from dmel_tpu_torch.ops import _cuda, framed, fused, specband, stft
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
DW_GATE = 1e-3               # K4 vs plain, max |error| / max |dw|
TRAIN_GRAD_GATE = 1e-3       # one train step: dlambda, kernels vs plain
WEIGHT_GRAD_GATE = 1e-4      # one train step: fc weights, of max |grad|
KERNELS = ("specband_fwd", "specband_bwd", "framed_fwd", "framed_bwd")
#: every kernel wrapper's launch counter, by kernel
COUNTERS = {"K1": specband.specband_mel_power, "K2": specband.specband_drho,
            "K3": framed.framed_mel_power, "K4": framed.framed_dwindow,
            "K5": fused.dmel_power}
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
#: optimizer and trainable lambda, at lambda 128.  Cut to 480 clips and 2
#: epochs (22 train steps).  At hop 80 and 64 mels the auto dispatch
#: routes (85.3, 128] of the 1024 bucket to specband and (128, 170.7] to
#: framed, (42.7, 85.3] (512) to framed, (170.7, 256] (2048) to specband
#: and (256, 341.3] to fused, (341.3, 512] (4096) to specband and
#: (512, 682.7] to fused; the rest is exact.  Lambda 128 sits on the top
#: edge of specband: with seed 0 it falls (to about 118.2), so both
#: epochs stay on specband, and the paths below start at 46.7 (framed)
#: and 600 (fused).  Every epoch's route is read from its starting
#: lambda and counted by epoch.
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


@contextlib.contextmanager
def step_scope(deterministic: bool):
    """The package's :func:`precision_scope`; with ``deterministic=False``
    cuDNN's deterministic algorithms are turned off inside it, to measure
    what they cost."""
    with precision_scope():
        if deterministic:
            yield
        else:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                yield


def timing(fn, iters: int = 10, warmup: int = 3, reps: int = 5) -> dict:
    """Per-call times of ``fn`` after ``warmup`` calls, over ``reps``
    blocks of ``iters`` calls: ``ms`` the median block's device time
    (CUDA events), ``range`` the fastest and slowest block's, and
    ``enqueue_ms`` the median block's host time to issue the calls.
    Where ``enqueue_ms`` is close to ``ms`` the card waited on the host,
    and the time is the host's, not the card's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms.append((time.perf_counter() - t0) * 1e3 / iters)
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end) / iters)
    return dict(ms=float(np.median(dev_ms)),
                range=[min(dev_ms), max(dev_ms)],
                enqueue_ms=float(np.median(host_ms)))


def time_ms(fn) -> float:
    """The median block's device time per call of ``fn`` (:func:`timing`)."""
    return timing(fn)["ms"]


def timed(key: str, fn) -> dict:
    """``fn``'s :func:`timing` as ``{key: ms, key_range: [lo, hi],
    key_enqueue: ms}``."""
    t = timing(fn)
    return {key: t["ms"], key + "_range": t["range"],
            key + "_enqueue": t["enqueue_ms"]}


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
        kernel_t = timed("ms", kernel)
        ms = kernel_t["ms"]
        plain_ms = time_ms(plain)
        library_t = timed("library_ms", library)
    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by = k1_bound(batch, n_fft, j, fb_nnz)
    least, direct = k1_flops(batch, n_fft, j, fb_nnz)
    res = dict(batch=batch, n_fft=n_fft, lambd=lambd, j_taps=j,
               mel_rel_err=rel, logmel_max_abs_err=err,
               logmel_err_vs_exact_stft=err_exact, **kernel_t,
               plain_ms=plain_ms, **library_t, bound_ms=bound_ms,
               bound_by=bound_by,
               least_gflop=least / 1e9, direct_dft_gflop=direct / 1e9,
               direct_dft_tflops_achieved=direct / ms / 1e9)
    say("K1 " + json.dumps(res))
    check(err <= GATE, f"K1 vs plain {err:.3e} > {GATE} at {res}")
    check(err_exact <= GATE, f"K1 vs exact STFT {err_exact:.3e} > {GATE}")
    return res


def _plain_features(model, xb, wl, j):
    """The log-mel features of ``xb`` through the plain version of the
    route the model's layer takes (specband or framed)."""
    layer = model.spectrogram_layer
    xm = xb - xb.mean(dim=-1, keepdim=True)
    w = gaussian_window(layer.lambd.abs(), wl)
    if j is not None:
        mel = specband.specband_mel_power_plain(
            xm, w, n_fft=wl, hop_length=HOP, n_mels=N_MELS, sample_rate=SR,
            j_taps=j)
    else:
        mel = framed.framed_mel_power_plain(
            xm, w, n_fft=wl, hop_length=HOP, n_mels=N_MELS, sample_rate=SR)
    return torch.log(mel + LOG_EPS)[:, None]


def model_path(seed: int, dev: torch.device, lam: float) -> dict:
    """Inference through ``predict`` at ``lam``: the specband route at
    128, the framed route at 46.7."""
    config = dict(CONFIG, init_lambd=lam)
    wl = bucketed_window_length(lam, config["n_points"])
    hint = dispatch_hint_for(config, wl, lam)
    route, j = auto_route(signal_length=T, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=wl,
                          lambd_hint=hint)
    say(f"model: lambda {lam}, window {wl}, hint {hint}, route {route}, "
        f"J {j}")
    check(route in ("specband", "framed"), f"model front end takes {route}")
    key = {"specband": "K1", "framed": "K3"}[route]
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed)
    data = make_esc50_synth_dataset(seed=seed, n_samples=N_BATCHES * BATCH)

    t0 = time.perf_counter()
    (preds, scores), launches = counted(
        lambda: predict(model, data.xs, batch_size=BATCH, device=dev))
    first_s = time.perf_counter() - t0
    check(launches[key] == N_BATCHES,
          f"{key} launched {launches[key]} times for {N_BATCHES} batches")
    check(scores.shape == (N_BATCHES * BATCH, 10), f"scores {scores.shape}")
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(bool(((scores >= 0) & (scores <= 1)).all()), "scores outside [0,1]")
    check(preds.shape == (N_BATCHES * BATCH,), f"preds {preds.shape}")

    t0 = time.perf_counter()
    predict(model, data.xs, batch_size=BATCH, device=dev)
    steady_s = time.perf_counter() - t0

    xb = torch.from_numpy(data.xs[:BATCH]).to(dev)
    with torch.no_grad(), precision_scope():
        out, s = model(xb)
        s_plain = _plain_features(model, xb, wl, j)
        out_plain = model.spectrogram_model(s_plain.transpose(2, 3))
        err_s = float((s - s_plain).abs().max())
        err_out = float((out - out_plain).abs().max())
    res = dict(lambd=lam, route=route, launches=launches, batches=N_BATCHES,
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
        kernel_t = timed("ms", k2)
        ms = kernel_t["ms"]
        plain_ms = time_ms(k2_plain)

    lam = leaf()
    exact_out = mel_spectrogram(x, lam, impl="exact", **kw).sum()
    library_bwd = timed("library_bwd_ms", lambda: torch.autograd.grad(
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
               drho_max_tap_rel_err=drho_tap_rel, **kernel_t,
               plain_ms=plain_ms, **library_bwd, chain_ms=chain_ms,
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


def counted(fn):
    """``(result, launches)``: ``fn()`` run with every kernel's launch
    counter set to 0 just before it, and the counts read just after."""
    for c in COUNTERS.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in COUNTERS.items()}


def framed_bound(batch: int, t: int, n_fft: int, fb_nnz: int):
    """(ms, 'bytes' | 'operations', gflop): the least time one H100 needs
    for the framed (K3) or fused (K5) forward with its residual.

    Operations a frame row needs: the window product (n_fft), a real FFT
    of the windowed frame (2.5 N log2 N), the power (3 a bin) and the mel
    projection over the filterbank's nonzeros (2 each).  Bytes: the
    signal, the window and the dense filterbank read once, the mel and
    the Re/Im residual (2 n_bins floats a row) written once."""
    rows = batch * stft.num_frames(t, HOP)
    n_bins = n_fft // 2 + 1
    flops = rows * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins
                    + 2 * fb_nnz)
    nbytes = 4 * (batch * t + n_fft + n_bins * N_MELS + rows * N_MELS
                  + rows * 2 * n_bins)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def k4_bound(batch: int, t: int, n_fft: int, fb_nnz: int):
    """(ms, 'bytes' | 'operations', gflop): the least time one H100 needs
    for the window's gradient from the Re/Im residual.

    Operations a frame row needs: dP over the filterbank's nonzeros (2
    each), dRe and dIm (2 a bin each), an inverse real FFT to dfw
    (2.5 N log2 N) and the frame product summed into dw (2 a sample).
    Bytes: the signal, the residual (2 n_bins floats a row), the
    cotangent and the dense filterbank read once, dw written once."""
    rows = batch * stft.num_frames(t, HOP)
    n_bins = n_fft // 2 + 1
    flops = rows * (2 * fb_nnz + 4 * n_bins
                    + 2.5 * n_fft * math.log2(n_fft) + 2 * n_fft)
    nbytes = 4 * (batch * t + rows * 2 * n_bins + rows * N_MELS
                  + n_bins * N_MELS + n_fft)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def frontend_case(seed: int, route: str, batch: int, lambd: float,
                  dev: torch.device, n_fft: int | None = None,
                  t: int = T) -> dict:
    """The framed (K3, K4) or fused (K5, torch adjoint) route at one
    geometry: ``n_fft`` is the optimized-mode bucket, or None for
    faithful mode (``n_fft = 2 t``, the window ``t`` samples centred in
    it).  The forward kernel against its plain version and the exact
    STFT; on the framed route K4 against its plain version on the
    kernel's residual; dlambda through the route against autograd of the
    plain chain and of the exact route; errors and times."""
    optimized = n_fft is not None
    win, nfft = (n_fft, n_fft) if optimized else (t, 2 * t)
    hint = (stft.pallas_compile_hint(lambd, nfft, HOP) if optimized
            else lambd)
    got_route, _ = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                              optimized=optimized, window_length=n_fft,
                              lambd_hint=hint)
    check(got_route == route, f"auto dispatch took {got_route}, not {route}")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, t)).astype(
        np.float32)).to(dev)
    xm = x - x.mean(dim=-1, keepdim=True)
    g = framed.Geom(nfft, HOP, N_MELS, SR, 0.0, float(SR // 2))
    w = fused.pad_window(gaussian_window(torch.tensor(lambd, device=dev),
                                         win), nfft)
    kernel = framed.framed_fwd if route == "framed" else fused.fused_fwd
    fb = melscale_fbanks(nfft // 2 + 1, 0.0, SR // 2, N_MELS, SR, device=dev)
    nfr = stft.num_frames(t, HOP)

    def library():
        p = stft.stft_power(xm, w[(nfft - win) // 2:][:win], nfft, HOP)
        return torch.log((p.transpose(-1, -2) @ fb).transpose(-1, -2)
                         + LOG_EPS)

    with torch.no_grad():
        mel_k, reim = kernel(xm, w, g)
        mel_p, reim_p = framed.fwd_plain(xm, w, g)
        log_x = library()
        torch.cuda.synchronize()
        check(mel_k.shape == (batch, N_MELS, nfr), f"shape {mel_k.shape}")
        check(bool(torch.isfinite(mel_k).all()), "non-finite mel")
        log_k = torch.log(mel_k + LOG_EPS)
        err = float((log_k - torch.log(mel_p + LOG_EPS)).abs().max())
        err_exact = float((log_k - log_x).abs().max())
        reim_err = float((reim - reim_p).abs().max() / reim_p.abs().max())
        kernel_t = timed("ms", lambda: kernel(xm, w, g))
        plain_ms = time_ms(lambda: framed.fwd_plain(xm, w, g))
        library_t = timed("library_ms", library)
        if route == "framed":
            dmel = torch.from_numpy(rng.standard_normal(
                (batch, N_MELS, nfr)).astype(np.float32)).to(dev)

            def k4():
                return framed.framed_dwindow(xm, reim, dmel, g)

            def k4_plain():
                return framed.framed_dwindow_plain(xm, reim, dmel, g)

            d_k, d_k2, d_p = k4(), k4(), k4_plain()
            torch.cuda.synchronize()
            dw_abs = float((d_k - d_p).abs().max())
            dw_rel = dw_abs / float(d_p.abs().max())
            dw_repeat = bool(torch.equal(d_k, d_k2))
            k4_t = timed("k4_ms", k4)
            k4_plain_ms = time_ms(k4_plain)

    kw = dict(n_mels=N_MELS, sample_rate=SR, hop_length=HOP,
              optimized=optimized, window_length=n_fft, log_output=True,
              device=dev)

    def leaf():
        return torch.tensor(lambd, device=dev, requires_grad=True)

    def kernel_chain():
        lam = leaf()
        mel_spectrogram(x, lam, impl=route, **kw).sum().backward()
        return lam.grad

    def plain_chain():
        lam = leaf()
        wp = fused.pad_window(gaussian_window(lam.abs(), win), nfft)
        torch.log(framed.mel_plain(xm, wp, g) + LOG_EPS).sum().backward()
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
    lam = leaf()
    exact_out = mel_spectrogram(x, lam, impl="exact", **kw).sum()
    library_bwd = timed("library_bwd_ms", lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    del exact_out
    chain_ms = time_ms(kernel_chain)
    plain_chain_ms = time_ms(plain_chain)
    exact_chain_ms = time_ms(exact_chain)

    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by, least_gflop = framed_bound(batch, t, nfft, fb_nnz)
    res = dict(route=route, batch=batch, t=t, win_length=win, n_fft=nfft,
               lambd=lambd, logmel_max_abs_err=err,
               logmel_err_vs_exact_stft=err_exact, reim_err_of_max=reim_err,
               dlambd=float(g_k), dlambd_rel_err=dlam_rel,
               dlambd_rel_err_vs_exact=dlam_rel_exact,
               dlambd_repeat_bit_identical=bool(torch.equal(g_k, g_k2)),
               **kernel_t, plain_ms=plain_ms, **library_t,
               bound_ms=bound_ms, bound_by=bound_by, least_gflop=least_gflop,
               direct_dft_gflop=4 * batch * nfr * nfft * framed.kp_of(nfft)
               / 1e9, **library_bwd, chain_ms=chain_ms,
               plain_chain_ms=plain_chain_ms, exact_chain_ms=exact_chain_ms)
    if route == "framed":
        k4_bound_ms, k4_bound_by, k4_gflop = k4_bound(batch, t, nfft, fb_nnz)
        res.update(dw_max_abs_err=dw_abs, dw_err_of_max=dw_rel,
                   dw_repeat_bit_identical=dw_repeat, **k4_t,
                   k4_plain_ms=k4_plain_ms, k4_bound_ms=k4_bound_ms,
                   k4_bound_by=k4_bound_by, k4_least_gflop=k4_gflop,
                   k4_direct_gflop=4 * batch * nfr * nfft
                   * framed.kp_of(nfft) / 1e9)
    say({"framed": "K3/K4 ", "fused": "K5 "}[route] + json.dumps(res))
    check(err <= GATE, f"{route} forward vs plain {err:.3e} > {GATE}")
    check(err_exact <= GATE, f"{route} vs exact STFT {err_exact:.3e}")
    check(dlam_rel <= GRAD_GATE, f"dlambda vs plain {dlam_rel:.3e}")
    check(dlam_rel_exact <= GRAD_GATE,
          f"dlambda vs exact route {dlam_rel_exact:.3e}")
    check(res["dlambd_repeat_bit_identical"], "dlambda differs on repeat")
    if route == "framed":
        check(dw_rel <= DW_GATE, f"K4 vs plain {dw_rel:.3e} of max")
        check(dw_repeat, "K4 differs on repeat")
    return res


def _batch(ds, dev):
    xs = torch.from_numpy(np.ascontiguousarray(ds.xs[:BATCH])).to(dev)
    ys = torch.from_numpy(np.asarray(ds.ys[:BATCH])).to(dev)
    return xs, ys, torch.ones(BATCH, dtype=torch.bool, device=dev)


def train_step_ms(seed: int, dev: torch.device, config: dict, trainset, wl,
                  hint, deterministic: bool = True,
                  steady_steps: int = 10) -> dict:
    """ms per train step of a fresh model at ``config`` on one batch,
    first and steady, on the host clock around synchronised steps, inside
    ``step_scope(deterministic)``; and, with CUDA events, the CNN6
    head's forward + backward alone on that batch's features (the part
    of the step that is not the front end)."""
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed)
    opt = build_optimizer(config, model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs, ys, mask = _batch(trainset, dev)

    def step():
        train_step(model, opt, xs, ys, mask, one_hot=True, n_classes=10,
                   generator=gen)

    with step_scope(deterministic):
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

        cnn6_ms = time_ms(cnn6_fwd_bwd)
    return dict(deterministic=deterministic, first_ms_per_step=first,
                steady_ms_per_step=steady, cnn6_fwd_bwd_ms=cnn6_ms)


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
    with precision_scope():
        loss_k, _, _ = loss_and_metrics(model, xs, ys, mask, one_hot=True,
                                        n_classes=10, generator=gen)
        grads_k = torch.autograd.grad(loss_k, params)

        model.load_state_dict(saved)
        gen.set_state(gen_state)
        s = _plain_features(model, xs, wl, j)
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


def determinism_probe(seed: int, dev: torch.device, trainset, wl,
                      hint) -> dict:
    """The parameters whose gradients differ between three identical
    train-mode gradient computations (same weights, batch and dropout
    masks), with cuDNN's deterministic algorithms off and on."""
    model = get_model_by_config(TRAIN_CONFIG, window_length=wl,
                                lambd_hint=hint, device=dev,
                                seed=seed).train()
    xs, ys, mask = _batch(trainset, dev)
    names = [k for k, _ in model.named_parameters()]

    def grads():
        gen = torch.Generator(device=dev).manual_seed(seed)
        loss, _, _ = loss_and_metrics(model, xs, ys, mask, one_hot=True,
                                      n_classes=10, generator=gen)
        return torch.autograd.grad(loss, list(model.parameters()))

    res = {}
    for det in (False, True):
        with step_scope(det):
            runs = [grads() for _ in range(3)]
        res[f"differing_grads_deterministic_{det}"] = sorted(
            {n for r in runs[1:] for n, a, b in zip(names, r, runs[0])
             if not torch.equal(a, b)})
    say("determinism " + json.dumps(res))
    check(not res["differing_grads_deterministic_True"],
          "gradients differ between identical steps in the package's scope")
    return res


def _route_of(config, lam):
    wl = bucketed_window_length(lam, T)
    hint = dispatch_hint_for(config, wl, lam)
    route, j = auto_route(signal_length=T, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=wl,
                          lambd_hint=hint)
    return route, wl, hint, j


#: the kernels each route launches on one train step, and on one valid
#: batch
_ROUTE_KERNELS = {"specband": (("K1", "K2"), ("K1",)),
                  "framed": (("K3", "K4"), ("K3",)),
                  "fused": (("K5",), ("K5",)), "exact": ((), ())}


def train_path(seed: int, dev: torch.device, lam0: float,
               repeat: bool = False) -> dict:
    """``fit`` from ``lam0``: launches counted by epoch against the route
    each epoch's refresh picked; ms per train step on the starting
    route; at lambda 128 also the one-batch gradient check and the
    step's cost with cuDNN's deterministic algorithms off and on; with
    ``repeat``, a second ``fit`` with the same seed must give the same
    lambda after every epoch and the same weights, bit for bit."""
    config = dict(TRAIN_CONFIG, init_lambd=lam0)
    trainset, validset, _ = get_dataset_by_config(config)
    route, wl, hint, j = _route_of(config, lam0)
    steps = -(-len(trainset) // BATCH)
    valid_batches = -(-len(validset) // BATCH)
    say(f"train: lambda {lam0}, route {route}, {len(trainset)} train / "
        f"{len(validset)} valid clips, {steps} steps and {valid_batches} "
        f"valid batches an epoch, window {wl}, hint {hint}, J {j}")
    extra = {}
    if route == "specband":
        # the deterministic setting's step cost, in turns off, on, on, off
        turns = [train_step_ms(seed, dev, config, trainset, wl, hint, det)
                 for det in (False, True, True, False)]
        for r in turns:
            say("train step " + json.dumps(r))
        times = turns[1]
        extra = dict(step_turns=turns,
                     **train_grad_check(seed, dev, trainset, wl, hint, j),
                     **determinism_probe(seed, dev, trainset, wl, hint))
    else:
        times = train_step_ms(seed, dev, config, trainset, wl, hint)
        say("train step " + json.dumps(times))

    seen = []
    t0 = time.perf_counter()
    (state, history), total = counted(lambda: fit(
        config, trainset, validset, seed=seed, device=dev,
        report_fn=lambda r: seen.append(
            {k: c.launches for k, c in COUNTERS.items()})))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if repeat:
        state2, history2 = fit(config, trainset, validset, seed=seed,
                               device=dev)
        sd, sd2 = state["model"].state_dict(), state2["model"].state_dict()
        extra["fit_repeat_bit_identical"] = (
            [r["lambd_est"] for r in history["records"]]
            == [r["lambd_est"] for r in history2["records"]]
            and all(torch.equal(v, sd2[k]) for k, v in sd.items()))

    records = history["records"]
    epochs = []
    prev = dict.fromkeys(COUNTERS, 0)
    lam_start = lam0
    for r, cum in zip(records, seen):
        ep_route = _route_of(config, lam_start)[0]
        launched = {k: cum[k] - prev[k] for k in COUNTERS}
        want = dict.fromkeys(COUNTERS, 0)
        for k in _ROUTE_KERNELS[ep_route][0]:
            want[k] += steps
        for k in _ROUTE_KERNELS[ep_route][1]:
            want[k] += valid_batches
        epochs.append(dict(epoch=r["epoch"], lambd_start=lam_start,
                           route=ep_route, launches=launched,
                           expected=want))
        say("record " + json.dumps(dict(r, route=ep_route,
                                        launches=launched)))
        prev, lam_start = cum, r["lambd_est"]
    res = dict(lambd=lam0, route=route, epochs=epochs,
               steps_per_epoch=steps, valid_batches_per_epoch=valid_batches,
               launches=total, fit_s=fit_s, **times,
               init_lambd=history["init_lambd"],
               est_lambd=history["est_lambd"],
               window_length=state["window_length"], **extra)
    say("train " + json.dumps(res))
    check(len(records) == config["max_epochs"], f"{len(records)} epochs ran")
    check(epochs[0]["route"] == route, "epoch 0 left the starting route")
    for e in epochs:
        check(e["launches"] == e["expected"],
              f"epoch {e['epoch']} on {e['route']}: launches "
              f"{e['launches']}, expected {e['expected']}")
    check(all(math.isfinite(r[k]) for r in records
              for k in ("loss", "valid_loss", "energy")),
          "non-finite loss")
    check(history["est_lambd"] != history["init_lambd"], "lambda did not move")
    check(extra.get("fit_repeat_bit_identical", True),
          "a second fit with the same seed differs")
    return res


def _kernel_entry(name, source, replaces, launches_by_path, err, err_of,
                  gate, case, prefix="", **fields):
    """One entry of the ``kernels`` line: ``max_abs_err`` is the gated
    error, named by ``max_abs_err_of``; times and bound from ``case``
    (the main path's shape), with its keys under ``prefix``."""
    return dict(
        name=name, route="cuda", source=f"dmel_tpu_torch/csrc/{source}",
        replaces=replaces, launches=sum(launches_by_path.values()),
        launches_by_path=launches_by_path, max_abs_err=err,
        max_abs_err_of=err_of, gate=gate, ms=case[prefix + "ms"],
        ms_range=case[prefix + "ms_range"],
        ms_enqueue=case[prefix + "ms_enqueue"],
        plain_ms=case[prefix + "plain_ms"],
        bound_ms=case[prefix + "bound_ms"],
        bound_by=case[prefix + "bound_by"], **fields)


def _library(case: dict, key: str) -> dict:
    """The ``library_ms`` fields of a kernels entry from ``case``'s
    yardstick ``key``: the median, the blocks' range and the host's
    enqueue time (:func:`timing`)."""
    return dict(library_ms=case[key], library_ms_range=case[key + "_range"],
                library_ms_enqueue=case[key + "_enqueue"])


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

    seed = args.seed
    with phase("K1 vs plain"):
        cases = [k1_case(seed, 128, 1024, 128.0, dev),
                 k1_case(seed, BATCH, 1024, 128.0, dev),
                 k1_case(seed, BATCH, 4096, 400.0, dev)]

    with phase("K2 vs plain"):
        cases2 = [k2_case(seed, 128, 1024, 128.0, True, dev),
                  k2_case(seed, 128, 1024, 128.0, False, dev),
                  k2_case(seed, BATCH, 1024, 128.0, False, dev),
                  k2_case(seed, BATCH, 4096, 400.0, True, dev)]

    with phase("K3/K4 vs plain"):
        cases34 = [frontend_case(seed, "framed", BATCH, 46.7, dev, 512),
                   frontend_case(seed, "framed", BATCH, 150.0, dev, 1024),
                   frontend_case(seed, "framed", 128, 150.0, dev, 1024),
                   frontend_case(seed, "framed", BATCH, 30.0, dev, 512)]

    with phase("K5 vs plain"):
        cases5 = [frontend_case(seed, "fused", BATCH, 300.0, dev, 2048),
                  frontend_case(seed, "fused", BATCH, 600.0, dev, 4096),
                  frontend_case(seed, "fused", BATCH, 300.0, dev, None,
                                t=1500)]

    with phase("model path"):
        model = model_path(seed, dev, 128.0)
    with phase("model path, framed"):
        model_fr = model_path(seed, dev, 46.7)

    with phase("train path"):
        train = train_path(seed, dev, 128.0)
    with phase("train path, framed"):
        train_fr = train_path(seed, dev, 46.7, repeat=True)
    with phase("train path, fused"):
        train_fu = train_path(seed, dev, 600.0)

    def by_path(key):
        return {"inference": model["launches"][key],
                "inference_framed": model_fr["launches"][key],
                "train": train["launches"][key],
                "train_framed": train_fr["launches"][key],
                "train_fused": train_fu["launches"][key]}

    main1, main2 = cases[1], cases2[2]   # the model's and the train's shape
    main34, main5 = cases34[0], cases5[1]
    kernels = [
        _kernel_entry(
            "specband_fwd", "specband_fwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:476", by_path("K1"),
            max(c["logmel_max_abs_err"] for c in cases), "log-mel", GATE,
            main1, **_library(main1, "library_ms")),
        _kernel_entry(
            "specband_bwd", "specband_bwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:749", by_path("K2"),
            max(c["drho_err_of_max"] for c in cases2),
            "drho / max |drho|", DRHO_GATE, main2,
            **_library(main2, "library_bwd_ms"),
            drho_err_of_max=max(c["drho_err_of_max"] for c in cases2),
            dlambd_rel_err=max(c["dlambd_rel_err"] for c in cases2)),
        _kernel_entry(
            "framed_fwd", "framed_fwd.cu",
            "dmel_tpu/ops/pallas/framed_dmel.py:138", by_path("K3"),
            max(c["logmel_max_abs_err"] for c in cases34), "log-mel", GATE,
            main34, **_library(main34, "library_ms")),
        _kernel_entry(
            "framed_bwd", "framed_bwd.cu",
            "dmel_tpu/ops/pallas/framed_dmel.py:247", by_path("K4"),
            max(c["dw_err_of_max"] for c in cases34), "dw / max |dw|",
            DW_GATE, main34, prefix="k4_",
            **_library(main34, "library_bwd_ms"),
            dw_err_of_max=max(c["dw_err_of_max"] for c in cases34),
            dlambd_rel_err=max(c["dlambd_rel_err"] for c in cases34)),
        _kernel_entry(
            "fused_fwd", "framed_fwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:68", by_path("K5"),
            max(c["logmel_max_abs_err"] for c in cases5), "log-mel", GATE,
            main5, **_library(main5, "library_ms")),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on a path")
    say(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
