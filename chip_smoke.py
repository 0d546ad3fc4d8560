#!/usr/bin/env python3
"""Drive dmel_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each announced by a flushed line when it starts and ends:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build: nvcc builds every kernel of the path from ``csrc/``.
3. K1 against its plain version: the specband forward kernel against
   ``specband_mel_power_plain`` on the same CUDA tensors at the bench
   workload (B=128 x 5 s at 8 kHz, n_fft 1024, hop 80, 64 mels,
   lambda 128), at the model path's batch of 32, and at the 4096 bucket
   (lambda 400); log-mel max-abs error gated at 1e-4.  Times with CUDA
   events: the kernel, the plain version and, as a yardstick, one
   torch.stft + mel matmul of the same function.
4. model path: MelPANNsNet (DMEL + CNN6, esc50_synth geometry) built
   from its config with a seeded init, eval-mode inference through
   ``predict`` over 3 batches of 32; K1's launch count must equal the
   batch count, the scores must be finite probabilities, and the
   features and scores must match the plain specband function followed
   by the same log and CNN6 head within 1e-4.
5. a ``{"kernels": [...]}`` line, then the final
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

import numpy as np
import torch

from dmel_tpu_torch.data import make_esc50_synth_dataset
from dmel_tpu_torch.eval import predict
from dmel_tpu_torch.models import dispatch_hint_for, get_model_by_config
from dmel_tpu_torch.ops import _cuda, specband, stft
from dmel_tpu_torch.ops.dmel import LOG_EPS, auto_route
from dmel_tpu_torch.ops.mel import melscale_fbanks
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.ops.window import gaussian_window

WATCHDOG_S = 300
GATE = 1e-4                  # log-mel max-abs gate (bench.py's)
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
        lib = _cuda.load("specband_fwd")
        say(f"built specband_fwd in {lib.seconds:.1f} s -> {lib.path.name}")
        for line in lib.log.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                say("  " + line.strip())

    with phase("K1 vs plain"):
        cases = [k1_case(args.seed, 128, 1024, 128.0, dev),
                 k1_case(args.seed, BATCH, 1024, 128.0, dev),
                 k1_case(args.seed, BATCH, 4096, 400.0, dev)]

    with phase("model path"):
        model = model_path(args.seed, dev)

    main_case = cases[1]            # the model path's shape
    kernels = [{
        "name": "specband_fwd",
        "route": "cuda",
        "source": "dmel_tpu_torch/csrc/specband_fwd.cu",
        "replaces": "dmel_tpu/ops/pallas/specband_dmel.py:476",
        "launches": model["launches"],
        "max_abs_err": max(c["logmel_max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    say(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
