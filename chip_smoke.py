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
   and ptxas register, spill and shared-memory lines, and for K5's and
   K6's Bluestein instantiations one line each with their registers,
   spills and dynamic shared bytes a block.
3. K1 against its plain version: the specband forward kernel against
   ``specband_mel_power_plain`` on the same CUDA tensors at the bench
   workload (B=128 x 5 s at 8 kHz, n_fft 1024, hop 80, 64 mels,
   lambda 128), at the model path's batch of 32, and at the 2048 and
   4096 buckets (lambda 250, 400); log-mel max-abs error gated at 1e-4;
   its spectra buffer ``xext`` within 1e-5 of the plain version's
   largest entry and bit-identical on repeat.  Every n_fft here takes
   the FFT spectra stage (``stage``); the direct-DFT stage is launched
   through the same C entry at the same shapes (``direct_ms``, gated
   like the kernel), and ``torch.profiler`` splits both into their
   launches (``split``, ``split_direct``: device ms a launch by kernel,
   with the launches the profiler recorded of 5 calls); the band stage's
   share (``band_ms``) stands beside its own bound (``band_bound_ms``,
   :func:`k1_band_bound`), here, for K1 multi and for K1 packed.
   Times with CUDA events: the kernel, the plain version and, as a
   yardstick, one torch.stft + mel matmul of the same function, whose
   card time from ``torch.profiler`` (``library_device_ms``) is K1's
   ``library_ms`` where the host is slower to issue it.  Every
   such time is the median of 5 blocks of 10 calls after 3 warm-up
   calls (a plain version's, 3 blocks of 2 calls after one:
   ``plain_time_ms``); each kernel and yardstick time also carries its
   blocks' range and the host's time to issue a call, which shows when
   the card waited on the host.
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
   autograd) with its backward alone as K2's yardstick, by events and by
   the profiler (``library_bwd_device_ms``, the card's time, K2's
   ``library_ms``); K2's launches split by the profiler (``split``) and
   the tap count of the kernel instance that ran (``tap_instance``).
5. K3/K4 against their plain versions: the framed route at lambda 46.7
   (the 512 bucket, B=32), lambda 150 (1024, B=32 and B=128) and the
   deep-fade lambda 30 (512, the framed_hiprec route).  K3 (log-mel
   max-abs 1e-4 against ``fwd_plain`` and torch.stft + mel), K4 against
   ``framed_dwindow_plain`` on K3's residual (1e-3 of the largest entry,
   two runs bit-identical), dlambda through the kernels against autograd
   of the plain chain and of the exact route (1e-2).  Times as for
   K1/K2; the exact route's backward is K4's yardstick.  K3 takes the
   FFT stage (K5's kernel); ``direct_ms`` and ``split_direct`` are K3's
   own entry with no plan.  K4 takes the inverse-FFT stage (K6's kernel;
   ``k4_stage``); the direct adjoint through K4's entry is gated like it
   and timed (``k4_direct_ms``, ``k4_split``, ``k4_split_direct``).  Each
   yardstick's card time also comes from ``torch.profiler``
   (``library_device_ms``, ``library_bwd_device_ms``), where the host
   is slower to issue it than the card to run it.
6. K5 against its plain version: the fused route at lambda 300 (2048)
   and 600 (4096), B=32, and faithful mode at T=1500 (n_fft 3000, the
   window centred in it; radices 4, 3, 5, 5, 5) and on Bluestein's stage
   at T 700, 1021 and 2039 (B 32, lambda T / 5; m_pad 2048, 2048, 4096)
   and B 512 x 1021 and 2039, where the card does real work
   (``BLUESTEIN_SHAPES``).
   The same forward gates, the Re|Im residual within 1e-5 of the plain
   version's largest entry and bit-identical on repeat; dlambda through
   K5 and the torch adjoint against autograd of the plain chain and of
   the exact route (1e-2).  ``stage``, ``direct_ms`` and the splits as
   for K1; on Bluestein's stage (checked to be the stage there) also a
   pack of two trials, K5 and K6 bit for bit two single launches.
7. K1/K2 multi-sigma: K1 and K2 at k_sig = 4 (the default contiguous
   band map, the hint of the mean lambda, as ``fit`` builds it) at the
   bench workload (B=128, 1024, lambda 100/110/120/128, J 24), at B=32
   there, and at 4096 (B=32, lambda 345/360/380/400, J 12).  K1 against
   the plain multi-sigma function and the exact multi-sigma route
   (log-mel 1e-4), K2 against its plain version (1e-3 of the largest
   entry, bit-identical on repeat), dlambda (4,) through the kernels
   against autograd of the plain chain and of the exact route (1e-2 in
   each group).  Yardsticks (by events and by the profiler, the card's
   time): the exact route's forward and its backward into lambda.
   ``stage``, ``direct_ms``, the splits and the ``xext`` gates as for K1.
8. K6 against its plain version (the torch adjoint) on K5's residual at
   lambda 300 (2048), 600 (4096) and faithful mode (T=1500, n_fft 3000,
   and phase 6's Bluestein shapes): dw within 1e-3 of its largest entry,
   bit-identical on repeat; the exact route's backward as the yardstick
   (and its profiler card time).  K6 takes the inverse-FFT stage at
   2048, 4096 and 3000 and Bluestein's at 1400, 2042 and 4078
   (``stage``, checked), with the pack of two as in phase 6; the direct
   adjoint through the same entry is gated and timed at every shape
   (``direct_ms``, ``split``, ``split_direct``).
9. model paths: MelPANNsNet (DMEL + CNN6, esc50_synth geometry) built
   from its config with a seeded init, eval-mode inference through
   ``predict`` over 3 batches of 32, at lambda 128 (specband) and 46.7
   (framed), and with 4 sigma groups at 128 (multi-sigma specband) and
   46.7 (the exact multi-sigma route); the route's forward kernel must
   launch once per batch (none on the exact route), the scores must be
   finite probabilities, and the features and scores must match the
   route's plain function followed by the same log and CNN6 head within
   1e-4.  Then the faithful path: ``mel_spectrogram(optimized=False,
   impl="auto", log_output=True)`` forward and ``backward()`` into
   lambda with ``fused.USE_FUSED_BWD`` at B 512 x 2039: K5 and K6 once
   each on Bluestein's stage (``K5bl``, ``K6bl``), log-mel within 1e-4
   and dlambda within 1e-2 of the exact route, ms beside it.
10. train paths: ``fit`` on ``get_dataset_by_config`` for esc50_synth at
   full CNN6 width, Adam (lr_model 1e-4, lr_tf 1.0), batch 32, 5 s
   clips, 2 epochs of 480 clips (11 train steps and 2 valid batches an
   epoch), at lambda 128 (specband), 46.7 (framed), 600 (fused), 128
   with 4 sigma groups (multi-sigma specband) and 600 with
   ``fused.USE_FUSED_BWD`` set (fused, K6).  Counted by epoch, from the
   route each epoch's refresh picked: on a specband epoch K2 launches
   once per train step and K1 once per train step and valid batch (K1m
   and K2m likewise on a multi-sigma epoch); on a framed epoch K4 once
   per train step and K3 once per train step and valid batch; on a fused
   epoch K5 once per train step and valid batch, and K6 once per train
   step with the flag; K1, K1m, K3, K4, K5 and K6 also on their FFT
   counters (``fft_launches``) wherever the epoch's window takes the FFT
   stage.
   Losses finite; every group's lambda moved.  At
   lambda 128, on one batch, the gradients of lambda and of
   ``fc_esc50.weight`` through the kernels must match the same model,
   batch and dropout masks through the plain specband function (dlambda
   relative 1e-3 in norm, weights 1e-4 of the largest), with one sigma
   group and with four; on the fused route the same two gradients with
   the flag on (K6) against off (the torch adjoint).  ms per train step,
   first and steady, on each route; at lambda 128 also with cuDNN's
   deterministic algorithms off and on, in turns, and which gradients
   differ between identical steps in each setting; at lambda 128 and
   46.7 a second ``fit`` with the same seed must be bit-identical in
   lambda and every weight.
11. bf16 train steps: ms per train step (``train_step_ms``) in float32
   and with ``model_dtype="bfloat16"`` (CNN6's conv stack in bf16) on
   the specband (lambda 128), framed (46.7), fused (600) and multi-sigma
   (128, 4 groups) routes; on each, one bf16 step's gradients of lambda
   and fc_esc50.weight against the float32 step's on the same batch and
   dropout masks (relative in norm: dlambda 1e-1, fc_esc50 5e-2); on
   specband, CNN6's forward + backward split by part (mel batch norm,
   each conv block, the head by difference) from ``torch.profiler``, in
   both dtypes.
12. CLI sweep: ``dmel_tpu_torch.experiments.cli.main`` runs the whole
   esc50_synth space (six trials: lambda 13.3, 46.7, 400, trainable or
   not; bf16, ``impl="pallas"``, 2000 clips) for 2 epochs into a
   temporary directory.  Every trial's launches are counted by epoch
   against the route its epoch started on (13.3 exact, 46.7 framed, 400
   specband at 4096, and whatever lambda grows into); six rows in
   results.csv; each trial's best model and sidecar exist, the sidecar
   holding the last improving epoch and the geometry it started at; no
   live state left.  Then ``eval.predict_test`` over the sweep (test
   accuracies in [0, 1], predictions of shape (6, 400)), and a second
   ``cli.main`` that must skip all six trials.
13. checkpoint prediction: each sweep trial's checkpoint restored at its
   sidecar's geometry and run through ``training.predict`` must give
   the argmax of ``eval.predictions_by_row`` on every test clip.
14. kill and resume: a bf16 specband trial (lambda 128) of 3 epochs,
   once uninterrupted and once killed after epoch 1's report and resumed
   by a second ``fit``: records, weights, statistics and optimizer state
   bit-identical, the resumed run's ``init_lambd`` the lambda it resumed
   at (epoch 0's), no live state left; the seconds of each run, of the
   checkpoint writes and the overhead of the kill and resume.
15. K1-K5 at AudioMNIST's shapes (B 64 x 8000 samples, the
   audio_mnist space): K1/K2 at 4096 (lambda 400, J 12, log on), 2048
   (172.95) and 1024 (100), K3/K4 at 512 (46.7) and 1024 (150), K5 at
   4096 (600, where the sweep's trainable 400 arm grows): every bucket
   the sweep's arms can cross, with the gates and times of phases 3-6
   (run after phase 7).
16. the paper's three spaces through the CLI, as a user runs them, each
   with ``predict_test`` and the tables (``eval.tables.main``), every
   trial's launches counted by epoch against its route, and each arm's
   lambda and test accuracy printed beside the JAX package's sweep under
   ``results/`` (constants here): time_frequency in full (5000 clips of
   128 samples, linear_net, SGD, batch 128, 30 epochs), gated on lambda
   recovery (every trainable arm ends nearer the JAX sweep's mean
   est_lambd of its trainable arms than it started; frozen arms keep
   theirs) and on no kernel launch (DSPEC is the exact route);
   audio_mnist (mel_linear_net, batch 64, 2 epochs) on a full
   30000-wav fixture tree and esc50 (bf16 CNN6, 2 epochs) on a 2000-clip
   fixture tree, both built in a temporary directory (their seconds),
   with each dataset load's seconds (esc50's first resamples and writes
   the cache, the rest read it; scipy's version) and the ms of a train
   step on every route the sweep took; then one audio_mnist trial's
   ``fit`` and ``predict`` with the feed's ``prefetch`` at 0 and at 2
   (the seconds of each, results bit-identical).
17. the fsd space through the CLI on an FSD50K fixture tree in its
   official layout (200 classes, 2000 train / 400 val dev clips by the
   split column, 400 eval clips, 0.5-2 s at 44.1 kHz, built in a
   temporary directory): 6 trials of bf16 CNN6 with SpecAugment and
   multi-label BCE, 2 epochs, every trial's launches counted by epoch
   against its route; the tree's seconds, each load's (the first
   resamples and writes the cache); ``predict_test`` with ``test_mAP``
   in [0, 1]; a train step's ms with and without SpecAugment, in turns,
   on every route the sweep took.
18. the pretrained import: one fsd trial (lambda 400, trainable) with
   ``pretrained=True`` and ``checkpoint_path`` at the PANNs Cnn6
   stand-in of ``tests/fixtures.py``: once ``fit`` has imported it,
   before the first step, the 22 mapped tensors lie on the card equal to
   the checkpoint's bit for bit, and the counts (22 imported, 9
   skipped) are dmel_tpu's; then the trial runs.
19. SpecAugment on the card (float32, lambda 128, specband): two seeded
   augmented train steps bit-identical; dlambda through K1/K2 against
   the plain specband function for one dL/ds (1e-3); dlambda and
   fc_esc50.weight's gradient through the whole chain, kernels against
   plain, from the same generator state (masks and dropout alike;
   dlambda 1e-2, bench.py's gate: CNN6's backward amplifies the routes'
   ~1e-6 feature difference and the masks carry more of it into
   dlambda; weights 1e-4); on a ones batch of 256 x 501 x 64 the masks
   equal ``mask_span`` on the CPU from the same uniforms, each one
   contiguous span of at most 64 frames and 8 mels.
20. Cnn14 with an AttBlock on its frames at full width (B 32 x 501
   frames x 64 mels, 527 classes): eval forward and one Adam train step,
   first and steady ms, in float32 and bf16; the float32 eval scores on
   4 clips within 1e-4 of the CPU's on the same weights, bf16 within
   2e-2 of float32.
21. CNN6's batch norm: after one float32 and one bf16 train step every
   running variance equals 0.9 old + 0.1 the biased float32 variance of
   its input (a plain reduction on the card) within 1e-5 of the
   largest.
22. packs of trials (phases "packed kernels" after K6, "pack sweep
   esc50_synth" after the CLI sweep, "pack fsd" after the fsd sweep,
   "pack specband" before SpecAugment): a pack of one against the
   single launch of K1, K2, K5 and K6, bit for bit; K5 and K6 on a pack
   of 6 trials x 32 clips at 4096 (the esc50_synth grid's lambdas) and
   K1 and K2 on 6 x 32 at 1024 (lambda 110-128, J 24): one launch each,
   trial k bit for bit a single launch on its rows (dw and the taps'
   gradient within 1e-6), against the plain packed versions (log-mel
   1e-4, gradients 1e-3 of the largest), dlambda (6,) through the chain
   against the plain chain (1e-2 each), timed against six single
   launches, the plain versions and six times the single bound; the
   esc50_synth space with ``--pack`` from the CLI (2 epochs: every epoch
   at 4096 with no hint, one packed K5 launch a train step and a valid
   batch, none of K1-K4; the step's ms, first and steady; six rows, no
   sidecar, ``predict_test``; a second run bit-identical; one more
   epoch with ``fused.USE_FUSED_BWD``, one packed K6 launch a step)
   beside the sequential sweep's seconds of phase 12; fsd with
   ``--pack`` for one epoch; ``fit_trials`` of two trainable trials at
   lambda 110 and 120 (bf16 CNN6, lr_tf 1e-3), whose shared hint takes
   packed K1 and K2 every epoch.
23. data parallel (after "batch-norm variance"): ``fit(mesh=...)`` on
   a one-rank NCCL mesh in this process, bit for bit the same ``fit``
   without a mesh (the train path's config at lambda 128, float32, one
   epoch); then two gloo ranks sharing the card, started by
   ``dmel_tpu_torch.parallel.dryrun``'s launcher, on the same config at
   a global batch of 32 (16 rows a rank): after two steps lambda
   within 1e-4 relative of the one process, every batch-norm buffer
   within 1e-4 max-abs and every other parameter too, but for Adam's
   sign flips (at most 4 lr, in at most 1e-4 of the entries;
   ``ADAM_FLIP_SHARE``); after the epoch its loss and lambda within
   3e-3 relative (``DP_EPOCH_GATE``), beside the same ``fit`` with
   cuDNN off against it (the card's float32 floor, held to the same
   gate), and the largest
   parameter difference reported; the ranks bit-identical; each rank's
   K1 and K2 launches by epoch as its route says; the same in bf16 for
   2 epochs (lambda and losses within 1e-1 relative); the esc50_synth
   grid in float32 for one epoch, split over the two ranks (three
   trials each, packed K5), against the pack on one card: every trial's
   loss within 3e-3 relative, the same files written once, each rank's packed
   launches the card's pack's, ``predict_test`` on the rows; two NCCL
   ranks where there are two cards (else a line saying why not).  Step
   ms, first and steady, of each rank and of the one process, beside
   the card's name and power limit: the ranks shared one card, so they
   say nothing of scaling.
24. literal geometries (after "packed kernels"): the published
   experiments' ``window_length = len(x)``, n_fft = win = T, at
   audio_mnist's B 64 x 8000 and esc50's B 32 x 40000, hop 80, 64 mels,
   lambda 46.67 and 400: ``mel_spectrogram(impl="auto",
   log_output=True)`` forward and ``backward()`` into lambda take the
   exact route (cuFFT) with no K1-K6 launch; two rows' log-mel (1e-4
   max-abs) and their dlambda (1e-3 relative) against the CPU oracle of
   ``tests/reference_impl.py``; ms (CUDA events, 3 blocks of 5 calls)
   with the profiler's card time (``device_ms``), and
   ``torch.cuda.max_memory_allocated`` beside the same for the
   bucketed window and route ``fit`` takes at that batch and lambda
   (``bucketed_window_length``, ``dispatch_hint_for``).
25. figures: ``eval.figures.data_example_spectrograms`` on the card
   against the CPU (1e-4 of the largest entry), no kernel launch; no
   figure is drawn (matplotlib is not needed on the card's machine).
26. a ``{"kernels": [...]}`` line (each entry with the ``stage`` it
   ran; ``fused_fwd_bluestein`` and ``fused_bwd_bluestein`` are K5's and
   K6's Bluestein stage, at B 512 x 2039, with the direct stage's time at
   each of its shapes; its times, plain times, bounds and yardsticks at
   every measured shape, ``shapes``; launches also from the sweeps, the pretrained
   trial, the resume run and the packs; the packed entries with their
   single launches' time), then the final ``{"ok": true, "device":
   {...}}`` line.

Any failed check raises, so the script exits non-zero before the final
line.  A watchdog ends a run that hangs with a traceback.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dmel_tpu_torch import precision_scope
from dmel_tpu_torch.data import get_dataset_by_config, make_esc50_synth_dataset
from dmel_tpu_torch.eval import predict
from dmel_tpu_torch.models import (dispatch_hint_for, get_model_by_config,
                                   n_classes_for)
from dmel_tpu_torch.ops import _cuda, fft_plan, framed, fused, specband, stft
from dmel_tpu_torch.ops.dmel import (LOG_EPS, auto_route, default_band_map,
                                     mel_spectrogram,
                                     multi_sigma_mel_spectrogram,
                                     multi_sigma_route)
from dmel_tpu_torch.ops.mel import melscale_fbanks, melscale_fbanks_np
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.ops.window import gaussian_window
from dmel_tpu_torch.training import (bce_loss, build_optimizer, fit,
                                     loss_and_metrics, train_step)

WATCHDOG_S = 1000
GATE = 1e-4                  # log-mel max-abs gate (bench.py's)
GRAD_GATE = 1e-2             # dlambda relative gate (bench.py's)
DRHO_GATE = 1e-3             # K2 vs plain, max |error| / max |drho|
DW_GATE = 1e-3               # K4 vs plain, max |error| / max |dw|
RESIDUAL_GATE = 1e-5         # K1's xext, K3/K5's Re|Im: of the largest entry
TRAIN_GRAD_GATE = 1e-3       # one train step: dlambda, kernels vs plain
WEIGHT_GRAD_GATE = 1e-4      # one train step: fc weights, of max |grad|
KERNELS = ("specband_fwd", "specband_bwd", "framed_fwd", "framed_bwd")
#: every kernel wrapper's launch counter, by kernel: (object, attribute).
#: K1m and K2m are K1 and K2 launched at k_sig > 1 by the multi-sigma
#: function, K6 the fused route's dw kernel (``fused.USE_FUSED_BWD``); a
#: ``p`` marks a launch on a pack of trials (the packed wrappers).
COUNTERS = {"K1": (specband.specband_mel_power, "launches"),
            "K2": (specband.specband_drho, "launches"),
            "K1m": (specband.specband_mel_power_multi, "launches"),
            "K2m": (specband.specband_drho, "multi_launches"),
            "K3": (framed.framed_mel_power, "launches"),
            "K4": (framed.framed_dwindow, "launches"),
            "K5": (fused.dmel_power, "launches"),
            "K6": (fused.fused_dwindow, "launches"),
            "K1fft": (specband.specband_mel_power, "fft_launches"),
            "K1mfft": (specband.specband_mel_power_multi, "fft_launches"),
            "K3fft": (framed.framed_mel_power, "fft_launches"),
            "K4fft": (framed.framed_dwindow, "fft_launches"),
            "K5fft": (fused.dmel_power, "fft_launches"),
            "K6fft": (fused.fused_dwindow, "fft_launches"),
            "K5bl": (fused.dmel_power, "bluestein_launches"),
            "K6bl": (fused.fused_dwindow, "bluestein_launches"),
            "K1p": (specband.fwd_packed, "launches"),
            "K2p": (specband.specband_drho_packed, "launches"),
            "K1mp": (specband.fwd_packed, "multi_launches"),
            "K2mp": (specband.specband_drho_packed, "multi_launches"),
            "K3p": (framed.framed_fwd_packed, "launches"),
            "K4p": (framed.framed_dwindow_packed, "launches"),
            "K5p": (fused.fused_fwd_packed, "launches"),
            "K6p": (fused.fused_dwindow_packed, "launches")}
#: the kernels that count their FFT-stage launches apart, and the counter
FFT_COUNTER = {"K1": "K1fft", "K1m": "K1mfft", "K3": "K3fft", "K4": "K4fft",
               "K5": "K5fft", "K6": "K6fft"}
SR, HOP, N_MELS, T = 8000, 80, 64, 40000
N_BATCHES, BATCH = 3, 32
#: AudioMNIST's clips and batch (the audio_mnist space)
AM_T, AM_BATCH = 8000, 64
#: faithful mode's Bluestein shapes (win T, n_fft 2 T, lambda T / 5): B
#: 32 at T 700, 1021 and 2039 (m_pad 2048, 2048, 4096), and B 512 x 1021
#: and 2039, where the card does real work (13 and 26 frames a row, a 54
#: and a 218 MB residual); the last is the main shape
BLUESTEIN_SHAPES = ((BATCH, 700), (BATCH, 1021), (BATCH, 2039), (512, 1021),
                    (512, 2039))
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
#: epochs (22 train steps).  The bucket is next_power_of_2(int(6 lambda)),
#: so its edges sit at (2^k + 1)/6.  At hop 80 and 64 mels the auto
#: dispatch routes [257/6, 512/6] (42.83-85.33, the 512 bucket) to
#: framed, the sliver (512/6, 513/6) (85.33-85.5, no hint) to exact,
#: [513/6, 128] of the 1024 bucket to specband and (128, 1025/6) to
#: framed, [1025/6, 256] (170.83-256, 2048) to specband and
#: (256, 2049/6) to fused, [2049/6, 512] (341.5-512, 4096) to specband
#: and (512, 4097/6) (to 682.83) to fused; the rest is exact.  Lambda
#: 128 sits on the top edge of specband: with seed 0 it falls (to about
#: 118.2), so both epochs stay on specband, and the paths below start at
#: 46.7 (framed) and 600 (fused).  Every epoch's route is read from its
#: starting lambda and counted by epoch.
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


def plain_time_ms(fn) -> float:
    """A plain version's time a call: the median of 3 blocks of 2 calls
    after one warm-up (:func:`timing`).  The plain versions are the
    yardsticks the kernels are held against, at 2-180 ms a call, where
    53 calls would add seconds to the run and no precision."""
    return timing(fn, iters=2, warmup=1, reps=3)["ms"]


def timed(key: str, fn) -> dict:
    """``fn``'s :func:`timing` as ``{key: ms, key_range: [lo, hi],
    key_enqueue: ms}``."""
    t = timing(fn)
    return {key: t["ms"], key + "_range": t["range"],
            key + "_enqueue": t["enqueue_ms"]}


def _kernel_name(key: str) -> str:
    """A profiler event's kernel name without return type, namespace,
    template arguments or parameters."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].split("::")[-1].strip()


def stage_split(fn, calls: int = 5):
    """``{kernel: [ms, launches]}`` for each kernel ``fn`` launches, from
    ``torch.profiler``'s ``key_averages`` over ``calls`` calls after one
    warm-up: its device ms a launch, over the launches the profiler
    recorded (it can record fewer than were made, so the time is not
    divided by ``calls``); ``"not measured"`` where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us > 0 and ev.count:
            ms, n = out.get(_kernel_name(ev.key), (0.0, 0))
            out[_kernel_name(ev.key)] = [(ms * n + us / 1e3) / (n + ev.count),
                                         n + ev.count]
    return out or "not measured"


def device_ms(fn, calls: int = 10) -> float | str:
    """The card's time for one call of ``fn``: from ``torch.profiler``
    over ``calls`` calls after one warm-up, each kernel's device ms a
    launch (:func:`stage_split`) times its launches a call (the launches
    recorded over ``calls``, rounded up: the profiler can miss the first
    ones).  Unlike :func:`timing`'s events it holds no gap in which the
    card waits on the host; ``"not measured"`` where the profiler saw no
    device time."""
    split = stage_split(fn, calls)
    if isinstance(split, str):
        return split
    return sum(ms * math.ceil(n / calls) for ms, n in split.values())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def fused_stage_fields(n_fft: int) -> dict:
    """K5's and K6's stage at ``n_fft`` (``fft_plan.fused_stage``): its
    name, the radices it runs and, on Bluestein's, ``m_pad``."""
    stage = fft_plan.fused_stage(n_fft)
    if isinstance(stage, fft_plan.Bluestein):
        return dict(stage="bluestein", radices=stage.radices,
                    m_pad=stage.m_pad)
    return dict(stage=fft_plan.fused_stage_name(n_fft), radices=stage)


def bluestein_ptxas(log: str, kernel: tuple, extra: int) -> str:
    """One line for a Bluestein kernel (the entry whose mangled name holds
    every string of ``kernel``: K5's ``fused_bluestein_kernel``, K6's
    ``adjoint_fft_dw_kernel<true>``, ``ILb1E``) from nvcc's ``-Xptxas -v``
    log: its registers and spill bytes, and the dynamic shared bytes a
    block takes at m_pad 2048 and 4096, which ptxas does not print:
    ``frame_fft.cuh:fft_stage_smem`` (max(1, 4096 / m_pad) frames of
    m_pad + m_pad / 16 points) and ``extra`` bytes of the kernel's own."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = all(part in line for part in kernel)
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    smem = {mp: 8 * max(1, 4096 // mp) * (mp + mp // 16) + extra
            for mp in (2048, 4096)}
    return (f"  {' '.join(kernel)} (Bluestein's): " + "; ".join(lines)
            + "; dynamic shared bytes a block "
            + ", ".join(f"{b} at m_pad {mp}" for mp, b in smem.items()))


def pack_of_two(seed: int, xm: torch.Tensor, w: torch.Tensor, lambd: float,
                win: int, g: framed.Geom) -> dict:
    """K5 and K6 on a pack of two trials (``xm``'s rows, then them
    reversed; the window at ``lambd`` and at 1.5 ``lambd``), one launch
    each, against two single launches on each trial's rows: whether the
    forward (mel and Re|Im) and dw are bit for bit the singles'."""
    b = xm.shape[0]
    x2 = torch.cat([xm, xm.flip(0)])
    w2 = torch.stack([w, fused.pad_window(gaussian_window(
        torch.tensor(1.5 * lambd, device=xm.device), win), g.n_fft)])
    out, reim = fused.fused_fwd_packed(x2, w2, g)
    dmel = torch.from_numpy(np.random.default_rng(seed + 2).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(xm.device)
    dw = fused.fused_dwindow_packed(x2, reim, dmel, g, 2)
    fwd_bits = dw_bits = True
    for i in range(2):
        rows = slice(i * b, (i + 1) * b)
        o1, r1 = fused.fused_fwd(x2[rows].contiguous(), w2[i].contiguous(), g)
        fwd_bits &= bool(torch.equal(out[rows], o1)
                         and torch.equal(reim.chunk(2)[i], r1))
        dw_bits &= bool(torch.equal(dw[i], fused.fused_dwindow(
            x2[rows].contiguous(), r1, dmel[rows].contiguous(), g)))
    return dict(pack2_fwd_bit_identical=fwd_bits,
                pack2_dw_bit_identical=dw_bits)


def k1_flops(batch: int, n_fft: int, j_taps: int, fb_nnz: int,
             log: bool = True, t: int = T) -> tuple[int, int]:
    """(least, direct): the operations the specband forward needs, and
    the operations of the direct extended-bin DFT that K1 runs.

    The least count: a real FFT of each unwindowed frame, 2.5 N log2 N
    (the extended bins -J .. n_bins-1+J are periodic repeats of its
    bins); the band convolution with the 2J+1 real taps, symmetric
    about 0, so 6J + 2 flops per bin; the power, 3 per bin; the mel
    projection over the filterbank's nonzeros, 2 each; the log."""
    rows = batch * stft.num_frames(t, HOP)
    n_bins = n_fft // 2 + 1
    k_ext = n_bins + 2 * j_taps
    tail = ((6 * j_taps + 2) * n_bins + 3 * n_bins + 2 * fb_nnz
            + (N_MELS if log else 0))
    least = rows * (2.5 * n_fft * math.log2(n_fft) + tail)
    direct = rows * (4 * n_fft * k_ext + 4 * (2 * j_taps + 1) * n_bins
                     + 3 * n_bins + 2 * n_bins * N_MELS
                     + (N_MELS if log else 0))
    return int(least), int(direct)


def k1_bound(batch: int, n_fft: int, j_taps: int, fb_nnz: int,
             t: int = T):
    """(ms, 'bytes' | 'operations'): the least time one H100 needs for
    the specband forward, from the operations the function needs
    (:func:`k1_flops`) at the fp32 peak and the bytes it must move (the
    signal, taps and filterbank read once; the log-mel and the spectra
    residual ``xext``, 2 k_ext floats a frame, written once) at the HBM
    rate."""
    least, _ = k1_flops(batch, n_fft, j_taps, fb_nnz, t=t)
    n_bins = n_fft // 2 + 1
    rows = batch * stft.num_frames(t, HOP)
    nbytes = 4 * (batch * t + 2 * j_taps + 1 + n_bins * N_MELS
                  + batch * N_MELS * stft.num_frames(t, HOP)
                  + rows * 2 * (n_bins + 2 * j_taps))
    t_ops = least / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


#: K1's band stage in a profiler split (``stage_split``)
BAND_KERNEL = "group_mel_kernel"


def k1_band_bound(rows: int, n_fft: int, j_taps: int, fb_nnz: int,
                  widths: list[int], log: bool, k_sig: int = 1):
    """(ms, 'bytes' | 'operations'): the least time one H100 needs for
    K1's band stage on ``rows`` frame rows: the spectra ``xext`` read
    once (2 k_ext floats a row), the taps and the filterbank's nonzeros
    read and the mel written once, at the HBM rate; for each sigma group
    over its own bins (``widths``, :func:`sigma_bins`) the band
    convolution with symmetric real taps (6J + 2 flops a bin) and the
    power (3), the sparse mel projection (2 a filterbank nonzero) and the
    log, at the fp32 peak."""
    k_ext = n_fft // 2 + 1 + 2 * j_taps
    flops = rows * ((6 * j_taps + 5) * sum(widths) + 2 * fb_nnz
                    + (N_MELS if log else 0))
    nbytes = 4 * (rows * 2 * k_ext + rows * N_MELS + fb_nnz
                  + k_sig * (2 * j_taps + 1))
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def band_stage_ms(split) -> float | str:
    """K1's band-stage device ms a launch from a profiler ``split``."""
    if isinstance(split, str) or BAND_KERNEL not in split:
        return "not measured"
    return split[BAND_KERNEL][0]


def k1_case(seed: int, batch: int, n_fft: int, lambd: float,
            dev: torch.device, t: int = T) -> dict:
    """Kernel against plain version (and the exact STFT) at one
    geometry of ``batch`` clips of ``t`` samples; returns errors and
    times."""
    hint = stft.pallas_compile_hint(lambd, n_fft, HOP)
    route, j = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=n_fft,
                          lambd_hint=hint)
    check(route == "specband", f"auto dispatch took {route} at {n_fft}")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, t)).astype(np.float32)).to(dev)
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

    geom = specband._Geom(n_fft, HOP, N_MELS, SR, 0.0, float(SR // 2), j,
                          True)

    def direct():
        """K1 with the direct-DFT spectra stage, through its C entry."""
        rho = specband.window_taps_sym(w, n_fft, j)
        return specband.launch_fwd(x, rho, geom, None)[0]

    with torch.no_grad():
        mel_k, mel_p = kernel(False), plain(False)
        log_k, log_p, log_x, log_d = kernel(), plain(), library(), direct()
        rho = specband.window_taps_sym(w, n_fft, j)
        (_, xext), (_, xext2) = (specband._fwd(x, rho, geom),
                                 specband._fwd(x, rho, geom))
        _, xext_p = specband._fwd_plain(x, rho, geom)
        torch.cuda.synchronize()
        nfr = stft.num_frames(t, HOP)
        check(log_k.shape == (batch, N_MELS, nfr), f"shape {log_k.shape}")
        check(bool(torch.isfinite(log_k).all()), "non-finite log-mel")
        rel = float(((mel_k - mel_p).abs() / mel_p.abs()).max())
        err = float((log_k - log_p).abs().max())
        err_exact = float((log_k - log_x).abs().max())
        err_direct = float((log_d - log_p).abs().max())
        xext_err = rel_err(xext, xext_p)
        del xext_p
        kernel_t = timed("ms", kernel)
        direct_ms = time_ms(direct)
        plain_ms = plain_time_ms(plain)
        library_t = timed("library_ms", library)
        library_dev = device_ms(library)
        split, split_direct = stage_split(kernel), stage_split(direct)
    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by = k1_bound(batch, n_fft, j, fb_nnz, t=t)
    least, direct_flops = k1_flops(batch, n_fft, j, fb_nnz, t=t)
    band_bound_ms, band_bound_by = k1_band_bound(
        batch * nfr, n_fft, j, fb_nnz, sigma_bins(n_fft, (0,) * N_MELS, 1),
        True)
    res = dict(batch=batch, t=t, n_fft=n_fft, lambd=lambd, j_taps=j,
               stage=fft_plan.stage_name(n_fft),
               radices=fft_plan.plan(n_fft), mel_rel_err=rel,
               logmel_max_abs_err=err, logmel_err_vs_exact_stft=err_exact,
               logmel_err_direct_stage=err_direct, xext_err_of_max=xext_err,
               xext_repeat_bit_identical=bool(torch.equal(xext, xext2)),
               **kernel_t, direct_ms=direct_ms, plain_ms=plain_ms,
               **library_t, library_device_ms=library_dev,
               bound_ms=bound_ms, bound_by=bound_by,
               split=split, split_direct=split_direct,
               band_ms=band_stage_ms(split), band_bound_ms=band_bound_ms,
               band_bound_by=band_bound_by,
               least_gflop=least / 1e9, direct_dft_gflop=direct_flops / 1e9,
               direct_dft_tflops_achieved=direct_flops / direct_ms / 1e9)
    say("K1 " + json.dumps(res))
    check(err <= GATE, f"K1 vs plain {err:.3e} > {GATE} at {res}")
    check(err_exact <= GATE, f"K1 vs exact STFT {err_exact:.3e} > {GATE}")
    check(err_direct <= GATE, f"K1 direct stage vs plain {err_direct:.3e}")
    check(xext_err <= RESIDUAL_GATE, f"K1 xext vs plain {xext_err:.3e}")
    check(res["xext_repeat_bit_identical"], "K1 xext differs on repeat")
    return res


def _plain_features(model, xb, wl, j, route):
    """The log-mel features of ``xb`` through the plain version of the
    route the model's layer takes (specband, framed, multi-sigma
    specband; the exact multi-sigma route is its own plain version)."""
    layer = model.spectrogram_layer
    xm = xb - xb.mean(dim=-1, keepdim=True)
    if route.endswith("_multi"):
        if route == "exact_multi":
            mel = multi_sigma_mel_spectrogram(
                xb, layer.lambd, n_mels=N_MELS, sample_rate=SR,
                hop_length=HOP, optimized=True, window_length=wl,
                impl="exact", device=xb.device)
        else:
            ws = torch.stack([gaussian_window(lam, wl)
                              for lam in layer.lambd.abs()])
            mel = specband.specband_mel_power_multi_plain(
                xm, ws, default_band_map(N_MELS, len(ws)), n_fft=wl,
                hop_length=HOP, n_mels=N_MELS, sample_rate=SR, j_taps=j)
        return torch.log(mel + LOG_EPS)[:, None]
    w = gaussian_window(layer.lambd.abs(), wl)
    if j is not None:
        mel = specband.specband_mel_power_plain(
            xm, w, n_fft=wl, hop_length=HOP, n_mels=N_MELS, sample_rate=SR,
            j_taps=j)
    else:
        mel = framed.framed_mel_power_plain(
            xm, w, n_fft=wl, hop_length=HOP, n_mels=N_MELS, sample_rate=SR)
    return torch.log(mel + LOG_EPS)[:, None]


#: the forward kernel each model route launches once a batch (none on the
#: exact multi-sigma route)
_ROUTE_FORWARD = {"specband": "K1", "framed": "K3", "specband_multi": "K1m",
                  "exact_multi": None}


def model_path(seed: int, dev: torch.device, lam: float,
               n_sigma: int = 1) -> dict:
    """Inference through ``predict`` at ``lam``: the specband route at
    128, the framed route at 46.7; with ``n_sigma`` groups, the
    multi-sigma specband route at 128 and the exact one at 46.7."""
    config = dict(CONFIG, init_lambd=lam, n_sigma=n_sigma)
    route, wl, hint, j = _route_of(config, lam)
    say(f"model: lambda {lam}, {n_sigma} sigma groups, window {wl}, hint "
        f"{hint}, route {route}, J {j}")
    check(route in _ROUTE_FORWARD, f"model front end takes {route}")
    key = _ROUTE_FORWARD[route]
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed)
    data = make_esc50_synth_dataset(seed=seed, n_samples=N_BATCHES * BATCH)

    t0 = time.perf_counter()
    (preds, scores), launches = counted(
        lambda: predict(model, data.xs, batch_size=BATCH, device=dev))
    first_s = time.perf_counter() - t0
    if key is None:
        check(not any(launches.values()), f"kernels launched: {launches}")
    else:
        check(launches[key] == N_BATCHES,
              f"{key} launched {launches[key]} times for {N_BATCHES} "
              "batches")
        if key in FFT_COUNTER:
            want_fft = N_BATCHES if fft_plan.plan(wl) is not None else 0
            check(launches[FFT_COUNTER[key]] == want_fft,
                  f"{key} took the FFT stage {launches[FFT_COUNTER[key]]} "
                  f"times, expected {want_fft}")
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
        s_plain = _plain_features(model, xb, wl, j, route)
        out_plain = model.spectrogram_model(s_plain.transpose(2, 3))
        err_s = float((s - s_plain).abs().max())
        err_out = float((out - out_plain).abs().max())
    res = dict(lambd=lam, n_sigma=n_sigma, route=route, launches=launches,
               batches=N_BATCHES,
               first_ms_per_batch=first_s * 1e3 / N_BATCHES,
               steady_ms_per_batch=steady_s * 1e3 / N_BATCHES,
               feature_err_vs_plain=err_s, score_err_vs_plain=err_out)
    say("model " + json.dumps(res))
    check(err_s <= GATE, f"features vs plain {err_s:.3e} > {GATE}")
    check(err_out <= GATE, f"scores vs plain {err_out:.3e} > {GATE}")
    return res


def k2_bound(batch: int, n_fft: int, j_taps: int, fb_nnz: int, log: bool,
             t: int = T):
    """(ms, 'bytes' | 'operations', gflop): the least time one H100
    needs for the taps' gradient from the spectra residual.

    Operations a frame row needs: dP over the filterbank's nonzeros
    (2 each); S recomputed with the symmetric real taps (6J + 2 a bin,
    both planes); dS = 2 dP S (3 a bin); the tap products, 2 planes x
    2 flops x (2J + 1) taps a bin; with the log epilogue, exp and a
    product a mel.  Bytes: X' (2 k_ext floats a row), the cotangent
    (and the saved log-mel), the taps and the dense filterbank read
    once; the taps' gradient written once."""
    rows = batch * stft.num_frames(t, HOP)
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
            dev: torch.device, t: int = T) -> dict:
    """The training hot path (forward + backward into lambda) through
    the kernels against the plain chain and the exact route, and K2
    against its plain version on the same residual, at ``batch`` clips
    of ``t`` samples; errors and times."""
    hint = stft.pallas_compile_hint(lambd, n_fft, HOP)
    route, j = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=n_fft,
                          lambd_hint=hint)
    check(route == "specband", f"auto dispatch took {route} at {n_fft}")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, t)).astype(
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
        plain_ms = plain_time_ms(k2_plain)
        split = stage_split(k2)

    lam = leaf()
    exact_out = mel_spectrogram(x, lam, impl="exact", **kw).sum()
    library_bwd = timed("library_bwd_ms", lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    library_bwd_dev = device_ms(lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    del exact_out
    chain_ms = time_ms(kernel_chain)
    plain_chain_ms = plain_time_ms(plain_chain)
    exact_chain_ms = time_ms(exact_chain)

    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by, least_gflop = k2_bound(batch, n_fft, j, fb_nnz, log,
                                               t=t)
    res = dict(batch=batch, t=t, n_fft=n_fft, lambd=lambd, j_taps=j, log=log,
               dlambd=float(g_k), dlambd_rel_err=dlam_rel,
               dlambd_rel_err_vs_exact=dlam_rel_exact,
               dlambd_repeat_bit_identical=bool(torch.equal(g_k, g_k2)),
               drho_repeat_bit_identical=bool(torch.equal(d_k, d_k2)),
               drho_max_abs_err=drho_abs, drho_err_of_max=drho_rel,
               drho_max_tap_rel_err=drho_tap_rel, **kernel_t,
               plain_ms=plain_ms, split=split,
               tap_instance=specband._bwd_lib().specband_bwd_tap_instance(
                   2 * j + 1),
               **library_bwd, library_bwd_device_ms=library_bwd_dev,
               chain_ms=chain_ms,
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


def sigma_bins(n_fft: int, band_map, k_sig: int) -> list[int]:
    """Each sigma group's bin count: the smallest bin range that holds
    the nonzero filterbank entries of its mel bands (what the
    multi-sigma kernels convolve for that group)."""
    fb = melscale_fbanks_np(n_fft // 2 + 1, 0.0, SR // 2, N_MELS, SR)
    widths = []
    for s in range(k_sig):
        rows = np.flatnonzero((fb[:, np.asarray(band_map) == s] != 0).any(1))
        widths.append(int(rows[-1] - rows[0] + 1) if rows.size else 0)
    return widths


def k1m_bound(batch: int, n_fft: int, j_taps: int, fb_nnz: int,
              widths: list[int]):
    """(ms, 'bytes' | 'operations', gflop): the least time one H100
    needs for the multi-sigma specband forward, no log: one real FFT of
    each unwindowed frame, shared by the groups; for each group its band
    convolution (6J + 2 a bin, symmetric real taps) and power (3 a bin)
    over its own bins (``sigma_bins``: this run's band map); the mel
    projection over the filterbank's nonzeros.  Bytes: the signal, the
    K tap vectors and the filterbank read once; the mel and the spectra
    residual ``xext`` (2 k_ext floats a frame) written once."""
    rows = batch * stft.num_frames(T, HOP)
    n_bins = n_fft // 2 + 1
    flops = rows * (2.5 * n_fft * math.log2(n_fft)
                    + (6 * j_taps + 5) * sum(widths) + 2 * fb_nnz)
    nbytes = 4 * (batch * T + len(widths) * (2 * j_taps + 1)
                  + n_bins * N_MELS + batch * N_MELS * stft.num_frames(T, HOP)
                  + rows * 2 * (n_bins + 2 * j_taps))
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def k2m_bound(batch: int, n_fft: int, j_taps: int, fb_nnz: int,
              widths: list[int]):
    """(ms, 'bytes' | 'operations', gflop): the least time one H100
    needs for the multi-sigma taps' gradient from the spectra residual:
    dP over the filterbank's nonzeros (each band in its own group), and
    for each group over its own bins the recomputed S (6J + 2 a bin),
    dS (3) and the tap products (4 (2J + 1)).  Bytes: X' (2 k_ext floats
    a row), the cotangent, the taps and the filterbank read once, the
    (K, 2J + 1) gradient written once."""
    rows = batch * stft.num_frames(T, HOP)
    n_bins = n_fft // 2 + 1
    n_taps = 2 * j_taps + 1
    k_ext = n_bins + 2 * j_taps
    flops = rows * (2 * fb_nnz
                    + (6 * j_taps + 5 + 4 * n_taps) * sum(widths))
    nbytes = 4 * (rows * 2 * k_ext + rows * N_MELS + n_bins * N_MELS
                  + 2 * len(widths) * n_taps)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops / 1e9)


def _group_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest relative error over the sigma groups."""
    return float(((a - b).abs() / b.abs()).max())


def multi_case(seed: int, batch: int, n_fft: int, lams: tuple,
               dev: torch.device) -> dict:
    """K1 and K2 at k_sig = len(lams) on the multi-sigma route, with the
    hint of the mean lambda as the trainer builds it: K1 against the
    plain multi-sigma function and the exact multi-sigma route (log-mel),
    K2 against its plain version on K1's residual (of its largest entry,
    bit-identical on repeat), dlambda (K,) through the kernels against
    autograd of the plain chain and of the exact route (each group).
    Times: the kernels, their plain versions, the exact route's forward
    (K1's yardstick) and its backward into lambda (K2's), and the three
    chains."""
    k = len(lams)
    hint = stft.pallas_compile_hint(float(np.mean(lams)), n_fft, HOP)
    route, j = multi_sigma_route(hop_length=HOP, n_mels=N_MELS,
                                 optimized=True, window_length=n_fft,
                                 lambd_hint=hint)
    check(route == "specband", f"multi-sigma route {route} at {n_fft}")
    check(all(stft.specband_j_taps(lam, n_fft) <= j for lam in lams),
          f"a lambda of {lams} needs more than J = {j}")
    bm = default_band_map(N_MELS, k)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, T)).astype(
        np.float32)).to(dev)
    xm = x - x.mean(dim=-1, keepdim=True)
    lam_t = torch.tensor(lams, device=dev)
    ws = torch.stack([gaussian_window(lam, n_fft) for lam in lam_t])
    kw = dict(n_fft=n_fft, hop_length=HOP, n_mels=N_MELS, sample_rate=SR,
              j_taps=j)
    mkw = dict(n_mels=N_MELS, sample_rate=SR, hop_length=HOP, optimized=True,
               window_length=n_fft, device=dev)
    nfr = stft.num_frames(T, HOP)

    def kernel():
        return specband.specband_mel_power_multi(xm, ws, bm, **kw)

    def plain():
        return specband.specband_mel_power_multi_plain(xm, ws, bm, **kw)

    def library():
        return multi_sigma_mel_spectrogram(x, lam_t, impl="exact", **mkw)

    geom = specband._Geom(n_fft, HOP, N_MELS, SR, 0.0, float(SR // 2), j,
                          False, tuple(int(v) for v in bm))

    def direct():
        """K1 multi with the direct-DFT spectra stage, through its C
        entry."""
        return specband.launch_fwd(
            xm, specband.window_taps_sym(ws, n_fft, j), geom, None)[0]

    with torch.no_grad():
        mel_k, mel_p, mel_x, mel_d = kernel(), plain(), library(), direct()
        torch.cuda.synchronize()
        check(mel_k.shape == (batch, N_MELS, nfr), f"shape {mel_k.shape}")
        check(bool(torch.isfinite(mel_k).all()), "non-finite mel")
        log_k = torch.log(mel_k + LOG_EPS)
        log_p = torch.log(mel_p + LOG_EPS)
        err = float((log_k - log_p).abs().max())
        err_exact = float((log_k - torch.log(mel_x + LOG_EPS)).abs().max())
        err_direct = float((torch.log(mel_d + LOG_EPS) - log_p).abs().max())
        kernel_t = timed("ms", kernel)
        direct_ms = time_ms(direct)
        plain_ms = plain_time_ms(plain)
        library_t = timed("library_ms", library)
        library_dev = device_ms(library)
        split, split_direct = stage_split(kernel), stage_split(direct)

        rho = specband.window_taps_sym(ws, n_fft, j)
        out, xext = specband._fwd(xm, rho, geom)
        _, xext2 = specband._fwd(xm, rho, geom)
        _, xext_p = specband._fwd_plain(xm, rho, geom)
        xext_err = rel_err(xext, xext_p)
        del xext_p
        _, fb, _ = specband._consts(geom, dev)
        dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).to(dev)

        def k2():
            return specband.specband_drho(xext, rho, fb, dmel, None, bm)

        def k2_plain():
            return specband.specband_drho_plain(xext, rho, fb, dmel, None, bm)

        d_k, d_k2, d_p = k2(), k2(), k2_plain()
        torch.cuda.synchronize()
        check(d_k.shape == (k, 2 * j + 1), f"drho shape {d_k.shape}")
        drho_rel = float((d_k - d_p).abs().max() / d_p.abs().max())
        k2_t = timed("k2_ms", k2)
        k2_plain_ms = plain_time_ms(k2_plain)
        k2_split = stage_split(k2)

    def leaf():
        return torch.tensor(lams, device=dev, requires_grad=True)

    def kernel_chain():
        lam = leaf()
        torch.log(multi_sigma_mel_spectrogram(
            x, lam, impl="auto", lambd_hint=hint, **mkw)
            + LOG_EPS).sum().backward()
        return lam.grad

    def plain_chain():
        lam = leaf()
        wsl = torch.stack([gaussian_window(v, n_fft) for v in lam.abs()])
        torch.log(specband.specband_mel_power_multi_plain(xm, wsl, bm, **kw)
                  + LOG_EPS).sum().backward()
        return lam.grad

    def exact_chain():
        lam = leaf()
        torch.log(multi_sigma_mel_spectrogram(x, lam, impl="exact", **mkw)
                  + LOG_EPS).sum().backward()
        return lam.grad

    g_k, g_k2, g_p, g_x = (kernel_chain(), kernel_chain(), plain_chain(),
                           exact_chain())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g_k).all()), f"non-finite dlambda {g_k}")
    lam = leaf()
    exact_out = torch.log(multi_sigma_mel_spectrogram(
        x, lam, impl="exact", **mkw) + LOG_EPS).sum()
    library_bwd = timed("library_bwd_ms", lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    library_bwd_dev = device_ms(lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    del exact_out
    chain_ms = time_ms(kernel_chain)
    plain_chain_ms = plain_time_ms(plain_chain)
    exact_chain_ms = time_ms(exact_chain)

    fb_nnz = int((fb != 0).sum())
    widths = sigma_bins(n_fft, bm, k)
    bound_ms, bound_by, least_gflop = k1m_bound(batch, n_fft, j, fb_nnz,
                                                widths)
    k2_bound_ms, k2_bound_by, k2_gflop = k2m_bound(batch, n_fft, j, fb_nnz,
                                                   widths)
    band_bound_ms, band_bound_by = k1_band_bound(batch * nfr, n_fft, j,
                                                 fb_nnz, widths, False, k)
    res = dict(batch=batch, n_fft=n_fft, lambd=list(lams), hint=hint,
               j_taps=j, k_sig=k, sigma_bins=widths,
               stage=fft_plan.stage_name(n_fft),
               radices=fft_plan.plan(n_fft),
               logmel_max_abs_err=err, logmel_err_vs_exact_route=err_exact,
               logmel_err_direct_stage=err_direct, xext_err_of_max=xext_err,
               xext_repeat_bit_identical=bool(torch.equal(xext, xext2)),
               direct_ms=direct_ms, split=split, split_direct=split_direct,
               band_ms=band_stage_ms(split), band_bound_ms=band_bound_ms,
               band_bound_by=band_bound_by,
               dlambd=g_k.tolist(), dlambd_rel_err=_group_rel(g_k, g_p),
               dlambd_rel_err_vs_exact=_group_rel(g_k, g_x),
               dlambd_repeat_bit_identical=bool(torch.equal(g_k, g_k2)),
               drho_repeat_bit_identical=bool(torch.equal(d_k, d_k2)),
               drho_err_of_max=drho_rel, **kernel_t, plain_ms=plain_ms,
               **library_t, library_device_ms=library_dev,
               bound_ms=bound_ms, bound_by=bound_by,
               least_gflop=least_gflop, **k2_t, k2_plain_ms=k2_plain_ms,
               k2_split=k2_split, k2_bound_ms=k2_bound_ms,
               k2_bound_by=k2_bound_by, k2_least_gflop=k2_gflop,
               **library_bwd, library_bwd_device_ms=library_bwd_dev,
               chain_ms=chain_ms,
               plain_chain_ms=plain_chain_ms, exact_chain_ms=exact_chain_ms)
    say("K1/K2 multi " + json.dumps(res))
    check(err <= GATE, f"K1 multi vs plain {err:.3e} > {GATE}")
    check(err_exact <= GATE, f"K1 multi vs exact route {err_exact:.3e}")
    check(err_direct <= GATE, f"K1 multi direct stage {err_direct:.3e}")
    check(xext_err <= RESIDUAL_GATE, f"K1 multi xext {xext_err:.3e}")
    check(res["xext_repeat_bit_identical"], "K1 multi xext differs on repeat")
    check(res["dlambd_rel_err"] <= GRAD_GATE,
          f"dlambda vs plain {res['dlambd_rel_err']:.3e}")
    check(res["dlambd_rel_err_vs_exact"] <= GRAD_GATE,
          f"dlambda vs exact route {res['dlambd_rel_err_vs_exact']:.3e}")
    check(drho_rel <= DRHO_GATE, f"K2 multi vs plain {drho_rel:.3e} of max")
    check(res["dlambd_repeat_bit_identical"], "dlambda differs on repeat")
    check(res["drho_repeat_bit_identical"], "K2 multi differs on repeat")
    return res


def launch_counts() -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in COUNTERS.items()}


def counted(fn):
    """``(result, launches)``: ``fn()`` run with every kernel's launch
    counter set to 0 just before it, and the counts read just after."""
    for obj, attr in COUNTERS.values():
        setattr(obj, attr, 0)
    out = fn()
    return out, launch_counts()


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
    STFT, and its direct stage through the same entry; on the framed
    route K4 against its plain version on the kernel's residual; dlambda
    through the route against autograd of the plain chain and of the
    exact route; errors and times."""
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

    entry = "framed_fwd" if route == "framed" else "fused_fwd"

    def direct():
        """The direct-DFT stage through the kernel's own C entry: its
        same-run reference."""
        return framed.launch_fwd(entry, xm, w, g, None)

    with torch.no_grad():
        (mel_k, reim), (_, reim2) = kernel(xm, w, g), kernel(xm, w, g)
        mel_p, reim_p = framed.fwd_plain(xm, w, g)
        mel_d = direct()[0]
        log_x = library()
        torch.cuda.synchronize()
        check(mel_k.shape == (batch, N_MELS, nfr), f"shape {mel_k.shape}")
        check(bool(torch.isfinite(mel_k).all()), "non-finite mel")
        log_k = torch.log(mel_k + LOG_EPS)
        log_p = torch.log(mel_p + LOG_EPS)
        err = float((log_k - log_p).abs().max())
        err_exact = float((log_k - log_x).abs().max())
        err_direct = float((torch.log(mel_d + LOG_EPS) - log_p).abs().max())
        reim_err = rel_err(reim, reim_p)
        reim_repeat = bool(torch.equal(reim, reim2))
        del reim2, reim_p
        kernel_t = timed("ms", lambda: kernel(xm, w, g))
        direct_ms = time_ms(direct)
        plain_ms = plain_time_ms(lambda: framed.fwd_plain(xm, w, g))
        library_t = timed("library_ms", library)
        library_dev = device_ms(library)
        split = stage_split(lambda: kernel(xm, w, g))
        split_direct = stage_split(direct)
        if route == "framed":
            dmel = torch.from_numpy(rng.standard_normal(
                (batch, N_MELS, nfr)).astype(np.float32)).to(dev)

            def k4():
                return framed.framed_dwindow(xm, reim, dmel, g)

            def k4_plain():
                return framed.framed_dwindow_plain(xm, reim, dmel, g)

            def k4_direct():
                """K4 with the direct adjoint, through its C entry."""
                return framed.launch_bwd("framed_bwd", xm, reim, dmel, g,
                                         None)

            d_k, d_k2, d_p, d_d = k4(), k4(), k4_plain(), k4_direct()
            torch.cuda.synchronize()
            dw_abs = float((d_k - d_p).abs().max())
            dw_rel = dw_abs / float(d_p.abs().max())
            dw_rel_direct = rel_err(d_d, d_p)
            dw_repeat = bool(torch.equal(d_k, d_k2))
            k4_t = timed("k4_ms", k4)
            k4_direct_ms = time_ms(k4_direct)
            k4_plain_ms = plain_time_ms(k4_plain)
            k4_split = stage_split(k4)
            k4_split_direct = stage_split(k4_direct)

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
    library_bwd_dev = device_ms(lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    del exact_out
    chain_ms = time_ms(kernel_chain)
    plain_chain_ms = plain_time_ms(plain_chain)
    exact_chain_ms = time_ms(exact_chain)

    fb_nnz = int((fb != 0).sum())
    bound_ms, bound_by, least_gflop = framed_bound(batch, t, nfft, fb_nnz)
    stage = (fused_stage_fields(nfft) if route == "fused" else
             dict(stage=fft_plan.stage_name(nfft),
                  radices=fft_plan.plan(nfft)))
    if stage["stage"] == "bluestein":
        with torch.no_grad():
            stage.update(pack_of_two(seed, xm, w, lambd, win, g))
    res = dict(route=route, batch=batch, t=t, win_length=win, n_fft=nfft,
               lambd=lambd, **stage,
               logmel_max_abs_err=err, logmel_err_vs_exact_stft=err_exact,
               logmel_err_direct_stage=err_direct, reim_err_of_max=reim_err,
               reim_repeat_bit_identical=reim_repeat, direct_ms=direct_ms,
               split=split, split_direct=split_direct,
               dlambd=float(g_k), dlambd_rel_err=dlam_rel,
               dlambd_rel_err_vs_exact=dlam_rel_exact,
               dlambd_repeat_bit_identical=bool(torch.equal(g_k, g_k2)),
               **kernel_t, plain_ms=plain_ms, **library_t,
               library_device_ms=library_dev,
               bound_ms=bound_ms, bound_by=bound_by, least_gflop=least_gflop,
               direct_dft_gflop=4 * batch * nfr * nfft * framed.kp_of(nfft)
               / 1e9, **library_bwd, library_bwd_device_ms=library_bwd_dev,
               chain_ms=chain_ms,
               plain_chain_ms=plain_chain_ms, exact_chain_ms=exact_chain_ms)
    if route == "framed":
        k4_bound_ms, k4_bound_by, k4_gflop = k4_bound(batch, t, nfft, fb_nnz)
        res.update(dw_max_abs_err=dw_abs, dw_err_of_max=dw_rel,
                   dw_err_of_max_direct_stage=dw_rel_direct,
                   dw_repeat_bit_identical=dw_repeat,
                   k4_stage=fft_plan.stage_name(nfft), **k4_t,
                   k4_direct_ms=k4_direct_ms, k4_split=k4_split,
                   k4_split_direct=k4_split_direct,
                   k4_plain_ms=k4_plain_ms, k4_bound_ms=k4_bound_ms,
                   k4_bound_by=k4_bound_by, k4_least_gflop=k4_gflop,
                   k4_direct_gflop=4 * batch * nfr * nfft
                   * framed.kp_of(nfft) / 1e9)
    say({"framed": "K3/K4 ", "fused": "K5 "}[route] + json.dumps(res))
    check(err <= GATE, f"{route} forward vs plain {err:.3e} > {GATE}")
    check(err_exact <= GATE, f"{route} vs exact STFT {err_exact:.3e}")
    check(err_direct <= GATE, f"{route} direct stage {err_direct:.3e}")
    check(reim_err <= RESIDUAL_GATE, f"{route} Re|Im vs plain {reim_err:.3e}")
    check(reim_repeat, f"{route} Re|Im differs on repeat")
    check(dlam_rel <= GRAD_GATE, f"dlambda vs plain {dlam_rel:.3e}")
    check(dlam_rel_exact <= GRAD_GATE,
          f"dlambda vs exact route {dlam_rel_exact:.3e}")
    check(res["dlambd_repeat_bit_identical"], "dlambda differs on repeat")
    if not optimized and route == "fused" and fft_plan.plan(nfft) is None:
        check(res["stage"] == "bluestein", f"K5 took {res['stage']}")
    if res["stage"] == "bluestein":
        check(res["pack2_fwd_bit_identical"],
              "a pack of two K5 trials differs from the single launches")
        check(res["pack2_dw_bit_identical"],
              "a pack of two K6 trials differs from the single launches")
    if route == "framed":
        check(dw_rel <= DW_GATE, f"K4 vs plain {dw_rel:.3e} of max")
        check(dw_rel_direct <= DW_GATE,
              f"K4 direct stage vs plain {dw_rel_direct:.3e} of max")
        check(dw_repeat, "K4 differs on repeat")
    return res


def k6_case(seed: int, batch: int, lambd: float, dev: torch.device,
            n_fft: int | None = None, t: int = T) -> dict:
    """K6 on K5's residual at one fused geometry (``n_fft`` the bucket,
    or None for faithful mode's 2 t with the window centred in it)
    against its plain version, the torch adjoint
    ``framed.framed_dwindow_plain`` (of its largest entry, bit-identical
    on repeat), and the direct adjoint through K6's entry against it
    too.  Times: K6, the direct adjoint, the torch adjoint, and the
    exact route's backward into lambda at this geometry (as K4's
    yardstick, by events and by the profiler)."""
    optimized = n_fft is not None
    win, nfft = (n_fft, n_fft) if optimized else (t, 2 * t)
    hint = (stft.pallas_compile_hint(lambd, nfft, HOP) if optimized
            else lambd)
    got_route, _ = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                              optimized=optimized, window_length=n_fft,
                              lambd_hint=hint)
    check(got_route == "fused", f"auto dispatch took {got_route}, not fused")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, t)).astype(
        np.float32)).to(dev)
    xm = x - x.mean(dim=-1, keepdim=True)
    g = framed.Geom(nfft, HOP, N_MELS, SR, 0.0, float(SR // 2))
    w = fused.pad_window(gaussian_window(torch.tensor(lambd, device=dev),
                                         win), nfft)
    with torch.no_grad():
        out, reim = fused.fused_fwd(xm, w, g)
        dmel = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).to(dev)

        def k6():
            return fused.fused_dwindow(xm, reim, dmel, g)

        def k6_plain():
            return framed.framed_dwindow_plain(xm, reim, dmel, g)

        def direct():
            return framed.launch_bwd("fused_bwd", xm, reim, dmel, g, None)

        d_k, d_k2, d_p, d_d = k6(), k6(), k6_plain(), direct()
        torch.cuda.synchronize()
        check(d_k.shape == (nfft,), f"dw shape {d_k.shape}")
        check(bool(torch.isfinite(d_k).all()), "non-finite dw")
        dw_rel = rel_err(d_k, d_p)
        dw_rel_direct = rel_err(d_d, d_p)
        kernel_t = timed("ms", k6)
        direct_ms = time_ms(direct)
        plain_ms = plain_time_ms(k6_plain)
        split, split_direct = stage_split(k6), stage_split(direct)
    lam = torch.tensor(lambd, device=dev, requires_grad=True)
    exact_out = mel_spectrogram(x, lam, impl="exact", n_mels=N_MELS,
                                sample_rate=SR, hop_length=HOP,
                                optimized=optimized, window_length=n_fft,
                                log_output=True, device=dev).sum()
    library_bwd = timed("library_bwd_ms", lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    library_bwd_dev = device_ms(lambda: torch.autograd.grad(
        exact_out, lam, retain_graph=True))
    del exact_out
    fb_nnz = int((framed._fb(g, dev) != 0).sum())
    bound_ms, bound_by, least_gflop = k4_bound(batch, t, nfft, fb_nnz)
    stage = fused_stage_fields(nfft)
    if stage["stage"] == "bluestein":
        with torch.no_grad():
            stage.update(pack_of_two(seed, xm, w, lambd, win, g))
    res = dict(batch=batch, t=t, win_length=win, n_fft=nfft, lambd=lambd,
               **stage, dw_err_of_max=dw_rel,
               dw_err_of_max_direct_stage=dw_rel_direct,
               dw_repeat_bit_identical=bool(torch.equal(d_k, d_k2)),
               **kernel_t, direct_ms=direct_ms, split=split,
               split_direct=split_direct, plain_ms=plain_ms, **library_bwd,
               library_bwd_device_ms=library_bwd_dev,
               bound_ms=bound_ms, bound_by=bound_by, least_gflop=least_gflop,
               direct_gflop=4 * batch * stft.num_frames(t, HOP) * nfft
               * framed.kp_of(nfft) / 1e9)
    say("K6 " + json.dumps(res))
    check(dw_rel <= DW_GATE, f"K6 vs plain {dw_rel:.3e} of max")
    check(dw_rel_direct <= DW_GATE,
          f"K6 direct stage vs plain {dw_rel_direct:.3e} of max")
    check(res["dw_repeat_bit_identical"], "K6 differs on repeat")
    if not optimized and fft_plan.plan(nfft) is None:
        check(res["stage"] == "bluestein", f"K6 took {res['stage']}")
    if res["stage"] == "bluestein":
        check(res["pack2_fwd_bit_identical"] and res["pack2_dw_bit_identical"],
              "a pack of two trials differs from the single launches")
    return res


def faithful_path(seed: int, dev: torch.device, batch: int = 512,
                  t: int = 2039) -> dict:
    """Faithful mode (``optimized=False``: the window ``t`` samples,
    n_fft 2 t) through the public ``mel_spectrogram(impl="auto",
    log_output=True)``, forward and ``backward()`` into lambda with
    ``fused.USE_FUSED_BWD`` set, at B 512 x 2039 (n_fft 4078, Bluestein's
    stage at m_pad 4096): the auto route takes fused, K5 and K6 launch
    once each, both on Bluestein's stage; the log-mel within 1e-4 of the
    exact route (cuFFT) and dlambda within 1e-2 of its; the call's ms
    beside the exact route's."""
    lam0 = t / 5.0
    route, _ = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                          optimized=False, window_length=None,
                          lambd_hint=lam0)
    check(route == "fused", f"faithful T {t} took {route}")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, t)).astype(np.float32)).to(dev)
    kw = dict(n_mels=N_MELS, sample_rate=SR, hop_length=HOP,
              optimized=False, log_output=True, lambd_hint=lam0, device=dev)

    def run(impl):
        lam = torch.tensor(lam0, device=dev, requires_grad=True)
        out = mel_spectrogram(x, lam, impl=impl, **kw)
        out.sum().backward()
        return out.detach(), lam.grad

    prev = fused.USE_FUSED_BWD
    fused.USE_FUSED_BWD = True
    try:
        (out_k, g_k), launches = counted(lambda: run("auto"))
        out_x, g_x = run("exact")
        torch.cuda.synchronize()
        ms = time_ms(lambda: run("auto"))
        exact_ms = time_ms(lambda: run("exact"))
    finally:
        fused.USE_FUSED_BWD = prev
    err = float((out_k - out_x).abs().max())
    dlam_rel = float((g_k - g_x).abs() / g_x.abs())
    res = dict(batch=batch, t=t, n_fft=2 * t, lambd=lam0, route=route,
               **fused_stage_fields(2 * t), launches=launches,
               logmel_err_vs_exact=err, dlambd=float(g_k),
               dlambd_rel_err_vs_exact=dlam_rel, ms=ms, exact_ms=exact_ms)
    say("faithful " + json.dumps(res))
    want = {"K5": 1, "K5bl": 1, "K6": 1, "K6bl": 1}
    check({k: v for k, v in launches.items() if v} == want,
          f"faithful path launched {launches}")
    check(err <= GATE, f"faithful log-mel vs exact {err:.3e}")
    check(dlam_rel <= GRAD_GATE, f"faithful dlambda vs exact {dlam_rel:.3e}")
    return res


def fused_bwd_grad_check(seed: int, dev: torch.device, config: dict,
                         trainset, wl, hint) -> dict:
    """One fused train-mode gradient computation on one batch with
    ``fused.USE_FUSED_BWD`` off (the torch adjoint) and on (K6), from
    the same weights, batch and dropout masks: dlambda within relative
    1e-3, fc_esc50.weight within 1e-4 of its largest entry; the flag-on
    run launches K5 and K6 once each."""
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed).train()
    xs, ys, mask = _batch(trainset, dev)
    params = [model.spectrogram_layer.lambd,
              model.spectrogram_model.fc_esc50.weight]
    gen = torch.Generator(device=dev).manual_seed(seed)
    gen_state = gen.get_state()

    def grads(flag):
        fused.USE_FUSED_BWD = flag
        gen.set_state(gen_state)
        with precision_scope():
            loss, _, _ = loss_and_metrics(model, xs, ys, mask, one_hot=True,
                                          n_classes=10, generator=gen)
            out = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return out

    prev = fused.USE_FUSED_BWD
    try:
        g_off = grads(False)
        g_on, launches = counted(lambda: grads(True))
    finally:
        fused.USE_FUSED_BWD = prev
    dlam_rel = float((g_on[0] - g_off[0]).abs() / g_off[0].abs())
    w_err = float((g_on[1] - g_off[1]).abs().max() / g_off[1].abs().max())
    res = dict(dlambd_k6=float(g_on[0]), dlambd_torch_adjoint=float(g_off[0]),
               dlambd_rel_err_k6_vs_torch_adjoint=dlam_rel,
               fc_weight_grad_err_of_max=w_err, flag_on_launches=launches)
    say("fused bwd flag " + json.dumps(res))
    check(launches["K5"] == 1 and launches["K6"] == 1,
          f"flag on launched {launches}")
    check(dlam_rel <= TRAIN_GRAD_GATE, f"K6 dlambda {dlam_rel:.3e}")
    check(w_err <= WEIGHT_GRAD_GATE, f"K6 fc_esc50 weight grad {w_err:.3e}")
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


def train_grad_check(seed: int, dev: torch.device, config: dict, trainset,
                     wl, hint, j: int, route: str,
                     dlambd_gate: float = TRAIN_GRAD_GATE) -> dict:
    """Gradients of lambda and fc_esc50.weight on one batch: the model
    through the kernels against the same model, batch and dropout masks
    through the plain specband function (single- or multi-sigma), the
    same log and CNN6 head.  dlambda's error is relative in norm (a
    vector with several sigma groups), gated at ``dlambd_gate``."""
    model = get_model_by_config(config, window_length=wl,
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
        s = _plain_features(model, xs, wl, j, route)
        out = model.spectrogram_model(s.transpose(2, 3), gen)
        loss_p = bce_loss(out, F.one_hot(ys.long(), 10).to(out.dtype), mask)
        grads_p = torch.autograd.grad(loss_p, params)

    dlam_rel = float((grads_k[0] - grads_p[0]).norm() / grads_p[0].norm())
    w_err = float((grads_k[1] - grads_p[1]).abs().max()
                  / grads_p[1].abs().max())
    res = dict(loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
               dlambd_kernel=grads_k[0].tolist(),
               dlambd_plain=grads_p[0].tolist(),
               dlambd_rel_err=dlam_rel, fc_weight_grad_err_of_max=w_err)
    say("train grad " + json.dumps(res))
    check(dlam_rel <= dlambd_gate, f"train dlambda {dlam_rel:.3e}")
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
    """``(route, window, hint, J)`` of a model built from ``config`` at
    ``lam``; a multi-sigma config's routes are named ``"<route>_multi"``.
    The hint comes from the scalar (mean) lambda, as the trainer's.  A
    faithful-mode config (the DSPEC probes) takes the exact route, with
    no window bucket and no hint."""
    if not config.get("optimized", False):
        return "exact", None, None, None
    t = int(config["n_points"])
    wl = bucketed_window_length(lam, t)
    hint = dispatch_hint_for(config, wl, lam)
    if config.get("n_sigma", 1) > 1:
        route, j = multi_sigma_route(hop_length=HOP, n_mels=N_MELS,
                                     optimized=True, window_length=wl,
                                     lambd_hint=hint)
        return route + "_multi", wl, hint, j
    route, j = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=wl,
                          lambd_hint=hint)
    return route, wl, hint, j


#: the kernels each route launches on one train step, and on one valid
#: batch (the fused route's step also launches K6 under USE_FUSED_BWD)
_ROUTE_KERNELS = {"specband": (("K1", "K2"), ("K1",)),
                  "framed": (("K3", "K4"), ("K3",)),
                  "fused": (("K5",), ("K5",)), "exact": ((), ()),
                  "specband_multi": (("K1m", "K2m"), ("K1m",)),
                  "exact_multi": ((), ())}


def route_kernels(route: str):
    train, valid = _ROUTE_KERNELS[route]
    if route == "fused" and fused.USE_FUSED_BWD:
        train = train + ("K6",)
    return train, valid


def epoch_launches(config, lam0, records, seen, steps, valid_batches):
    """Each epoch's route (from the lambda it started at), the launches
    it made (``seen``: the cumulative counts at each epoch's report) and
    the launches its route should make: the route's train kernels once a
    step (of a frozen lambda, the forward kernels only), its valid
    kernels once a valid batch, and the FFT counters with them where the
    window has a plan."""
    trainable = config.get("trainable", True)
    epochs = []
    prev = dict.fromkeys(COUNTERS, 0)
    lam_start = lam0
    for r, cum in zip(records, seen):
        ep_route, ep_wl = _route_of(config, lam_start)[:2]
        launched = {k: cum[k] - prev[k] for k in COUNTERS}
        want = dict.fromkeys(COUNTERS, 0)
        train_k, valid_k = route_kernels(ep_route)
        for k in train_k:
            if trainable or k in valid_k:
                want[k] += steps
        for k in valid_k:
            want[k] += valid_batches
        if ep_wl is not None and fft_plan.plan(ep_wl) is not None:
            for k, k_fft in FFT_COUNTER.items():
                want[k_fft] = want[k]
        epochs.append(dict(epoch=r["epoch"], lambd_start=lam_start,
                           route=ep_route, window_length=ep_wl,
                           launches=launched, expected=want))
        say("record " + json.dumps(dict(r, route=ep_route,
                                        launches=launched)))
        prev, lam_start = cum, r["lambd_est"]
    return epochs


def check_epochs(epochs):
    for e in epochs:
        check(e["launches"] == e["expected"],
              f"epoch {e['epoch']} on {e['route']}: launches "
              f"{e['launches']}, expected {e['expected']}")


def train_path(seed: int, dev: torch.device, lam0: float,
               repeat: bool = False, n_sigma: int = 1,
               fused_bwd: bool = False) -> dict:
    """``fit`` from ``lam0``: launches counted by epoch against the route
    each epoch's refresh picked; ms per train step on the starting
    route; at lambda 128 also the one-batch gradient check and, with one
    sigma group, the step's cost with cuDNN's deterministic algorithms
    off and on; with ``repeat``, a second ``fit`` with the same seed must
    give the same lambda after every epoch and the same weights, bit for
    bit.  ``n_sigma`` groups train a multi-sigma front end (lambda of
    shape (n_sigma,) must move); ``fused_bwd`` sets
    ``fused.USE_FUSED_BWD`` for the whole path and adds the one-batch
    comparison of the flag on and off."""
    fused.USE_FUSED_BWD = fused_bwd
    try:
        return _train_path(seed, dev, lam0, repeat, n_sigma, fused_bwd)
    finally:
        fused.USE_FUSED_BWD = False


def _train_path(seed, dev, lam0, repeat, n_sigma, fused_bwd):
    config = dict(TRAIN_CONFIG, init_lambd=lam0, n_sigma=n_sigma)
    trainset, validset, _ = get_dataset_by_config(config)
    route, wl, hint, j = _route_of(config, lam0)
    steps = -(-len(trainset) // BATCH)
    valid_batches = -(-len(validset) // BATCH)
    say(f"train: lambda {lam0}, {n_sigma} sigma groups, route {route}, "
        f"K6 {fused_bwd}, {len(trainset)} train / {len(validset)} valid "
        f"clips, {steps} steps and {valid_batches} valid batches an epoch, "
        f"window {wl}, hint {hint}, J {j}")
    extra = {}
    if route == "specband":
        # the deterministic setting's step cost, in turns off, on, on, off
        turns = [train_step_ms(seed, dev, config, trainset, wl, hint, det)
                 for det in (False, True, True, False)]
        for r in turns:
            say("train step " + json.dumps(r))
        times = turns[1]
        extra = dict(step_turns=turns,
                     **train_grad_check(seed, dev, config, trainset, wl,
                                        hint, j, route),
                     **determinism_probe(seed, dev, trainset, wl, hint))
    elif route == "specband_multi":
        times = train_step_ms(seed, dev, config, trainset, wl, hint)
        say("train step " + json.dumps(times))
        extra = train_grad_check(seed, dev, config, trainset, wl, hint, j,
                                 route)
    elif fused_bwd:
        times = train_step_ms(seed, dev, config, trainset, wl, hint)
        say("train step " + json.dumps(times))
        extra = fused_bwd_grad_check(seed, dev, config, trainset, wl, hint)
    else:
        times = train_step_ms(seed, dev, config, trainset, wl, hint)
        say("train step " + json.dumps(times))

    seen = []
    t0 = time.perf_counter()
    (state, history), total = counted(lambda: fit(
        config, trainset, validset, seed=seed, device=dev,
        report_fn=lambda r: seen.append(launch_counts())))
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
    epochs = epoch_launches(config, lam0, records, seen, steps,
                            valid_batches)
    lam_end = state["model"].spectrogram_layer.lambd.detach()
    res = dict(lambd=lam0, n_sigma=n_sigma, fused_bwd=fused_bwd,
               route=route, epochs=epochs, lambd_end=lam_end.tolist(),
               steps_per_epoch=steps, valid_batches_per_epoch=valid_batches,
               launches=total, fit_s=fit_s, **times,
               init_lambd=history["init_lambd"],
               est_lambd=history["est_lambd"],
               window_length=state["window_length"], **extra)
    say("train " + json.dumps(res))
    check(len(records) == config["max_epochs"], f"{len(records)} epochs ran")
    check(epochs[0]["route"] == route, "epoch 0 left the starting route")
    check_epochs(epochs)
    check(all(math.isfinite(r[k]) for r in records
              for k in ("loss", "valid_loss", "energy")),
          "non-finite loss")
    check(history["est_lambd"] != history["init_lambd"], "lambda did not move")
    check(tuple(lam_end.shape) == ((n_sigma,) if n_sigma > 1 else ()),
          f"lambda of shape {tuple(lam_end.shape)}")
    check(bool((lam_end != lam0).all()), "a sigma group's lambda did not move")
    check(extra.get("fit_repeat_bit_identical", True),
          "a second fit with the same seed differs")
    return res


#: bf16 step against the float32 step on one batch and its masks,
#: relative in norm: fc_esc50.weight's gradient within 5e-2, dlambda
#: within 1e-1.  dlambda sums dL/ds ds/dlambda over every feature with
#: heavy cancellation, so bf16 rounding in the conv stack moves it by an
#: absolute ~1e-5 on every route; at lambda 600 (fused), where it is ~6x
#: smaller than at 128, that was 7.5e-2 of it on the H100 (3.1e-2 on the
#: CPU, 1.5e-2 and 1e-2 on specband and framed)
BF16_GRAD_GATE = 5e-2
BF16_DLAMBD_GATE = 1e-1
#: the search space the CLI sweeps, whole: 6 trials of 2000 clips
SWEEP_NAME, SWEEP_EPOCHS = "esc50_synth", 2


def bf16_grad_check(seed: int, dev: torch.device, config: dict, trainset,
                    wl, hint) -> dict:
    """Gradients of lambda and fc_esc50.weight on one batch: the bf16
    model against the float32 model of the same seed (the same weights)
    on the same batch and dropout masks (drawn in float32 from the same
    generator state), both relative in norm."""
    grads = {}
    for dtype in ("float32", "bfloat16"):
        model = get_model_by_config(dict(config, model_dtype=dtype),
                                    window_length=wl, lambd_hint=hint,
                                    device=dev, seed=seed).train()
        xs, ys, mask = _batch(trainset, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with precision_scope():
            loss, _, _ = loss_and_metrics(model, xs, ys, mask, one_hot=True,
                                          n_classes=10, generator=gen)
            grads[dtype] = torch.autograd.grad(
                loss, [model.spectrogram_layer.lambd,
                       model.spectrogram_model.fc_esc50.weight])
    (lam32, fc32), (lam16, fc16) = grads["float32"], grads["bfloat16"]
    for g in (lam16, fc16):
        check(g.dtype == torch.float32, f"bf16 model's gradient in {g.dtype}")
    res = dict(dlambd_float32=lam32.tolist(), dlambd_bf16=lam16.tolist(),
               dlambd_bf16_rel_err=float((lam16 - lam32).norm()
                                         / lam32.norm()),
               fc_esc50_grad_bf16_rel_err=float((fc16 - fc32).norm()
                                                / fc32.norm()))
    say("bf16 grad " + json.dumps(res))
    check(res["dlambd_bf16_rel_err"] <= BF16_DLAMBD_GATE,
          f"bf16 dlambda {res['dlambd_bf16_rel_err']:.3e}")
    check(res["fc_esc50_grad_bf16_rel_err"] <= BF16_GRAD_GATE,
          f"bf16 fc_esc50 grad {res['fc_esc50_grad_bf16_rel_err']:.3e}")
    return res


_BLOCKS = ("conv_block1", "conv_block2", "conv_block3", "conv_block4")


def cnn6_split(seed: int, dev: torch.device, config: dict, trainset, wl,
               hint) -> dict:
    """CNN6's forward + backward on one batch's features, the card's ms
    a call from ``torch.profiler`` (:func:`device_ms`), in training mode:
    the whole, the mel batch norm, and each conv block with its dropout
    on the input the model gives it (backward from a gradient of ones);
    ``head`` is the whole less those parts (pooling, fc1, fc_esc50, the
    sigmoid and the loss)."""
    from dmel_tpu_torch.models.panns import dropout
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed).train()
    cnn = model.spectrogram_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs, ys, mask = _batch(trainset, dev)
    labels = F.one_hot(ys.long(), 10).float()
    with precision_scope():
        with torch.no_grad():
            x = model.features(xs).transpose(2, 3)
            h = cnn.bn1(x.reshape(-1, x.shape[-1])).reshape(x.shape)
            inputs = [h]
            for name in _BLOCKS[:-1]:
                h = dropout(getattr(cnn, name)(h), 0.2, True, gen)
                inputs.append(h)

        def whole():
            bce_loss(cnn(x, gen), labels, mask).backward()

        def part(fn, xin):
            xin = xin.detach().requires_grad_()

            def run():
                out = fn(xin)
                out.backward(torch.ones_like(out))
            return device_ms(run)

        res = {"whole": device_ms(whole),
               "bn1": part(lambda t: cnn.bn1(t.reshape(-1, t.shape[-1]))
                           .reshape(t.shape), x)}
        for name, xin in zip(_BLOCKS, inputs):
            block = getattr(cnn, name)
            res[name] = part(lambda t, block=block: dropout(
                block(t), 0.2, True, gen), xin)
    parts = [v for k, v in res.items() if k != "whole"]
    if all(isinstance(v, float) for v in parts + [res["whole"]]):
        res["head"] = res["whole"] - sum(parts)
    return res


def bf16_step_path(seed: int, dev: torch.device, lam0: float,
                   n_sigma: int = 1) -> dict:
    """ms per train step in float32 and in bf16 (``train_step_ms``) on
    the route ``lam0`` takes, the bf16 step's gradients against the
    float32 step's (:func:`bf16_grad_check`), and, on the single-sigma
    specband route, CNN6's split by part in both dtypes."""
    config = dict(TRAIN_CONFIG, init_lambd=lam0, n_sigma=n_sigma)
    trainset, _, _ = get_dataset_by_config(config)
    route, wl, hint, _ = _route_of(config, lam0)
    res = dict(lambd=lam0, n_sigma=n_sigma, route=route)
    for dtype in ("float32", "bfloat16"):
        res[dtype] = train_step_ms(seed, dev, dict(config, model_dtype=dtype),
                                   trainset, wl, hint)
    res["steady_speedup"] = (res["float32"]["steady_ms_per_step"]
                             / res["bfloat16"]["steady_ms_per_step"])
    res.update(bf16_grad_check(seed, dev, config, trainset, wl, hint))
    if route == "specband":
        res["cnn6_split_ms"] = {
            dtype: cnn6_split(seed, dev, dict(config, model_dtype=dtype),
                              trainset, wl, hint)
            for dtype in ("float32", "bfloat16")}
    say("bf16 step " + json.dumps(res))
    return res


def _best_epoch(records) -> int:
    """The last epoch at which the valid loss reached a new minimum."""
    best, epoch = math.inf, None
    for r in records:
        if r["valid_loss"] < best:
            best, epoch = r["valid_loss"], r["epoch"]
    return epoch


def _first_batch(dataset, size: int):
    """The first ``size`` clips and labels of ``dataset`` as numpy
    arrays (without copying the whole dataset out of a Subset)."""
    items = [dataset[i] for i in range(min(size, len(dataset)))]
    return (np.stack([x for x, _ in items]).astype(np.float32),
            np.asarray([y for _, y in items]))


def sweep_path(dev: torch.device, out: str, name: str = SWEEP_NAME,
               epochs: int = SWEEP_EPOCHS, data_dir: str | None = None,
               n_test: int = 400) -> dict:
    """The space ``name``'s sweep through the CLI, as a user runs it
    (``cli.main``), into ``out`` with its data from ``data_dir``
    (default ``out``): every trial's launches counted by epoch against
    its route, its best model and sidecar checked against its records;
    the seconds of each trial and of each dataset load; then
    ``predict_test`` over the sweep (``n_test`` clips a trial: an argmax
    each, or scores for a multi-label dataset, with ``test_mAP``), and a
    second ``cli.main`` that must skip every trial.  Also returns each
    trial's records and the first train batch, for the callers' gates
    and step times, the last trial's entry also the dataset splits it
    loaded: ``(result, trials)``."""
    from dmel_tpu_torch.eval import predict_test
    from dmel_tpu_torch.experiments import cli, runner
    data_dir = out if data_dir is None else data_dir
    argv = ["--name", name, "--num_samples", "1", "--max_epochs",
            str(epochs), "--output_dir", out, "--data_dir", data_dir]
    trials, loads, last_splits = [], [], []
    real_fit, real_data = runner.fit, runner.get_dataset_by_config

    def counting_fit(config, trainset, validset, **kwargs):
        seen = []
        t0 = time.perf_counter()
        (state, history), total = counted(lambda: real_fit(
            config, trainset, validset,
            report_fn=lambda r: seen.append(launch_counts()), **kwargs))
        torch.cuda.synchronize()
        trials.append(dict(config=config, history=history, seen=seen,
                           launches=total, fit_s=time.perf_counter() - t0,
                           n_train=len(trainset), n_valid=len(validset),
                           batch=_first_batch(trainset,
                                              int(config["batch_size"]))))
        return state, history

    def timed_data(config, data_dir):
        t0 = time.perf_counter()
        splits = real_data(config, data_dir)
        loads.append(time.perf_counter() - t0)
        last_splits[:] = [splits]
        return splits

    runner.fit, runner.get_dataset_by_config = counting_fit, timed_data
    try:
        t0 = time.perf_counter()
        cli.main(argv + ["--verbose", "0"])
        sweep_s = time.perf_counter() - t0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + ["--verbose", "1"])
    finally:
        runner.fit, runner.get_dataset_by_config = real_fit, real_data
    sweep_dir = os.path.join(out, name)
    check(len(trials) == 6, f"{len(trials)} trials ran")
    trials[-1]["splits"] = last_splits[0]
    check(buf.getvalue().count("skip finished") == 6,
          "the second cli.main did not skip all six trials")

    rows = runner.load_results(sweep_dir)
    check(len(rows) == 6, f"{len(rows)} rows in results.csv")
    by_arm, results = {}, []
    for i, (t, row) in enumerate(zip(trials, rows)):
        config, records = t["config"], t["history"]["records"]
        lam0 = float(config["init_lambd"])
        steps = -(-t["n_train"] // int(config["batch_size"]))
        valid_batches = -(-t["n_valid"] // int(config["batch_size"]))
        t["epochs"] = epoch_launches(config, lam0, records, t["seen"], steps,
                                     valid_batches)
        check_epochs(t["epochs"])
        check(len(records) == epochs, f"trial {i}: {len(records)} epochs")
        ckpt = os.path.join(row["logdir"], "checkpoint_000000")
        check(os.path.basename(row["logdir"]) == f"trial_{i:05d}",
              f"row {i} is {row['logdir']}")
        for fname in ("best_model", "best_model.meta.json"):
            check(os.path.isfile(os.path.join(ckpt, fname)),
                  f"trial {i} has no {fname}")
        check(not os.path.exists(os.path.join(ckpt, "live_state")),
              f"trial {i} kept its live state")
        with open(os.path.join(ckpt, "best_model.meta.json")) as f:
            meta = json.load(f)
        best = _best_epoch(records)
        start = lam0 if best == 0 else records[best - 1]["lambd_est"]
        _, wl, hint, _ = _route_of(config, start)
        check(meta == {"window_length": wl, "lambd_hint": hint,
                       "epoch": best},
              f"trial {i}: sidecar {meta}, best epoch {best} started at "
              f"window {wl}, hint {hint}")
        arm = f"{lam0:.1f}/{'trainable' if config['trainable'] else 'fixed'}"
        by_arm[arm] = {k: v for k, v in t["launches"].items() if v}
        results.append(dict(trial=i, arm=arm, init_lambd=lam0,
                            fit_s=t["fit_s"],
                            routes=[e["route"] for e in t["epochs"]],
                            windows=[e["window_length"] for e in t["epochs"]],
                            lambd=[r["lambd_est"] for r in records],
                            valid_acc=[r["valid_acc"] for r in records],
                            sidecar=meta, launches=by_arm[arm]))

    t0 = time.perf_counter()
    scored = predict_test(sweep_dir, data_dir, verbose=0)
    predict_s = time.perf_counter() - t0
    preds = np.load(os.path.join(sweep_dir, f"{rows[0]['config/dataset_name']}"
                                 "_predictionss.npy"))
    accs = [r["test_accuracy"] for r in scored]
    for r, row in zip(results, scored):
        r["test_accuracy"] = row["test_accuracy"]
        if "test_mAP" in row:                # a multi-label dataset
            r["test_mAP"] = row["test_mAP"]
    total = dict.fromkeys(COUNTERS, 0)
    for t in trials:
        for k, v in t["launches"].items():
            total[k] += v
    res = dict(name=name, trials=results, sweep_s=sweep_s,
               s_per_trial=sweep_s / len(trials), data_load_s=loads,
               predict_test_s=predict_s,
               predictions_shape=list(preds.shape),
               launches_by_arm=by_arm, launches=total)
    say(f"sweep {name} " + json.dumps(res))
    check(all(0.0 <= a <= 1.0 for a in accs), f"test accuracies {accs}")
    check(preds.shape[:2] == (6, n_test),
          f"predictions of shape {preds.shape}")
    return res, trials


def step_ms(seed: int, dev: torch.device, config: dict, batch,
            lam: float, steps: int = 20) -> dict:
    """ms per train step of a fresh model of ``config`` at ``lam`` (the
    route and window ``lam`` takes) on one batch (numpy ``(xs, ys)``):
    first and steady over ``steps`` steps, on the host clock around
    synchronised steps, in the package's precision scope."""
    route, wl, hint, _ = _route_of(config, lam)
    model = get_model_by_config(dict(config, init_lambd=lam), wl, hint,
                                device=dev, seed=seed)
    opt = build_optimizer(config, model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.from_numpy(batch[0]).to(dev)
    ys = torch.from_numpy(batch[1]).to(dev)
    mask = torch.ones(len(xs), dtype=torch.bool, device=dev)
    kw = dict(one_hot="panns" in config["model_name"],
              n_classes=n_classes_for(config["dataset_name"]),
              generator=gen)
    with precision_scope():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, xs, ys, mask, **kw)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(model, opt, xs, ys, mask, **kw)
        torch.cuda.synchronize()
        steady = (time.perf_counter() - t0) * 1e3 / steps
    return dict(route=route, window_length=wl, lambd=lam, batch=len(xs),
                first_ms_per_step=first, steady_ms_per_step=steady)


def route_starts(trials: list) -> dict:
    """Each (route, window) an epoch of the sweep's ``trials`` started
    on, named ``"<route>-<window>"``: the config and starting lambda of
    the first such epoch."""
    out = {}
    for t in trials:
        for e in t["epochs"]:
            out.setdefault(f"{e['route']}-{e['window_length']}",
                           (t["config"], e["lambd_start"]))
    return out


def route_step_ms(seed: int, dev: torch.device, trials: list) -> dict:
    """:func:`step_ms` on each of :func:`route_starts`, on the first
    trial's first train batch."""
    out = {key: step_ms(seed, dev, config, trials[0]["batch"], lam)
           for key, (config, lam) in route_starts(trials).items()}
    say(f"step ms {trials[0]['config']['dataset_name']} "
        + json.dumps(out))
    return out


#: the JAX package's sweeps of the published spaces
#: (``results/<space>/<space>.csv``): each trial's est_lambd and test
#: accuracy, in trial order (lambda 0.2, 1 and 5 sigma_ref, or 10, 35
#: and 300 ms, trainable; then the same frozen)
JAX_SWEEPS = {
    "time_frequency": [
        (4.784862518310547, 0.981), (4.571234703063965, 0.986),
        (4.306341648101807, 0.979), (1.2760000228881836, 0.958),
        (6.380000114440918, 0.988), (31.899999618530277, 0.936)],
    "audio_mnist": [
        (33.1241455078125, 0.39666666666666667),
        (172.95263671875, 0.3785), (440.1481323242188, 0.35583333333333333),
        (13.333333015441896, 0.4088333333333333),
        (46.66666793823242, 0.39366666666666666), (400.0, 0.3875)],
    "esc50": [
        (19.647127151489254, 0.0), (41.03774642944336, 0.016666666666666666),
        (391.8238220214844, 0.016666666666666666), (13.333333015441896, 0.0),
        (46.66666793823242, 0.016666666666666666), (400.0, 0.0)],
}
#: the JAX time_frequency sweep's mean est_lambd over its three
#: trainable arms: the lambda a trainable arm must move toward
TF_LAMBD_TARGET = float(np.mean([lam for lam, _ in
                                 JAX_SWEEPS["time_frequency"][:3]]))


def _beside_jax(name: str, sweep: dict) -> list:
    """Each trial's lambda trajectory and test accuracy beside the JAX
    sweep's est_lambd and test accuracy for the same trial."""
    out = []
    for r, (jax_lam, jax_acc) in zip(sweep["trials"], JAX_SWEEPS[name]):
        out.append(dict(arm=r["arm"], lambd=r["lambd"],
                        test_accuracy=r["test_accuracy"],
                        jax_est_lambd=jax_lam, jax_test_accuracy=jax_acc))
        say(f"{name} {r['arm']}: lambda {r['init_lambd']:.4f} -> "
            f"{r['lambd'][-1]:.4f} (JAX {jax_lam:.4f}), test accuracy "
            f"{r['test_accuracy']:.4f} (JAX {jax_acc:.4f})")
    return out


def _tables(results_dir: str) -> str:
    from dmel_tpu_torch.eval import tables
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tables.main(["--results_dir", results_dir])
    say(buf.getvalue())
    return buf.getvalue()


def time_frequency_path(dev: torch.device, out: str) -> dict:
    """The published time_frequency space through the CLI (5000 clips of
    128 samples, linear_net on faithful DSPEC, SGD, batch 128, 6 trials
    of 30 epochs); then ``predict_test`` and Table 2.  No kernel
    launches (DSPEC is the exact route).  Gate: every trainable arm ends
    nearer the JAX sweep's mean est_lambd of its trainable arms than it
    started (lambda recovery); every frozen arm keeps its lambda."""
    res, trials = sweep_path(dev, out, "time_frequency", 30, n_test=1000)
    check(not any(res["launches"].values()),
          f"kernels launched on the DSPEC path: {res['launches']}")
    res["beside_jax"] = _beside_jax("time_frequency", res)
    res["lambd_target"] = TF_LAMBD_TARGET
    res["table"] = _tables(out)
    check("time-frequency" in res["table"], "no Table 2")
    for t in trials:
        lam0 = float(torch.tensor(float(t["config"]["init_lambd"])))
        lam1 = t["history"]["est_lambd"]
        if t["config"]["trainable"]:
            check(abs(lam1 - TF_LAMBD_TARGET) < abs(lam0 - TF_LAMBD_TARGET),
                  f"trainable arm {lam0}: {lam1} no nearer "
                  f"{TF_LAMBD_TARGET}")
        else:
            check(lam1 == lam0, f"frozen arm {lam0} moved to {lam1}")
    return res


def audio_mnist_path(seed: int, dev: torch.device, out: str) -> dict:
    """The published audio_mnist space on the full AudioMNIST fixture
    tree (60 speakers, 30000 wavs of 1500-7500 samples at 8 kHz, built
    in ``out``): 6 trials of mel_linear_net, batch 64, 2 epochs, through
    the CLI, launches counted by epoch against each epoch's route; then
    ``predict_test`` over the 6000 test clips, Table 1 and the ms per
    train step on each route the sweep took."""
    from tests import fixtures
    data = os.path.join(out, "audio_mnist_data")
    t0 = time.perf_counter()
    fixtures.make_audio_mnist_tree(data, min_len=1500, max_len=7500)
    build_s = time.perf_counter() - t0
    say(f"AudioMNIST fixture tree: 30000 wavs in {build_s:.1f} s")
    res, trials = sweep_path(dev, out, "audio_mnist", 2, data, n_test=6000)
    res["tree_build_s"] = build_s
    res["beside_jax"] = _beside_jax("audio_mnist", res)
    res["step_ms"] = route_step_ms(seed, dev, trials)
    res["table"] = _tables(out)
    check("AUDIO_MNIST" in res["table"], "no Table 1")
    res["prefetch"] = prefetch_path(seed, dev, trials[-1]["splits"])
    return res


def prefetch_path(seed: int, dev: torch.device, splits) -> dict:
    """One audio_mnist trial (the trainable 46.7 arm, 2 epochs) through
    ``fit``, then ``predict`` over its 6000 test clips, with the feed's
    ``prefetch`` at 0 (batches sliced and placed in the loop) and at 2
    (a background thread), run in the order 0, 2, 2, 0 on the sweep's
    loaded ``splits``: the seconds of each run, and every run's records,
    weights and test scores bit-identical."""
    from dmel_tpu_torch.experiments import configs
    config = next(c for c in configs.expand_grid(configs.audio_mnist(2))
                  if c["trainable"] and 40.0 < c["init_lambd"] < 50.0)
    trainset, validset, testset = splits
    runs = []
    for depth in (0, 2, 2, 0):
        cfg = dict(config, prefetch=depth)
        t0 = time.perf_counter()
        state, hist = fit(cfg, trainset, validset, seed=seed, device=dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, scores = predict(state["model"], testset.xs,
                            int(config["batch_size"]), device=dev,
                            prefetch=depth)
        predict_s = time.perf_counter() - t0
        runs.append(dict(prefetch=depth, fit_s=fit_s, predict_s=predict_s,
                         records=hist["records"], scores=scores,
                         weights={k: v.detach().cpu().clone() for k, v in
                                  state["model"].state_dict().items()}))
    ref = runs[0]
    identical = all(
        r["records"] == ref["records"]
        and np.array_equal(r["scores"], ref["scores"])
        and all(torch.equal(v, ref["weights"][k])
                for k, v in r["weights"].items()) for r in runs[1:])
    res = dict(init_lambd=config["init_lambd"],
               routes=[_route_of(config, lam)[0] for lam in
                       [config["init_lambd"]]
                       + [r["lambd_est"] for r in ref["records"][:-1]]],
               n_train=len(trainset), n_test=len(testset),
               runs=[{k: r[k] for k in ("prefetch", "fit_s", "predict_s")}
                     for r in runs], bit_identical=identical)
    say("prefetch 0 vs 2 " + json.dumps(res))
    check(identical, "prefetch 0 and 2 give different results")
    return res


def esc50_path(seed: int, dev: torch.device, out: str) -> dict:
    """The published esc50 space on a full-size ESC-50 fixture tree (50
    classes x 40 clips of 5 s at 44.1 kHz): 6 trials of bf16 CNN6, batch
    32, 2 epochs, through the CLI; the first trial resamples to 8 kHz
    and writes the cache, the others read it (``data_load_s``); then
    ``predict_test``, Table 1 and the ms per train step on each route."""
    import scipy
    from tests import fixtures
    data = os.path.join(out, "esc50_data")
    t0 = time.perf_counter()
    fixtures.make_esc50_tree(data, n_classes=50, per_class=40,
                             clip_seconds=5.0)
    build_s = time.perf_counter() - t0
    say(f"ESC-50 fixture tree: 2000 clips of 5 s in {build_s:.1f} s; "
        f"scipy {scipy.__version__}")
    res, trials = sweep_path(dev, out, "esc50", 2, data, n_test=400)
    res.update(tree_build_s=build_s, scipy=scipy.__version__,
               resample_s=res["data_load_s"][0],
               cache_hit_s=res["data_load_s"][1:])
    res["beside_jax"] = _beside_jax("esc50", res)
    res["step_ms"] = route_step_ms(seed, dev, trials)
    res["table"] = _tables(out)
    check("ESC50" in res["table"], "no Table 1")
    return res


def checkpoint_prediction(dev: torch.device, sweep_dir: str) -> dict:
    """Each sweep trial's checkpoint, restored at its sidecar's geometry
    into a state and run through ``training.predict``, against
    ``eval.predictions_by_row`` on the same row: the same argmax on every
    test clip."""
    from dmel_tpu_torch.data import BatchLoader
    from dmel_tpu_torch.eval.predict import _coerce, predictions_by_row
    from dmel_tpu_torch.experiments import runner
    from dmel_tpu_torch.training import load_checkpoint
    from dmel_tpu_torch.training import predict as predict_state
    rows = runner.load_results(sweep_dir)
    config0 = _coerce(runner.get_config_by_row(rows[0]))
    _, _, testset = get_dataset_by_config(config0)
    agree = []
    for row in rows:
        config = _coerce(runner.get_config_by_row(row))
        path = os.path.join(row["logdir"], "checkpoint_000000", "best_model")
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        model = get_model_by_config(config, meta["window_length"],
                                    meta["lambd_hint"], device=dev)
        model.load_state_dict(load_checkpoint(path)["model"])
        state = {"model": model, "window_length": meta["window_length"],
                 "lambd_hint": meta["lambd_hint"]}
        labels, preds = predict_state(config, state, testset, device=dev)
        labels2, preds2 = predictions_by_row(
            row, BatchLoader(testset, BATCH, shuffle=False), device=dev)
        check(np.array_equal(labels, labels2), "labels differ")
        agree.append(int((preds == preds2).sum()))
    res = dict(clips=len(testset), agree=agree)
    say("checkpoint prediction " + json.dumps(res))
    check(agree == [len(testset)] * len(rows),
          f"training.predict and predictions_by_row differ: {agree}")
    return res


class _Kill(Exception):
    pass


def resume_path(seed: int, dev: torch.device, out: str) -> dict:
    """A bf16 specband trial (lambda 128) of 3 epochs, uninterrupted;
    then killed after epoch 1's report and resumed by a second ``fit`` on
    the same checkpoint directory: the records, every weight and
    statistic and the optimizer state must equal the uninterrupted
    run's, bit for bit, and no live state may be left.  Times: each
    ``fit``, the checkpoint writes, and the overhead of the kill and
    resume over the uninterrupted run."""
    from dmel_tpu_torch.training import train as train_mod
    config = dict(TRAIN_CONFIG, model_dtype="bfloat16", max_epochs=3)
    trainset, validset, _ = get_dataset_by_config(config)
    writes = []
    real_save = train_mod.save_checkpoint

    def timed_save(path, state):
        t0 = time.perf_counter()
        real_save(path, state)
        writes.append((os.path.basename(path), time.perf_counter() - t0))

    def killer(record):
        if record["epoch"] == 1:
            raise _Kill

    def run(name, **kwargs):
        t0 = time.perf_counter()
        result = fit(config, trainset, validset, seed=seed, device=dev,
                     checkpoint_dir=os.path.join(out, name), **kwargs)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    train_mod.save_checkpoint = timed_save
    try:
        ((state_ref, hist_ref), ref_s), launches = counted(
            lambda: run("ref"))
        t0 = time.perf_counter()
        try:
            run("kill", report_fn=killer)
            check(False, "the killed fit did not raise")
        except _Kill:
            pass
        kill_s = time.perf_counter() - t0
        live = os.path.exists(os.path.join(out, "kill", "live_state"))
        (state, hist), resume_s = run("kill")
    finally:
        train_mod.save_checkpoint = real_save
    sd, sd_ref = state["model"].state_dict(), state_ref["model"].state_dict()
    opt = state["optimizer"].state_dict()["state"]
    opt_ref = state_ref["optimizer"].state_dict()["state"]
    res = dict(
        lambd=config["init_lambd"], epochs=config["max_epochs"],
        routes=[_route_of(config, lam)[0] for lam in
                [config["init_lambd"]]
                + [r["lambd_est"] for r in hist_ref["records"][:-1]]],
        live_state_after_kill=live,
        records_equal=(hist["records"] == hist_ref["records"]
                       and {k: v for k, v in hist.items()
                            if k != "init_lambd"}
                       == {k: v for k, v in hist_ref.items()
                           if k != "init_lambd"}),
        init_lambd_resumed=hist["init_lambd"],
        weights_equal=all(torch.equal(v, sd_ref[k]) for k, v in sd.items()),
        optimizer_equal=all(torch.equal(v, opt_ref[i][k])
                            for i, st in opt.items() for k, v in st.items()),
        live_state_left=[n for n in ("ref", "kill") if os.path.exists(
            os.path.join(out, n, "live_state"))],
        uninterrupted_s=ref_s, killed_s=kill_s, resumed_s=resume_s,
        overhead_s=kill_s + resume_s - ref_s,
        checkpoint_writes={n: [sum(s for m, s in writes if m == n),
                               sum(m == n for m, _ in writes)]
                           for n in ("best_model", "live_state")},
        launches=launches)
    say("resume " + json.dumps(res))
    check(live, "no live state after the kill")
    check(res["records_equal"], "resumed records differ")
    check(hist["init_lambd"] == hist_ref["records"][0]["lambd_est"],
          "the resumed trial's init_lambd is not the lambda it resumed at")
    check(res["weights_equal"], "resumed weights differ")
    check(res["optimizer_equal"], "resumed optimizer state differs")
    check(not res["live_state_left"], "a live state was left")
    return res


#: FSD50K as it ships: 200 classes, the dev clips split 5:1 into train
#: and val by the ground truth's split column, the eval clips the test set
FSD_DEV, FSD_EVAL, FSD_SR = 2400, 400, 44100
#: dmel_tpu's import of the PANNs Cnn6 stand-in (tests/fixtures.py):
#: (imported, skipped), as tests/test_torch_pretrained.py holds the port
PANNS_IMPORT_COUNTS = (22, 9)
#: one augmented train step's dlambda, kernels against the plain chain,
#: each through its own CNN6 backward: bench.py's dlambda gate.  The
#: routes' features differ by ~1e-6, CNN6's backward turns that into a
#: larger difference in dL/ds, and with the masks more of it reaches
#: dlambda, a small sum with heavy cancellation: on the H100 the chain
#: differed by 5.0e-3 where the kernels on one dL/ds agreed to 4.1e-7
#: (the "augment" line).  The kernels alone are held at TRAIN_GRAD_GATE
#: on one dL/ds.
AUGMENT_CHAIN_GATE = GRAD_GATE
#: Cnn14's bf16 eval scores against float32, max-abs
CNN14_BF16_GATE = 2e-2
#: the frames of a 5 s clip at hop 80 (the esc50/fsd geometry)
FRAMES = T // HOP + 1
#: a running variance against 0.9 old + 0.1 the biased batch variance
BN_VAR_GATE = 1e-5


def augment_step_ms(seed: int, dev: torch.device, trials: list) -> dict:
    """:func:`step_ms` with SpecAugment (the trials' config) and without
    it, in turns (off, on, on, off), on each of :func:`route_starts`, on
    the first trial's first train batch: the mean of each side's two
    runs, and each run's steady ms."""
    out = {}
    names = ((True, "augmented"), (False, "plain"))
    for key, (config, lam) in route_starts(trials).items():
        runs = {False: [], True: []}
        for aug in (False, True, True, False):
            runs[aug].append(step_ms(seed, dev, dict(config, augment=aug),
                                     trials[0]["batch"], lam))
        out[key] = {f"{name}_{k}": float(np.mean([r[k] for r in runs[aug]]))
                    for aug, name in names
                    for k in ("first_ms_per_step", "steady_ms_per_step")}
        out[key]["steady_ms_each"] = {
            name: [r["steady_ms_per_step"] for r in runs[aug]]
            for aug, name in names}
    say("augmented step ms " + json.dumps(out))
    return out


def fsd_path(seed: int, dev: torch.device, out: str) -> dict:
    """The published fsd space on an FSD50K fixture tree in its official
    layout (200 classes; 2400 dev clips, 2000 train and 400 val by the
    split column; 400 eval clips; 0.5-2 s at 44.1 kHz; built in
    ``out``): 6 trials of bf16 CNN6 with SpecAugment, multi-label BCE,
    batch 32, 2 epochs, through the CLI; the first trial resamples to 8
    kHz and writes the cache, the others read it (``data_load_s``); then
    ``predict_test`` (``test_mAP`` in [0, 1] on every trial), and the
    ms of a train step with and without SpecAugment on each route the
    sweep took."""
    import scipy
    from tests import fixtures
    data = os.path.join(out, "fsd_data")
    t0 = time.perf_counter()
    fixtures.make_fsd50k_tree(data, n_classes=200, n_dev=FSD_DEV,
                              n_eval=FSD_EVAL, sr=FSD_SR)
    build_s = time.perf_counter() - t0
    say(f"FSD50K fixture tree: {FSD_DEV} dev and {FSD_EVAL} eval clips in "
        f"{build_s:.1f} s; scipy {scipy.__version__}")
    res, trials = sweep_path(dev, out, "fsd", 2, data, n_test=FSD_EVAL)
    res.update(tree_build_s=build_s, resample_s=res["data_load_s"][0],
               cache_hit_s=res["data_load_s"][1:])
    maps = [r.get("test_mAP") for r in res["trials"]]
    check(all(isinstance(m, float) and 0.0 <= m <= 1.0 for m in maps),
          f"test_mAP {maps}")
    check([(t["n_train"], t["n_valid"]) for t in trials]
          == [(FSD_DEV - FSD_EVAL, FSD_EVAL)] * 6,
          "the dev split is not 2000 train / 400 val")
    check(all(t["config"]["augment"] for t in trials), "augment is off")
    res["step_ms"] = augment_step_ms(seed, dev, trials)
    return res


def augment_path(seed: int, dev: torch.device) -> dict:
    """SpecAugment on the card, in float32 at lambda 128 (specband) on
    esc50_synth: two train steps of fresh models from one seed, with
    SpecAugment, bit-identical in loss and every weight after the step;
    dlambda through the kernels (K1, K2) against the plain specband
    function for one dL/ds (CNN6's, with the masks and dropout, from the
    kernels' features), within ``TRAIN_GRAD_GATE``; the whole chain's
    gradients of lambda and fc_esc50.weight, kernels against plain from
    the same generator state (``train_grad_check``, dlambda within
    ``AUGMENT_CHAIN_GATE``); and on a ones batch of 256 x 501 frames x
    64 mels the masks drawn on the card equal ``mask_span`` on the CPU
    from the same uniforms, each clip's zeroed frames and mels one
    contiguous span of at most 64 and 8."""
    from dmel_tpu_torch.models import panns
    config = dict(TRAIN_CONFIG, augment=True)
    trainset, _, _ = get_dataset_by_config(config)
    route, wl, hint, j = _route_of(config, 128.0)
    xs, ys, mask = _batch(trainset, dev)

    def one_step():
        model = get_model_by_config(config, window_length=wl,
                                    lambd_hint=hint, device=dev, seed=seed)
        opt = build_optimizer(config, model)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with precision_scope():
            m = train_step(model, opt, xs, ys, mask, one_hot=True,
                           n_classes=10, generator=gen)
        return m["loss"], model.state_dict()

    (loss_a, sd_a), (loss_b, sd_b) = one_step(), one_step()
    res = dict(route=route, window_length=wl,
               step_bit_identical=bool(torch.equal(loss_a, loss_b)) and all(
                   torch.equal(v, sd_b[k]) for k, v in sd_a.items()))

    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=dev, seed=seed).train()
    lam = model.spectrogram_layer.lambd
    with precision_scope():
        s_k = model.features(xs)
        s_p = _plain_features(model, xs, wl, j, route)
        s = s_k.detach().requires_grad_()
        out = model.spectrogram_model(
            s.transpose(2, 3), torch.Generator(device=dev).manual_seed(seed))
        g, = torch.autograd.grad(
            bce_loss(out, F.one_hot(ys.long(), 10).to(out.dtype), mask), [s])
        d_k, = torch.autograd.grad(s_k, [lam], g)
        d_p, = torch.autograd.grad(s_p, [lam], g)
    res.update(dlambd_one_grad_kernel=d_k.item(),
               dlambd_one_grad_plain=d_p.item(),
               dlambd_one_grad_rel_err=abs((d_k - d_p).item()
                                           / d_p.item()))
    check(res["dlambd_one_grad_rel_err"] <= TRAIN_GRAD_GATE,
          f"augmented dlambda, one dL/ds: "
          f"{res['dlambd_one_grad_rel_err']:.3e}")
    res.update(train_grad_check(seed, dev, config, trainset, wl, hint, j,
                                route, dlambd_gate=AUGMENT_CHAIN_GATE))

    gen = torch.Generator(device=dev).manual_seed(seed)
    ones = torch.ones(256, 1, FRAMES, N_MELS, device=dev)
    state = gen.get_state()
    masked = {"time": panns.time_mask(ones, 64, gen),
              "freq": panns.freq_mask(ones, 8, gen)}
    gen.set_state(state)
    u = [torch.rand((2, 256), generator=gen, device=dev).cpu()
         for _ in range(2)]
    spans = {}
    for (name, m), dim, param, uu in zip(masked.items(), (2, 3), (64, 8), u):
        cpu = panns.mask_span(ones.cpu(), dim, param, uu[0], uu[1])
        check(torch.equal(m.cpu(), cpu), f"{name} mask differs from the CPU")
        zero = (m[:, 0] == 0)
        along = zero.all(dim=2) if dim == 2 else zero.all(dim=1)  # (B, L)
        count = along.sum(dim=1)
        idx = torch.arange(along.shape[1], device=dev)
        first = torch.where(along, idx, along.shape[1]).min(dim=1).values
        last = torch.where(along, idx, -1).max(dim=1).values
        contiguous = bool(((count == 0) | (last - first + 1 == count)).all())
        whole = bool((zero.sum(dim=(1, 2))
                      == count * (zero.shape[1] * zero.shape[2]
                                  // along.shape[1])).all())
        spans[name] = dict(max_width=int(count.max()),
                           mean_width=float(count.float().mean()),
                           contiguous=contiguous, whole_rows=whole)
        check(int(count.max()) <= param and contiguous and whole,
              f"{name} mask spans {spans[name]}")
    res["mask_spans"] = spans
    say("augment " + json.dumps(res))
    check(res["step_bit_identical"], "two seeded augmented steps differ")
    return res


def pretrained_path(seed: int, dev: torch.device, out: str,
                    data_dir: str) -> dict:
    """One fsd trial (lambda 400, trainable, 2 epochs) with
    ``pretrained=True`` and ``checkpoint_path`` at the PANNs Cnn6
    stand-in (``tests/fixtures.py:make_fake_cnn6_checkpoint``), through
    ``run_trial``: when ``fit`` has imported it, before the first step,
    every tensor the import maps must lie on the card equal to the
    checkpoint's, bit for bit, and the counts be dmel_tpu's; then the
    trial runs, its launches counted."""
    from dmel_tpu_torch.experiments import configs, runner
    from dmel_tpu_torch.training import train as train_mod
    from tests import fixtures
    path = fixtures.make_fake_cnn6_checkpoint(
        os.path.join(out, "weights", "Cnn6_mAP=0.343.pth"))
    config = next(c for c in configs.expand_grid(configs.fsd(2))
                  if c["trainable"] and c["init_lambd"] > 300.0)
    config.update(pretrained=True, checkpoint_path=path)
    seen = {}
    real = train_mod.import_panns_cnn6

    def checked_import(sd, model, verbose=False):
        counts = real(sd, model, verbose)
        state = model.state_dict()
        equal, devices = [], set()
        for key, t in sd.items():
            target = state.get(f"spectrogram_model.{key}")
            if (target is not None and target.shape == t.shape
                    and not key.endswith("num_batches_tracked")):
                equal.append(torch.equal(target.cpu(), t))
                devices.add(target.device.type)
        seen.update(counts=list(counts), mapped=len(equal),
                    bit_equal=all(equal), devices=sorted(devices))
        return counts

    train_mod.import_panns_cnn6 = checked_import
    try:
        t0 = time.perf_counter()
        (_, history), launches = counted(lambda: runner.run_trial(
            config, data_dir, os.path.join(out, "pretrained_trial"),
            seed=seed, device=dev))
        torch.cuda.synchronize()
        trial_s = time.perf_counter() - t0
    finally:
        train_mod.import_panns_cnn6 = real
    records = history["records"]
    res = dict(init_lambd=config["init_lambd"], **seen, trial_s=trial_s,
               lambd=[r["lambd_est"] for r in records],
               loss=[r["loss"] for r in records], launches=launches)
    say("pretrained " + json.dumps(res))
    check(seen.get("counts") == list(PANNS_IMPORT_COUNTS),
          f"import counts {seen.get('counts')}")
    check(seen["bit_equal"] and seen["devices"] == [dev.type]
          and seen["mapped"] == PANNS_IMPORT_COUNTS[0],
          f"imported tensors {seen}")
    check(len(records) == 2 and all(math.isfinite(r["loss"])
                                    for r in records), "the trial failed")
    return res


def cnn14_path(seed: int, dev: torch.device) -> dict:
    """PANNs Cnn14 with an AttBlock (527 classes, sigmoid) on its frames
    at full width, B 32 x 501 frames x 64 mels (the esc50/fsd geometry),
    from a seeded init: the eval forward and one Adam train step (BCE on
    both heads' scores against random multi-hot labels), first and
    steady ms, in float32 and with the conv stack in bf16; gates: the
    float32 eval scores of both heads on 4 clips within 1e-4 of the
    CPU's on the same weights, the bf16 eval scores within
    ``CNN14_BF16_GATE`` of float32's."""
    from dmel_tpu_torch.models import AttBlock, Cnn14
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, 1, FRAMES, N_MELS, generator=gen).to(dev)
    labels = (torch.rand(BATCH, 527, generator=gen) < 0.01).float().to(dev)
    nets = {}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        cnn = Cnn14(527, N_MELS, generator=torch.Generator().manual_seed(
            seed), dtype=dtype)
        att = AttBlock(2048, 527, activation="sigmoid",
                       generator=torch.Generator().manual_seed(seed + 1))
        nets[name] = (cnn.to(dev), att.to(dev))

    def forward(cnn, att, xb, gen=None):
        frames = cnn.frames(xb, gen)
        return cnn(xb, gen), att(frames)[0]

    res = {}
    with precision_scope():
        for name, (cnn, att) in nets.items():
            cnn.eval(), att.eval()
            with torch.no_grad():
                fwd = timing(lambda: forward(cnn, att, x), iters=3,
                             warmup=1, reps=3)
                scores = forward(cnn, att, x[:4])
            opt = torch.optim.Adam(list(cnn.parameters())
                                   + list(att.parameters()), lr=1e-4)
            gstep = torch.Generator(device=dev).manual_seed(seed)

            def step():
                cnn.train(), att.train()
                opt.zero_grad(set_to_none=True)
                clip, attn = forward(cnn, att, x, gstep)
                loss = (F.binary_cross_entropy(clip, labels)
                        + F.binary_cross_entropy(attn, labels))
                loss.backward()
                opt.step()
                return loss

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step()
            torch.cuda.synchronize()
            steady = (time.perf_counter() - t0) * 1e3 / 5
            res[name] = dict(forward_ms=fwd["ms"],
                             forward_ms_range=fwd["range"],
                             forward_ms_enqueue=fwd["enqueue_ms"],
                             train_first_ms=first, train_steady_ms=steady,
                             loss=float(loss.detach()),
                             scores=[s.float().cpu() for s in scores])
            check(math.isfinite(res[name]["loss"]), f"Cnn14 {name} loss")
    # the CPU reference: the float32 nets' weights before training, as
    # the eval scores were taken
    cpu_cnn = Cnn14(527, N_MELS, generator=torch.Generator().manual_seed(
        seed)).eval()
    cpu_att = AttBlock(2048, 527, activation="sigmoid",
                       generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        want = forward(cpu_cnn, cpu_att.eval(), x[:4].cpu())
    f32, b16 = res["float32"].pop("scores"), res["bfloat16"].pop("scores")
    res["cpu_err"] = max(float((g - w).abs().max()) for g, w in zip(f32,
                                                                    want))
    res["bf16_err"] = max(float((g - w).abs().max()) for g, w in zip(b16,
                                                                     f32))
    res["params"] = sum(p.numel() for p in nets["float32"][0].parameters())
    say("Cnn14 " + json.dumps(res))
    check(res["cpu_err"] <= GATE, f"Cnn14 card vs CPU {res['cpu_err']:.3e}")
    check(res["bf16_err"] <= CNN14_BF16_GATE,
          f"Cnn14 bf16 vs float32 {res['bf16_err']:.3e}")
    return res


def bn_variance_path(seed: int, dev: torch.device) -> dict:
    """CNN6's repaired batch norm on the card: after one train step at
    lambda 128 (specband) in float32 and in bf16, every running variance
    (the mel batch norm and each block's) must equal 0.9 old + 0.1 the
    biased float32 variance of the batch norm's input, taken by a plain
    reduction on the card, within ``BN_VAR_GATE`` of the largest."""
    from dmel_tpu_torch.models.panns import (BiasedBatchNorm1d,
                                             BiasedBatchNorm2d)
    trainset, _, _ = get_dataset_by_config(TRAIN_CONFIG)
    _, wl, hint, _ = _route_of(TRAIN_CONFIG, 128.0)
    xs, ys, mask = _batch(trainset, dev)
    res = {}
    for dtype in ("float32", "bfloat16"):
        config = dict(TRAIN_CONFIG, model_dtype=dtype)
        model = get_model_by_config(config, window_length=wl,
                                    lambd_hint=hint, device=dev, seed=seed)
        opt = build_optimizer(config, model)
        want, hooks = {}, []
        for name, mod in model.named_modules():
            if isinstance(mod, (BiasedBatchNorm1d, BiasedBatchNorm2d)):
                def hook(m, args, name=name):
                    x = args[0].detach().float()
                    dims = [0] + list(range(2, x.dim()))
                    want[name] = (0.9 * m.running_var
                                  + 0.1 * x.var(dims, unbiased=False))
                hooks.append(mod.register_forward_pre_hook(hook))
        with precision_scope():
            train_step(model, opt, xs, ys, mask, one_hot=True, n_classes=10,
                       generator=torch.Generator(device=dev).manual_seed(
                           seed))
        for h in hooks:
            h.remove()
        sd = model.state_dict()
        errs = {name: float((sd[f"{name}.running_var"] - w).abs().max()
                            / w.abs().max()) for name, w in want.items()}
        res[dtype] = errs
        check(len(errs) == 5, f"{len(errs)} batch norms ran")
        check(max(errs.values()) <= BN_VAR_GATE,
              f"{dtype} running variance {errs}")
    say("batch-norm variance " + json.dumps(res))
    return res


# --- data parallelism ---------------------------------------------------

#: the data-parallel phase's training: the flagship train path (esc50_synth
#: CNN6 at full width, lambda 128: specband at 1024, J 24), float32, one
#: epoch; global batch 32, 16 rows a rank on two ranks
DP_CONFIG = dict(TRAIN_CONFIG, max_epochs=1)
#: the esc50_synth grid the pack runs on one card and over the ranks, in
#: float32 (the space's own dtype is bf16)
DP_SPACE_OVERRIDE = {"model_dtype": "float32"}
DP_RANKS = 2
#: data parallel against one process, float32, after two steps: lambda
#: relative, batch-norm buffers and parameters max-abs (dmel_tpu's
#: ``tests/test_parallel.py`` gate)
DP_GATE = 1e-4
#: the same after a whole epoch (11 Adam steps, lr_tf 1.0) and for the
#: pack's trials, relative: there one process's float32 run differs from
#: itself under a mere change of summation order by about 1e-4-1e-3 (on
#: the CPU at 1 and 8 threads, lambda 3.3e-4 and the loss 1.3e-4; on the
#: card the control ``fit`` with cuDNN off, which must read under this
#: gate too), so 1e-4 there would test the rounding, not the port.  Set
#: a little over the largest sound reading on an H100 (a split trial's
#: loss, 1.3e-3)
DP_EPOCH_GATE = 3e-3
#: Adam's exception to that gate after two steps: a gradient entry near 0
#: takes the sign of its rounding, and Adam moves it by about lr a step
#: whatever its size, so one process and two ranks summing in another
#: order can part by 2 lr a step.  Such entries may exceed DP_GATE up to
#: that bound, in at most this share of all entries (on an H100: 186-188
#: of 4.57 million, at most 2.2e-4)
ADAM_FLIP_SHARE = 1e-4
#: the two ranks' seconds, the model build and the data included
DP_TIMEOUT_S = 420


def _counter_spec() -> dict:
    """:data:`COUNTERS` as the dry run's jobs name them."""
    return {k: [obj.__module__, obj.__qualname__, attr]
            for k, (obj, attr) in COUNTERS.items()}


def _two_steps_errors(got: dict, want: dict) -> dict:
    """After two steps: lambda's relative difference, the batch-norm
    buffers' and the other parameters' largest difference, and the
    parameter entries beyond :data:`DP_GATE`."""
    out = dict(lambd=0.0, buffers=0.0, params=0.0, over=0, entries=0)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (got[k].double() - w.double()).abs()
        leaf = k.rpartition(".")[2]
        if leaf == "lambd":
            out["lambd"] = float((d / w.double().abs()).max())
        elif leaf.startswith("running_"):
            out["buffers"] = max(out["buffers"], float(d.max()))
        else:
            out["params"] = max(out["params"], float(d.max()))
            out["over"] += int((d > DP_GATE).sum())
            out["entries"] += d.numel()
    return out


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max())
               for k in b if k.rpartition(".")[2] != "num_batches_tracked")


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _ms(step_ms: list) -> dict:
    return dict(first=step_ms[0], steady=float(np.median(step_ms[1:])))


def data_parallel_path(seed: int, dev: torch.device, out: str,
                       smi: str) -> dict:
    """``fit``, ``fit_trials`` and ``run_sweep_packed`` over a mesh, held
    against one process: a one-rank NCCL mesh in this process, bit for
    bit; two gloo ranks sharing the card (``dmel_tpu_torch.parallel
    .dryrun``'s launcher), within :data:`DP_GATE` after two steps and
    :data:`DP_EPOCH_GATE` after the epoch, bit-identical to each other,
    each launching K1 and K2 as its route says; the esc50_synth grid
    split over the two ranks (three trials each, packed K5) against the
    pack on one card; two ranks over NCCL where there are two cards."""
    import torch.distributed as dist

    from dmel_tpu_torch.eval import predict_test
    from dmel_tpu_torch.experiments import runner
    from dmel_tpu_torch.experiments.configs import get_search_space
    from dmel_tpu_torch.parallel import dryrun, mesh as pmesh

    config = DP_CONFIG
    trainset, validset, _ = get_dataset_by_config(config)
    steps = -(-len(trainset) // BATCH)
    valid_batches = -(-len(validset) // BATCH)

    # 1. a one-rank NCCL mesh against the same fit without one
    (state0, hist0), launches0 = counted(lambda: fit(
        config, trainset, validset, seed=seed, device=dev))
    pmesh.initialize_distributed(f"127.0.0.1:{dryrun.free_port()}", 1, 0,
                                 backend="nccl")
    try:
        mesh1 = pmesh.make_mesh()
        (state1, hist1), launches1 = counted(lambda: fit(
            config, trainset, validset, seed=seed, mesh=mesh1))
    finally:
        dist.destroy_process_group()
    sd0, sd1 = state0["model"].state_dict(), state1["model"].state_dict()
    nccl_identical = (hist0["records"] == hist1["records"]
                      and all(torch.equal(v, sd1[k]) for k, v in sd0.items()))
    check(nccl_identical, "the one-rank NCCL fit differs from fit alone")
    check(launches1 == launches0, f"NCCL launches {launches1} != {launches0}")
    # the one process against itself in another summation order: the
    # card's float32 floor for the epoch's gates
    with torch.backends.cudnn.flags(enabled=False):
        _, hist_ctl = fit(config, trainset, validset, seed=seed, device=dev)

    # the single process's first steps, its bf16 fit and its pack
    one = pmesh.make_mesh(devices=dev)               # no process group
    steps_spec = dict(job="steps", name="dp_steps", config=config,
                      seed=seed, n_steps=6, snapshot=2)
    single_steps, single_snap = dryrun.run_steps(steps_spec, one)
    bf16 = dict(config, model_dtype="bfloat16", max_epochs=2)
    _, hist_bf16 = fit(bf16, trainset, validset, seed=seed, device=dev)
    space = dict(get_search_space(SWEEP_NAME, 1), **DP_SPACE_OVERRIDE)
    t0 = time.perf_counter()
    one_dir, one_launches = counted(lambda: runner.run_sweep_packed(
        SWEEP_NAME, 1, 1, os.path.join(out, "dp_one"), out, space=space,
        device=dev))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0

    # 2./3. two gloo ranks on the one card
    counters = _counter_spec()
    jobs = [steps_spec,
            dict(job="fit", name="dp_fit", config=config, seed=seed,
                 counters=counters),
            dict(job="fit", name="dp_fit_bf16", config=bf16, seed=seed),
            dict(job="sweep", name="dp_sweep", space_name=SWEEP_NAME,
                 max_epochs=1, output_dir=os.path.join(out, "dp_two"),
                 data_dir=out, override=DP_SPACE_OVERRIDE,
                 counters=counters)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dryrun.launch(DP_RANKS, "cuda", "gloo", jobs, out=out,
                          timeout=DP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0

    def agree(name):
        """The ranks' result of ``name`` (their times aside), which must be
        the same on every rank."""
        got = [{k: v for k, v in r[name].items()
                if k not in ("fit_s", "step_ms", "sweep_s", "launches")}
               for r in ranks]
        check(all(g == got[0] for g in got[1:]),
              f"the ranks differ in {name}: {got}")
        return ranks[0][name]

    snap = torch.load(os.path.join(out, "dp_steps.pt"), weights_only=True)
    two_steps_err = _two_steps_errors(snap["state"], single_snap["state"])
    agree("dp_steps")
    fit2 = agree("dp_fit")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss_err = max(rel(r["loss"], w["loss"]) for r, w in
                   zip(fit2["records"], hist0["records"]))
    ctl_loss_err = max(rel(r["loss"], w["loss"]) for r, w in
                       zip(hist_ctl["records"], hist0["records"]))
    ctl_lam_err = rel(hist_ctl["est_lambd"], hist0["est_lambd"])
    lam_err = rel(fit2["est_lambd"], hist0["est_lambd"])
    fit_sd = torch.load(os.path.join(out, "dp_fit.pt"),
                        weights_only=True)["model"]
    epoch_err = _max_abs(fit_sd, sd0)
    rank_epochs = []
    for r in ranks:
        ep = epoch_launches(config, config["init_lambd"],
                            r["dp_fit"]["records"], r["dp_fit"]["launches"],
                            steps, valid_batches)
        check_epochs(ep)
        check(ep[0]["route"] == "specband", f"route {ep[0]['route']}")
        rank_epochs.append(ep)
    bf = agree("dp_fit_bf16")
    bf16_lam_err = rel(bf["est_lambd"], hist_bf16["est_lambd"])
    bf16_loss_err = max(rel(r["loss"], w["loss"]) for r, w in
                        zip(bf["records"], hist_bf16["records"]))

    sweep = agree("dp_sweep")
    two_dir = sweep["sweep_dir"]
    trial_loss_err = []
    for i in range(6):
        got, want = (json.load(open(os.path.join(
            d, f"trial_{i:05d}", "result.json"))) for d in (two_dir, one_dir))
        trial_loss_err.append(rel(got["loss"], want["loss"]))
    files_equal = _files(two_dir) == _files(one_dir)
    scored = predict_test(two_dir, out, verbose=0)
    for r in ranks:
        check(r["dp_sweep"]["launches"] == one_launches,
              f"a rank's pack launches {r['dp_sweep']['launches']}, the "
              f"card's pack {one_launches}")

    res = dict(
        card=smi, note="two gloo ranks shared one card: no scaling claim",
        nccl_one_rank_bit_identical=nccl_identical,
        single_step_ms=_ms(single_steps["step_ms"]),
        rank_step_ms=[_ms(r["dp_steps"]["step_ms"]) for r in ranks],
        two_steps_err=two_steps_err,
        epoch_loss_rel_err=loss_err, lambd_rel_err=lam_err,
        control_cudnn_off_loss_rel_err=ctl_loss_err,
        control_cudnn_off_lambd_rel_err=ctl_lam_err,
        epoch_params_max_abs_err=epoch_err,
        lambd=[fit2["est_lambd"], hist0["est_lambd"]],
        rank_fit_s=[r["dp_fit"]["fit_s"] for r in ranks],
        rank_epochs=[[dict(route=e["route"], launches={
            k: v for k, v in e["launches"].items() if v}) for e in ep]
            for ep in rank_epochs],
        bf16_lambd_rel_err=bf16_lam_err, bf16_loss_rel_err=bf16_loss_err,
        pack_trial_loss_rel_err=trial_loss_err,
        pack_files_equal=files_equal,
        pack_one_card_s=one_s,
        rank_sweep_s=[r["dp_sweep"]["sweep_s"] for r in ranks],
        rank_pack_launches=[{k: v for k, v in r["dp_sweep"]["launches"]
                             .items() if v} for r in ranks],
        pack_test_accuracy=[s.get("test_accuracy") for s in scored],
        ranks_s=ranks_s)

    # 4. two ranks over NCCL, one card each, where the machine has two
    if torch.cuda.device_count() >= DP_RANKS:
        nccl = dryrun.launch(DP_RANKS, "cuda", "nccl", jobs[1:2], out=out,
                             timeout=DP_TIMEOUT_S)
        got = [r["dp_fit"]["digest"] for r in nccl]
        check(len(set(got)) == 1, "the NCCL ranks differ")
        res["nccl_two_ranks_loss_rel_err"] = max(
            rel(r["loss"], w["loss"]) for r, w in
            zip(nccl[0]["dp_fit"]["records"], hist0["records"]))
    else:
        say(f"data parallel: two NCCL ranks not run: "
            f"{torch.cuda.device_count()} CUDA device(s), NCCL needs one "
            f"a rank (the two-rank runs above used gloo on one card)")
    say("data parallel " + json.dumps(res))
    for r, ms in zip(range(DP_RANKS), res["rank_step_ms"]):
        say(f"data parallel step ms: rank {r} of {DP_RANKS} (gloo, sharing "
            f"one card) first {ms['first']:.3f} steady {ms['steady']:.3f}; "
            f"one process first {res['single_step_ms']['first']:.3f} steady "
            f"{res['single_step_ms']['steady']:.3f}; {smi}")
    flip_bound = 2 * 2 * config["lr_model"]
    check(two_steps_err["lambd"] <= DP_GATE
          and two_steps_err["buffers"] <= DP_GATE
          and two_steps_err["params"] <= flip_bound
          and two_steps_err["over"] <= ADAM_FLIP_SHARE
          * two_steps_err["entries"],
          f"after two steps: {two_steps_err}")
    check(loss_err <= DP_EPOCH_GATE, f"epoch loss differs by {loss_err}")
    check(lam_err <= DP_EPOCH_GATE, f"lambda differs by {lam_err}")
    check(max(ctl_loss_err, ctl_lam_err) <= DP_EPOCH_GATE,
          f"the cuDNN-off control reads loss {ctl_loss_err}, lambda "
          f"{ctl_lam_err}: the float32 floor is over the epoch gate")
    check(bf16_lam_err <= BF16_DLAMBD_GATE and
          bf16_loss_err <= BF16_DLAMBD_GATE,
          f"bf16: lambda {bf16_lam_err}, loss {bf16_loss_err}")
    check(max(trial_loss_err) <= DP_EPOCH_GATE,
          f"pack trial losses differ by {trial_loss_err}")
    check(res["pack_files_equal"], "the two-rank sweep's files differ")
    check(len(scored) == 6 and all(
        0.0 <= s["test_accuracy"] <= 1.0 for s in scored),
        f"predict_test {res['pack_test_accuracy']}")
    res["launches"] = {k: launches1[k] + sum(
        r["dp_fit"]["launches"][-1][k] + r["dp_sweep"]["launches"][k]
        for r in ranks) for k in COUNTERS}
    return res


# --- packs of trials ----------------------------------------------------

#: the published grid's lambdas (esc50_synth, fsd): the pack's trials
PACK_LAMS = (13.33, 46.67, 400.0, 13.33, 46.67, 400.0)
#: six trainable lambdas in the specband region of bucket 1024 that
#: takes J 24 (lambda in (n_fft / 9.6, n_fft / 8]), so one hint serves all
PACK_SPECBAND_LAMS = (110.0, 113.6, 117.2, 120.8, 124.4, 128.0)


def _pack_signal(seed: int, k: int, batch: int, t: int, dev):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (k * batch, t)).astype(np.float32)).to(dev)
    return x - x.mean(dim=-1, keepdim=True)


def _per_trial(k: int, batch: int, *tensors):
    """Each trial's rows of every tensor, contiguous."""
    return [[t[i * batch:(i + 1) * batch].contiguous() for t in tensors]
            for i in range(k)]


def packed_fused_case(seed: int, dev: torch.device, k: int = 6,
                      batch: int = BATCH, n_fft: int = 4096,
                      lams=PACK_LAMS, t: int = T) -> dict:
    """K5 and K6 on a pack of ``k`` trials of ``batch`` clips (the
    esc50_synth grid's pack at 4096): one launch each; trial i's forward
    bit for bit the single launch's on its rows and window, its dw within
    1e-6 of the largest entry; against the plain packed versions (the
    plain function on each trial): log-mel 1e-4, dw 1e-3 of the largest;
    dlambda (k,) through K5 + K6 and through K5 + the torch adjoint
    against autograd of the plain chain, 1e-2 each.  Times: each packed
    entry, the k single launches, its plain version, its bound (k times
    the single one) and the packed exact route (frames, windows, rfft,
    mel) as the yardstick."""
    g = framed.Geom(n_fft, HOP, N_MELS, SR, 0.0, float(SR // 2))
    x = _pack_signal(seed, k, batch, t, dev)
    lam = torch.tensor(lams[:k], device=dev)
    w = gaussian_window(lam, n_fft).contiguous()
    fb_nnz = int((framed._fb(g, dev) != 0).sum())
    with torch.no_grad():
        out, reim = fused.fused_fwd_packed(x, w, g)
        dmel = torch.from_numpy(np.random.default_rng(seed + 1)
                                .standard_normal(tuple(out.shape))
                                .astype(np.float32)).to(dev)
        dw = fused.fused_dwindow_packed(x, reim, dmel, g, k)
        singles = _per_trial(k, batch, x, dmel)
        fwd_bits, dw_rel_single, reims = True, 0.0, []
        for i, (xi, di) in enumerate(singles):
            o1, r1 = fused.fused_fwd(xi, w[i].contiguous(), g)
            reims.append(r1)
            fwd_bits &= bool(torch.equal(out[i * batch:(i + 1) * batch], o1)
                             and torch.equal(reim.chunk(k)[i], r1))
            dw_rel_single = max(dw_rel_single, rel_err(
                dw[i], fused.fused_dwindow(xi, r1, di, g)))
        p_out, p_reim = framed._looped_fwd(framed.fwd_plain, x, w, g)
        p_dw = framed.framed_dwindow_plain_packed(x, p_reim, dmel, g, k)
        logmel_err = float((torch.log(out + LOG_EPS)
                            - torch.log(p_out + LOG_EPS)).abs().max())
        dw_err = max(rel_err(dw[i], p_dw[i]) for i in range(k))
        del p_out, p_reim, p_dw
        fwd_t = timed("ms", lambda: fused.fused_fwd_packed(x, w, g))
        fwd_single = time_ms(lambda: [fused.fused_fwd(xi, w[i].contiguous(),
                                                      g)
                                      for i, (xi, _) in enumerate(singles)])
        fwd_plain = plain_time_ms(lambda: framed._looped_fwd(
            framed.fwd_plain, x, w, g))
        fb = melscale_fbanks(n_fft // 2 + 1, 0.0, float(SR // 2), N_MELS, SR
                             ).to(dev)
        lib_fwd = timed("library_ms", lambda: (stft.stft_power_packed(
            x.reshape(k, batch, t), w, n_fft, HOP).transpose(-1, -2) @ fb))
        bwd_t = timed("k6_ms", lambda: fused.fused_dwindow_packed(
            x, reim, dmel, g, k))
        bwd_single = time_ms(lambda: [
            fused.fused_dwindow(xi, reims[i], di, g)
            for i, (xi, di) in enumerate(singles)])
        bwd_plain = plain_time_ms(lambda: framed.framed_dwindow_plain_packed(
            x, reim, dmel, g, k))
        del reims
    # dlambda through the chain: K5 + K6, K5 + the torch adjoint, plain
    xk = x.reshape(k, batch, t)

    def dlam(fn):
        lv = lam.clone().requires_grad_()
        (fn(lv) * dmel.reshape(k, batch, N_MELS, -1)).sum().backward()
        return lv.grad

    kw = dict(win_length=n_fft, n_fft=n_fft, hop_length=HOP, n_mels=N_MELS,
              sample_rate=SR)
    d_adj = dlam(lambda lv: fused.dmel_power(xk, lv, **kw))
    fused.USE_FUSED_BWD = True
    try:
        d_k6 = dlam(lambda lv: fused.dmel_power(xk, lv, **kw))
    finally:
        fused.USE_FUSED_BWD = False
    d_plain = dlam(lambda lv: torch.stack([
        fused.dmel_power_plain(xk[i], lv[i], **kw) for i in range(k)]))
    dl_rel = [max(abs(float(a[i] - d_plain[i])) / abs(float(d_plain[i]))
                  for a in (d_adj, d_k6)) for i in range(k)]
    b5 = framed_bound(batch, t, n_fft, fb_nnz)
    b6 = k4_bound(batch, t, n_fft, fb_nnz)
    res = dict(k=k, batch=batch, t=t, n_fft=n_fft, lambd=list(lams[:k]),
               fwd_bit_identical_to_single=fwd_bits,
               dw_rel_err_vs_single=dw_rel_single,
               logmel_max_abs_err=logmel_err, dw_err_of_max=dw_err,
               dlambd_rel_err=dl_rel, **fwd_t, single_launches_ms=fwd_single,
               plain_ms=fwd_plain, **lib_fwd, bound_ms=k * b5[0],
               bound_by=b5[1], **bwd_t, k6_single_launches_ms=bwd_single,
               k6_plain_ms=bwd_plain, k6_bound_ms=k * b6[0],
               k6_bound_by=b6[1])
    say("K5/K6 packed " + json.dumps(res))
    check(fwd_bits, "packed K5 differs from the single launches")
    check(dw_rel_single <= 1e-6, f"packed K6 vs single {dw_rel_single:.3e}")
    check(logmel_err <= GATE, f"packed K5 vs plain {logmel_err:.3e}")
    check(dw_err <= DW_GATE, f"packed K6 vs plain {dw_err:.3e} of max")
    check(max(dl_rel) <= GRAD_GATE, f"packed dlambda vs plain {dl_rel}")
    return res


def packed_specband_case(seed: int, dev: torch.device, k: int = 6,
                         batch: int = BATCH, n_fft: int = 1024,
                         lams=PACK_SPECBAND_LAMS, t: int = T) -> dict:
    """K1 and K2 on a pack of ``k`` trials at 1024 (J 24, the model
    path's mel power without the log epilogue): one launch each; trial
    i's forward bit for bit the single launch's, its taps' gradient
    within 1e-6; against the plain versions on each trial (log-mel 1e-4,
    taps' gradient 1e-3 of the largest); dlambda (k,) through K1 + K2
    against autograd of the plain function, 1e-2 each.  Times as
    :func:`packed_fused_case`'s."""
    hint = stft.pallas_compile_hint(lams[-1], n_fft, HOP)
    check(all(stft.pallas_compile_hint(lam, n_fft, HOP) == hint
              for lam in lams[:k]), "the pack's lambdas take two hints")
    route, j = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                          optimized=True, window_length=n_fft,
                          lambd_hint=hint)
    check(route == "specband" and j == 24, f"{route} J {j}")
    g = specband._Geom(n_fft, HOP, N_MELS, SR, 0.0, float(SR // 2), j, False)
    x = _pack_signal(seed, k, batch, t, dev)
    lam = torch.tensor(lams[:k], device=dev)
    rho = specband.window_taps_sym(gaussian_window(lam, n_fft), n_fft,
                                   j).contiguous()
    fb = specband._fb(g, dev)
    fb_nnz = int((fb != 0).sum())
    with torch.no_grad():
        out, xext = specband.fwd_packed(x, rho, g)
        dmel = torch.from_numpy(np.random.default_rng(seed + 1)
                                .standard_normal(tuple(out.shape))
                                .astype(np.float32)).to(dev)
        drho = specband.specband_drho_packed(xext, rho, fb, dmel, None,
                                             None, k)
        singles = _per_trial(k, batch, x, dmel)
        fwd_bits, drho_single, logmel_err, drho_err = True, 0.0, 0.0, 0.0
        xexts = []
        for i, (xi, di) in enumerate(singles):
            o1, e1 = specband._fwd(xi, rho[i].contiguous(), g)
            xexts.append(e1)
            rows = slice(i * batch, (i + 1) * batch)
            fwd_bits &= bool(torch.equal(out[rows], o1))
            drho_single = max(drho_single, rel_err(
                drho[i], specband.specband_drho(e1, rho[i].contiguous(), fb,
                                                di)))
            p_out, p_xext = specband._fwd_plain(xi, rho[i], g)
            logmel_err = max(logmel_err, float(
                (torch.log(out[rows] + LOG_EPS)
                 - torch.log(p_out + LOG_EPS)).abs().max()))
            drho_err = max(drho_err, rel_err(drho[i], specband.
                                             specband_drho_plain(
                                                 p_xext, rho[i], fb, di)))
        fwd_t = timed("ms", lambda: specband.fwd_packed(x, rho, g))
        fwd_split = stage_split(lambda: specband.fwd_packed(x, rho, g))
        fwd_single = time_ms(lambda: [specband._fwd(xi, rho[i].contiguous(),
                                                    g)
                                      for i, (xi, _) in enumerate(singles)])
        fwd_plain = plain_time_ms(lambda: [
            specband._fwd_plain(xi, rho[i], g)
            for i, (xi, _) in enumerate(singles)])
        fbank = melscale_fbanks(n_fft // 2 + 1, 0.0, float(SR // 2), N_MELS,
                                SR).to(dev)
        w = gaussian_window(lam, n_fft)
        lib_fwd = timed("library_ms", lambda: (stft.stft_power_packed(
            x.reshape(k, batch, t), w, n_fft, HOP).transpose(-1, -2) @ fbank))
        bwd_t = timed("k2_ms", lambda: specband.specband_drho_packed(
            xext, rho, fb, dmel, None, None, k))
        bwd_single = time_ms(lambda: [
            specband.specband_drho(xexts[i], rho[i].contiguous(), fb, di)
            for i, (_, di) in enumerate(singles)])
        bwd_plain = plain_time_ms(lambda: torch.stack([
            specband.specband_drho_plain(xe, rho[i], fb, dm)
            for i, (xe, dm) in enumerate(zip(xext.chunk(k), dmel.chunk(k)))]))
        del xexts
    xk = x.reshape(k, batch, t)

    def dlam(fn):
        lv = lam.clone().requires_grad_()
        (fn(lv) * dmel.reshape(k, batch, N_MELS, -1)).sum().backward()
        return lv.grad

    kw = dict(n_fft=n_fft, hop_length=HOP, n_mels=N_MELS, sample_rate=SR,
              j_taps=j)
    d_k = dlam(lambda lv: specband.specband_mel_power(
        xk, gaussian_window(lv, n_fft), **kw))
    d_p = dlam(lambda lv: torch.stack([specband.specband_mel_power_plain(
        xk[i], gaussian_window(lv[i], n_fft), **kw) for i in range(k)]))
    dl_rel = [abs(float(d_k[i] - d_p[i])) / abs(float(d_p[i]))
              for i in range(k)]
    b1 = k1_bound(batch, n_fft, j, fb_nnz)
    b2 = k2_bound(batch, n_fft, j, fb_nnz, False)
    band_b = k1_band_bound(batch * stft.num_frames(t, HOP), n_fft, j, fb_nnz,
                           sigma_bins(n_fft, (0,) * N_MELS, 1), False)
    res = dict(k=k, batch=batch, t=t, n_fft=n_fft, j_taps=j, hint=hint,
               lambd=list(lams[:k]), fwd_bit_identical_to_single=fwd_bits,
               drho_rel_err_vs_single=drho_single,
               logmel_max_abs_err=logmel_err, drho_err_of_max=drho_err,
               dlambd_rel_err=dl_rel, **fwd_t, single_launches_ms=fwd_single,
               plain_ms=fwd_plain, **lib_fwd, bound_ms=k * b1[0],
               bound_by=b1[1], split=fwd_split,
               band_ms=band_stage_ms(fwd_split), band_bound_ms=k * band_b[0],
               band_bound_by=band_b[1], **bwd_t,
               k2_single_launches_ms=bwd_single,
               k2_plain_ms=bwd_plain, k2_bound_ms=k * b2[0],
               k2_bound_by=b2[1])
    say("K1/K2 packed " + json.dumps(res))
    check(fwd_bits, "packed K1 differs from the single launches")
    check(drho_single <= 1e-6, f"packed K2 vs single {drho_single:.3e}")
    check(logmel_err <= GATE, f"packed K1 vs plain {logmel_err:.3e}")
    check(drho_err <= DRHO_GATE, f"packed K2 vs plain {drho_err:.3e} of max")
    check(max(dl_rel) <= GRAD_GATE, f"packed dlambda vs plain {dl_rel}")
    return res


def pack_of_one_case(seed: int, dev: torch.device) -> dict:
    """A pack of one trial is today's single launch, bit for bit, for
    K1, K2, K5 and K6 (4096, lambda 400 on the fused route, 1024 at
    lambda 128 on specband)."""
    x = _pack_signal(seed, 1, BATCH, T, dev)
    g5 = framed.Geom(4096, HOP, N_MELS, SR, 0.0, float(SR // 2))
    w = gaussian_window(torch.tensor(400.0, device=dev), 4096)
    g1 = specband._Geom(1024, HOP, N_MELS, SR, 0.0, float(SR // 2), 24,
                        False)
    rho = specband.window_taps_sym(gaussian_window(
        torch.tensor(128.0, device=dev), 1024), 1024, 24).contiguous()
    fb = specband._fb(g1, dev)
    with torch.no_grad():
        o, r = fused.fused_fwd(x, w, g5)
        op, rp = fused.fused_fwd_packed(x, w[None].contiguous(), g5)
        dmel = torch.ones_like(o)
        same5 = bool(torch.equal(o, op) and torch.equal(r, rp))
        same6 = bool(torch.equal(fused.fused_dwindow(x, r, dmel, g5),
                                 fused.fused_dwindow_packed(x, r, dmel, g5,
                                                            1)[0]))
        o1, e1 = specband._fwd(x, rho, g1)
        o1p, e1p = specband.fwd_packed(x, rho[None].contiguous(), g1)
        same1 = bool(torch.equal(o1, o1p) and torch.equal(e1, e1p))
        d1 = torch.ones_like(o1)
        same2 = bool(torch.equal(
            specband.specband_drho(e1, rho, fb, d1),
            specband.specband_drho_packed(e1, rho[None].contiguous(), fb, d1,
                                          None, None, 1)[0]))
    res = dict(K1=same1, K2=same2, K5=same5, K6=same6)
    say("pack of one " + json.dumps(res))
    check(all(res.values()), f"a pack of one differs: {res}")
    return res


#: the pack's launches on one train step and one valid batch, by route:
#: the packed counters
_PACK_ROUTE_KERNELS = {"fused": (("K5p",), ("K5p",)),
                       "specband": (("K1p", "K2p"), ("K1p",))}


def counted_pack(run):
    """``run()`` with every launch counter at 0, and the pack's epochs
    observed: each epoch's geometry (from ``TrialPack.set_geometry``,
    called once at each epoch's start), the cumulative launches at its
    start, its train steps and their times (synchronised: the first and
    the rest).  Returns ``(result, epochs, launches)``."""
    from dmel_tpu_torch.models import packed as packed_mod
    from dmel_tpu_torch.parallel import trials as trials_mod
    epochs = []
    real_geom = packed_mod.TrialPack.set_geometry
    real_step = trials_mod.make_multitrial_step

    def set_geometry(self, wl, hint):
        epochs.append(dict(window_length=wl, lambd_hint=hint,
                           start=launch_counts(), step_s=[]))
        return real_geom(self, wl, hint)

    def make_step(*a, **kw):
        step = real_step(*a, **kw)

        def timed_step(*sa, **skw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(*sa, **skw)
            torch.cuda.synchronize()
            epochs[-1]["step_s"].append(time.perf_counter() - t0)
            return m
        return timed_step

    packed_mod.TrialPack.set_geometry = set_geometry
    trials_mod.make_multitrial_step = make_step
    try:
        out, total = counted(run)
    finally:
        packed_mod.TrialPack.set_geometry = real_geom
        trials_mod.make_multitrial_step = real_step
    return out, epochs, total


def check_pack_epochs(epochs, total, route: str, valid_batches: int,
                      fused_bwd: bool = False) -> list:
    """Each pack epoch's launches against ``route``'s: its packed train
    kernels once a train step, its valid kernels once a valid batch, no
    single-trial kernel; returns the epochs' summaries."""
    out = []
    ends = [e["start"] for e in epochs[1:]] + [total]
    for i, (e, end) in enumerate(zip(epochs, ends)):
        launched = {k: end[k] - e["start"][k] for k in COUNTERS}
        steps = len(e["step_s"])
        want = dict.fromkeys(COUNTERS, 0)
        train_k, valid_k = _PACK_ROUTE_KERNELS[route]
        if fused_bwd and route == "fused":
            train_k = train_k + ("K6p",)
        for k in train_k:
            want[k] += steps
        for k in valid_k:
            want[k] += valid_batches
        check(launched == want,
              f"pack epoch {i}: launches "
              f"{ {k: v for k, v in launched.items() if v} }, expected "
              f"{ {k: v for k, v in want.items() if v} }")
        s = e["step_s"]
        out.append(dict(epoch=i, window_length=e["window_length"],
                        lambd_hint=e["lambd_hint"], steps=steps,
                        step_ms_first=s[0] * 1e3 if s else None,
                        step_ms_steady=(float(np.median(s[1:])) * 1e3
                                        if len(s) > 1 else None),
                        launches={k: v for k, v in launched.items() if v}))
    return out


def pack_sweep_path(dev: torch.device, out: str, name: str = SWEEP_NAME,
                    epochs: int = SWEEP_EPOCHS, data_dir: str | None = None,
                    n_test: int = 400, repeat: bool = True,
                    k6: bool = True, sequential: dict | None = None) -> dict:
    """The space ``name`` through the CLI with ``--pack``, as a user runs
    it: the grid's six trials as one program, launches counted by epoch
    (one packed K5 launch a train step and a valid batch on the fused
    route the pack's one bucket takes, none of K1-K4), the pack's step
    ms (first and steady), its seconds and its data load's; six rows in
    results.csv, each trial's best model without a sidecar (the JAX
    package's layout); ``predict_test`` on every row; with ``repeat`` a
    second run into another directory, bit-identical in every record and
    weight; with ``k6`` one more pack epoch with ``fused.USE_FUSED_BWD``
    set, whose steps launch K6 on the pack.  ``sequential`` is the same
    space's sequential sweep (:func:`sweep_path`), for its seconds."""
    from dmel_tpu_torch.eval import predict_test
    from dmel_tpu_torch.experiments import cli, runner
    from dmel_tpu_torch.training import load_checkpoint
    data_dir = out if data_dir is None else data_dir
    loads, sizes = [], {}
    real_data = runner.get_dataset_by_config

    def timed_data(config, ddir):
        t0 = time.perf_counter()
        splits = real_data(config, ddir)
        loads.append(time.perf_counter() - t0)
        sizes.update(valid=len(splits[1]), batch=int(config["batch_size"]))
        return splits

    def run(sub, max_epochs):
        argv = ["--name", name, "--num_samples", "1", "--max_epochs",
                str(max_epochs), "--output_dir", os.path.join(out, sub),
                "--data_dir", data_dir, "--pack", "--verbose", "0"]
        t0 = time.perf_counter()
        (_, epochs_seen, total) = counted_pack(lambda: cli.main(argv))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, epochs_seen, total

    runner.get_dataset_by_config = timed_data
    try:
        sweep_s, seen, total = run("pack_a", epochs)
        valid_batches = -(-sizes["valid"] // sizes["batch"])
        ep = check_pack_epochs(seen, total, "fused", valid_batches)
        check(all(e["window_length"] == 4096 and e["lambd_hint"] is None
                  for e in ep), f"the pack's geometry {ep}")
        runs = [os.path.join(out, "pack_a", name)]
        if repeat:
            run("pack_b", epochs)
            runs.append(os.path.join(out, "pack_b", name))
        k6_s = ep6 = None
        if k6:
            fused.USE_FUSED_BWD = True
            try:
                k6_s, seen6, total6 = run("pack_k6", 1)
            finally:
                fused.USE_FUSED_BWD = False
            ep6 = check_pack_epochs(seen6, total6, "fused", valid_batches,
                                    fused_bwd=True)
            for k_, v in total6.items():
                total[k_] += v
    finally:
        runner.get_dataset_by_config = real_data
    sweep_dir = runs[0]
    rows = runner.load_results(sweep_dir)
    check(len(rows) == 6, f"{len(rows)} rows in results.csv")
    for i, row in enumerate(rows):
        ckpt = os.path.join(row["logdir"], "checkpoint_000000")
        check(os.path.isfile(os.path.join(ckpt, "best_model")),
              f"pack trial {i} has no best_model")
        check(not os.path.exists(os.path.join(ckpt, "best_model.meta.json")),
              f"pack trial {i} has a sidecar")
    identical = None
    if repeat:
        identical = True
        for i in range(6):
            a, b = (os.path.join(d, f"trial_{i:05d}") for d in runs)
            with open(os.path.join(a, "progress.csv")) as fa, \
                    open(os.path.join(b, "progress.csv")) as fb_:
                identical &= fa.read() == fb_.read()
            wa, wb = (load_checkpoint(os.path.join(
                d, "checkpoint_000000", "best_model"))["model"]
                for d in (a, b))
            identical &= all(torch.equal(wa[n], wb[n]) for n in wa)
        check(identical, "two pack runs differ")
    t0 = time.perf_counter()
    scored = predict_test(sweep_dir, data_dir, verbose=0)
    predict_s = time.perf_counter() - t0
    preds = np.load(os.path.join(sweep_dir, f"{rows[0]['config/dataset_name']}"
                                 "_predictionss.npy"))
    check(preds.shape[:2] == (6, n_test), f"predictions {preds.shape}")
    res = dict(name=name, sweep_s=sweep_s, data_load_s=loads,
               epochs=ep, k6_epoch=ep6, k6_run_s=k6_s,
               bit_identical_runs=identical, predict_test_s=predict_s,
               test=[{k: r.get(k) for k in ("test_accuracy", "test_mAP",
                                            "config/init_lambd",
                                            "config/trainable",
                                            "est_lambd", "lambd_est")
                      if k in r} for r in scored],
               launches=total,
               sequential_sweep_s=(sequential or {}).get("sweep_s"))
    say(f"pack sweep {name} " + json.dumps(res))
    return res


def pack_specband_path(seed: int, dev: torch.device) -> dict:
    """``fit_trials`` on two trainable trials at lambda 110 and 120 (bf16
    CNN6, batch 32, esc50_synth clips, lr_tf 1e-3, 2 epochs): both take
    the hint 106.77 at bucket 1024 (specband, J 24), so the pack rides
    K1 and K2 with a trial axis; launches counted by epoch against the
    route :func:`_shared_specband_hint` picked."""
    from dmel_tpu_torch.parallel import fit_trials
    config = dict(TRAIN_CONFIG, model_dtype="bfloat16", lr_tf=1e-3)
    trainset, validset, _ = get_dataset_by_config(config)
    configs = [dict(config, init_lambd=lam) for lam in (110.0, 120.0)]
    t0 = time.perf_counter()
    (state, hists), seen, total = counted_pack(
        lambda: fit_trials(configs, trainset, validset, seed=seed,
                           device=dev))
    fit_s = time.perf_counter() - t0
    valid_batches = -(-len(validset) // BATCH)
    hint = stft.pallas_compile_hint(120.0, 1024, HOP)
    check(all(e["window_length"] == 1024 and e["lambd_hint"] == hint
              for e in seen), f"pack geometry {seen}")
    ep = check_pack_epochs(seen, total, "specband", valid_batches)
    lam = state["pack"].params["spectrogram_layer.lambd"].detach().cpu()
    check(bool(torch.isfinite(lam).all()) and float(lam[0]) != 110.0,
          f"lambda {lam}")
    res = dict(hint=hint, fit_s=fit_s, epochs=ep, lambd=lam.tolist(),
               records=[h["records"] for h in hists], launches=total)
    say("pack specband " + json.dumps(res))
    return res


#: the reference's literal geometries (n_fft = win = T: the published
#: experiments' ``window_length = len(x)``) at the published batches and
#: the grids' lambda 46.67 and 400 (dmel_tpu/experiments/configs.py:69,
#: 106): (space, batch, T, lambda)
LITERAL_CASES = (("audio_mnist", AM_BATCH, AM_T, 46.67),
                 ("audio_mnist", AM_BATCH, AM_T, 400.0),
                 ("esc50", BATCH, T, 46.67),
                 ("esc50", BATCH, T, 400.0))
#: dlambda relative gate at the literal geometries (tests/
#: test_reference_geometries.py's)
LITERAL_GRAD_GATE = 1e-3
#: rows held against the CPU oracle
LITERAL_ROWS = 2


def _fwd_dlambd(x, lam: float, window_length: int, hint):
    """``mel_spectrogram(impl="auto", log_output=True)`` of ``x`` at
    ``window_length`` and ``backward()`` of its sum into lambda:
    ``(log-mel, dlambda)``."""
    lam_t = torch.tensor(lam, device=x.device, requires_grad=True)
    feat = mel_spectrogram(x, lam_t, n_mels=N_MELS, sample_rate=SR,
                           hop_length=HOP, optimized=True,
                           window_length=window_length, impl="auto",
                           lambd_hint=hint, log_output=True,
                           device=x.device)
    feat.sum().backward()
    return feat.detach(), lam_t.grad


def _timed_peak(fn) -> dict:
    """``fn``'s :func:`timing` (3 blocks of 5 calls after 2), the card's
    peak allocated bytes over those calls, and the card's time a call
    from the profiler (:func:`device_ms`, 5 calls)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = timing(fn, iters=5, warmup=2, reps=3)
    peak = torch.cuda.max_memory_allocated()
    return dict(ms=t["ms"], range=t["range"], enqueue_ms=t["enqueue_ms"],
                device_ms=device_ms(fn, calls=5), peak_bytes=peak)


def literal_geometry_case(seed: int, dev: torch.device, space: str,
                          batch: int, t: int, lam: float) -> dict:
    """Forward + dlambda at n_fft = win = ``t`` (the exact route:
    cuFFT), with no K1-K6 launch; its first rows' log-mel (1e-4 max-abs)
    and those rows' dlambda (1e-3 relative) against the CPU oracle of
    ``tests/reference_impl.py``; ms and peak memory beside the bucketed
    window and route ``fit`` takes at the same batch and lambda."""
    from tests.reference_impl import torch_logmel_oracle
    x_np = np.random.default_rng(seed).standard_normal(
        (batch, t)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    route = auto_route(signal_length=t, hop_length=HOP, n_mels=N_MELS,
                       optimized=True, window_length=t, lambd_hint=lam)[0]
    check(route == "exact", f"{space} n_fft {t}: route {route}")
    (feat, _), launches = counted(lambda: _fwd_dlambd(x, lam, t, lam))
    (_, grad), launches_rows = counted(
        lambda: _fwd_dlambd(x[:LITERAL_ROWS], lam, t, lam))
    check(not any(launches.values()) and not any(launches_rows.values()),
          f"a kernel launched at n_fft {t}: {launches}")
    rows = x_np[:LITERAL_ROWS]
    ref, ref_grad = torch_logmel_oracle(rows, lam, t, HOP, N_MELS, SR)
    check(feat.shape == (batch, N_MELS, t // HOP + 1)
          and bool(torch.isfinite(feat).all()), f"features {feat.shape}")
    err = float((feat[:LITERAL_ROWS].cpu() - torch.from_numpy(ref)).abs()
                .max())
    gerr = abs(float(grad) - ref_grad) / abs(ref_grad)
    check(err <= GATE, f"{space} n_fft {t} lambda {lam}: log-mel {err}")
    check(gerr <= LITERAL_GRAD_GATE,
          f"{space} n_fft {t} lambda {lam}: dlambda {gerr}")
    del feat, grad
    literal = _timed_peak(lambda: _fwd_dlambd(x, lam, t, lam))
    b_route, wl, hint, j = _route_of(dict(CONFIG, n_points=t), lam)
    bucketed = _timed_peak(lambda: _fwd_dlambd(x, lam, wl, hint))
    res = dict(space=space, batch=batch, t=t, lambd=lam, n_fft=t,
               route=route, logmel_max_abs_err=err, dlambd_rel_err=gerr,
               rows_vs_oracle=LITERAL_ROWS, ms=literal["ms"],
               ms_range=literal["range"], enqueue_ms=literal["enqueue_ms"],
               device_ms=literal["device_ms"],
               peak_bytes=literal["peak_bytes"],
               bucketed=dict(window_length=wl, route=b_route, hint=hint,
                             j_taps=j, ms=bucketed["ms"],
                             ms_range=bucketed["range"],
                             enqueue_ms=bucketed["enqueue_ms"],
                             device_ms=bucketed["device_ms"],
                             peak_bytes=bucketed["peak_bytes"]),
               ms_ratio_literal_to_bucketed=literal["ms"] / bucketed["ms"])
    say("literal geometry " + json.dumps(res))
    return res


def figures_path(dev: torch.device) -> dict:
    """The data example's spectrograms (``eval.figures``: three
    Gauss-pulse classes x lambda scales 1, 0.2, 5, faithful mode at T
    128, hop 1) on the card against the same call on the CPU, within
    1e-4 of the largest entry, with no kernel launch.  No figure is
    drawn: matplotlib is not needed here."""
    from dmel_tpu_torch.eval.figures import data_example_spectrograms
    got, launches = counted(lambda: data_example_spectrograms(device=dev))
    want = data_example_spectrograms(device="cpu")
    check(not any(launches.values()), f"kernels launched: {launches}")
    check(got.shape == want.shape == (3, 3, 129, 129)
          and bool(np.isfinite(got).all()), f"shape {got.shape}")
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    check(err <= GATE, f"data example spectrograms: {err} of the largest")
    res = dict(shape=list(got.shape), err_of_max=err)
    say("figures " + json.dumps(res))
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
    enqueue time (:func:`timing`).  Where the case also has the
    profiler's card time (``key`` with ``_device`` before ``_ms``), that
    is ``library_ms`` and the events' median ``library_ms_events``."""
    out = dict(library_ms=case[key], library_ms_range=case[key + "_range"],
               library_ms_enqueue=case[key + "_enqueue"])
    device = case.get(key[:-3] + "_device_ms")
    if isinstance(device, float):
        out.update(library_ms=device, library_ms_events=case[key])
    return out


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
        # K6 also keeps its dw sums there: 16 floats a thread, 16 KB
        for name, kernel, extra in (
                ("framed_fwd", ("fused_bluestein_kernel",), 0),
                ("framed_bwd", ("adjoint_fft_dw_kernel", "ILb1E"), 16384)):
            say(bluestein_ptxas(libs[KERNELS.index(name)].log, kernel,
                                extra))

    seed = args.seed
    with phase("K1 vs plain"):
        cases = [k1_case(seed, 128, 1024, 128.0, dev),
                 k1_case(seed, BATCH, 1024, 128.0, dev),
                 k1_case(seed, BATCH, 2048, 250.0, dev),
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
        cases5 += [frontend_case(seed, "fused", b, t / 5.0, dev, None, t=t)
                   for b, t in BLUESTEIN_SHAPES]

    with phase("K1/K2 multi vs plain"):
        cases_m = [multi_case(seed, 128, 1024, (100.0, 110.0, 120.0, 128.0),
                              dev),
                   multi_case(seed, BATCH, 1024, (100.0, 110.0, 120.0, 128.0),
                              dev),
                   multi_case(seed, BATCH, 4096, (345.0, 360.0, 380.0, 400.0),
                              dev)]

    with phase("K1-K5 at AudioMNIST shapes"):
        # every bucket the sweep's arms cross at T 8000: specband at 1024
        # (lambda 85.5-128), 2048 and 4096; framed at 512 and 1024 (lambda
        # 128-170.8); fused at 4096
        cases += [k1_case(seed, AM_BATCH, 4096, 400.0, dev, t=AM_T),
                  k1_case(seed, AM_BATCH, 2048, 172.95, dev, t=AM_T),
                  k1_case(seed, AM_BATCH, 1024, 100.0, dev, t=AM_T)]
        cases2 += [k2_case(seed, AM_BATCH, 4096, 400.0, True, dev, t=AM_T),
                   k2_case(seed, AM_BATCH, 2048, 172.95, True, dev, t=AM_T),
                   k2_case(seed, AM_BATCH, 1024, 100.0, True, dev, t=AM_T)]
        cases34 += [frontend_case(seed, "framed", AM_BATCH, 46.7, dev, 512,
                                  t=AM_T),
                    frontend_case(seed, "framed", AM_BATCH, 150.0, dev, 1024,
                                  t=AM_T)]
        # the audio_mnist sweep's trainable 400 arm grows into fused
        cases5 += [frontend_case(seed, "fused", AM_BATCH, 600.0, dev, 4096,
                                 t=AM_T)]

    with phase("K6 vs plain"):
        cases6 = [k6_case(seed, BATCH, 300.0, dev, 2048),
                  k6_case(seed, BATCH, 600.0, dev, 4096),
                  k6_case(seed, BATCH, 300.0, dev, None, t=1500)]
        cases6 += [k6_case(seed, b, t / 5.0, dev, None, t=t)
                   for b, t in BLUESTEIN_SHAPES]

    with phase("packed kernels"):
        pack_one = pack_of_one_case(seed, dev)
        pack5 = packed_fused_case(seed, dev)
        pack1 = packed_specband_case(seed, dev)
        # the "pack specband" path's own pack: two trials at 110 and 120
        pack1_path = packed_specband_case(seed, dev, k=2,
                                          lams=(110.0, 120.0))

    with phase("literal geometries"):
        for case in LITERAL_CASES:
            literal_geometry_case(seed, dev, *case)
    with phase("figures"):
        figures_path(dev)

    paths = {}
    with phase("model path"):
        paths["inference"] = model_path(seed, dev, 128.0)
    with phase("model path, framed"):
        paths["inference_framed"] = model_path(seed, dev, 46.7)
    with phase("model path, multi-sigma"):
        paths["inference_multi"] = model_path(seed, dev, 128.0, n_sigma=4)
    with phase("model path, multi-sigma exact"):
        paths["inference_multi_exact"] = model_path(seed, dev, 46.7,
                                                    n_sigma=4)
    with phase("faithful path"):
        paths["faithful"] = faithful_path(seed, dev)

    with phase("train path"):
        paths["train"] = train_path(seed, dev, 128.0, repeat=True)
    with phase("train path, framed"):
        paths["train_framed"] = train_path(seed, dev, 46.7, repeat=True)
    with phase("train path, fused"):
        paths["train_fused"] = train_path(seed, dev, 600.0)
    with phase("train path, multi-sigma"):
        paths["train_multi"] = train_path(seed, dev, 128.0, n_sigma=4)
    with phase("train path, fused with K6"):
        paths["train_fused_k6"] = train_path(seed, dev, 600.0,
                                             fused_bwd=True)

    for name, lam, n_sigma in (("specband", 128.0, 1), ("framed", 46.7, 1),
                               ("fused", 600.0, 1), ("multi", 128.0, 4)):
        with phase(f"bf16 train step, {name}"):
            bf16_step_path(seed, dev, lam, n_sigma)

    with tempfile.TemporaryDirectory() as out:
        with phase("CLI sweep"):
            paths["sweep"] = sweep_path(dev, out)[0]
        with phase("pack sweep esc50_synth"):
            paths["pack_sweep"] = pack_sweep_path(
                dev, out, sequential=paths["sweep"])
        with phase("checkpoint prediction"):
            checkpoint_prediction(dev, os.path.join(out, SWEEP_NAME))
        with phase("kill and resume"):
            paths["resume"] = resume_path(seed, dev, out)
        with phase("time_frequency sweep"):
            paths["sweep_time_frequency"] = time_frequency_path(dev, out)
        with phase("AudioMNIST sweep"):
            paths["sweep_audio_mnist"] = audio_mnist_path(seed, dev, out)
        with phase("ESC-50 sweep"):
            paths["sweep_esc50"] = esc50_path(seed, dev, out)
        with phase("fsd sweep"):
            paths["sweep_fsd"] = fsd_path(seed, dev, out)
        with phase("pack fsd"):
            paths["pack_fsd"] = pack_sweep_path(
                dev, out, "fsd", 1, os.path.join(out, "fsd_data"),
                n_test=FSD_EVAL, repeat=False, k6=False,
                sequential=paths["sweep_fsd"])
        with phase("pretrained import"):
            paths["pretrained"] = pretrained_path(
                seed, dev, out, os.path.join(out, "fsd_data"))
    with phase("pack specband"):
        paths["pack_specband"] = pack_specband_path(seed, dev)
    with phase("SpecAugment"):
        augment_path(seed, dev)
    with phase("Cnn14"):
        cnn14_path(seed, dev)
    with phase("batch-norm variance"):
        bn_variance_path(seed, dev)
    with phase("data parallel"):
        with tempfile.TemporaryDirectory() as out:
            paths["data_parallel"] = data_parallel_path(seed, dev, out, smi)

    def by_path(key):
        return {name: r["launches"][key] for name, r in paths.items()}

    def fft_fields(key, case, all_cases):
        """A spectra-stage kernel's entry fields: the stage of the main
        path's shape and of every measured shape, the direct stage's time
        and both splits at the main shape, its FFT-stage launches."""
        return dict(stage=case["stage"],
                    stages={f"B{c['batch']}-nfft{c['n_fft']}": c["stage"]
                            for c in all_cases},
                    direct_ms=case["direct_ms"], split=case["split"],
                    split_direct=case["split_direct"],
                    fft_launches=sum(by_path(FFT_COUNTER[key]).values()))

    def shapes(all_cases, prefix, lib_key):
        """A kernel's times at every measured shape: its own, its plain
        version's, its bound and its yardstick's card time (events where
        the profiler saw none)."""
        out = {}
        for c in all_cases:
            lib = c.get(lib_key[:-3] + "_device_ms")
            name = f"B{c['batch']}-nfft{c['n_fft']}"
            if c.get("t", T) != T:
                name += f"-T{c['t']}"
            if "log" in c:
                name += f"-log{int(c['log'])}"
            elif not isinstance(c["lambd"], list):
                name += f"-lam{c['lambd']}"
            out[name] = dict(ms=c[prefix + "ms"],
                             plain_ms=c[prefix + "plain_ms"],
                             bound_ms=c[prefix + "bound_ms"],
                             library_ms=lib if isinstance(lib, float)
                             else c[lib_key])
            if not prefix and "band_ms" in c:
                out[name].update(band_ms=c["band_ms"],
                                 band_bound_ms=c["band_bound_ms"])
        return out

    main1, main2 = cases[1], cases2[2]   # the model's and the train's shape
    main34, main5 = cases34[0], cases5[1]
    main_m, main6 = cases_m[1], cases6[1]
    kernels = [
        _kernel_entry(
            "specband_fwd", "specband_fwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:476", by_path("K1"),
            max(c["logmel_max_abs_err"] for c in cases), "log-mel", GATE,
            main1, **_library(main1, "library_ms"),
            **fft_fields("K1", main1, cases),
            shapes=shapes(cases, "", "library_ms"),
            band_ms=main1["band_ms"], band_bound_ms=main1["band_bound_ms"],
            xext_err_of_max=max(c["xext_err_of_max"] for c in cases)),
        _kernel_entry(
            "specband_bwd", "specband_bwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:749", by_path("K2"),
            max(c["drho_err_of_max"] for c in cases2),
            "drho / max |drho|", DRHO_GATE, main2,
            **_library(main2, "library_bwd_ms"), stage="none (no DFT)",
            tap_instance=main2["tap_instance"], split=main2["split"],
            shapes=shapes(cases2, "", "library_bwd_ms"),
            drho_err_of_max=max(c["drho_err_of_max"] for c in cases2),
            dlambd_rel_err=max(c["dlambd_rel_err"] for c in cases2)),
        _kernel_entry(
            "framed_fwd", "framed_fwd.cu",
            "dmel_tpu/ops/pallas/framed_dmel.py:138", by_path("K3"),
            max(c["logmel_max_abs_err"] for c in cases34), "log-mel", GATE,
            main34, **_library(main34, "library_ms"),
            **fft_fields("K3", main34, cases34),
            shapes=shapes(cases34, "", "library_ms"),
            reim_err_of_max=max(c["reim_err_of_max"] for c in cases34)),
        _kernel_entry(
            "framed_bwd", "framed_bwd.cu",
            "dmel_tpu/ops/pallas/framed_dmel.py:247", by_path("K4"),
            max(c["dw_err_of_max"] for c in cases34), "dw / max |dw|",
            DW_GATE, main34, prefix="k4_",
            **_library(main34, "library_bwd_ms"), stage=main34["k4_stage"],
            stages={f"B{c['batch']}-nfft{c['n_fft']}-lam{c['lambd']}":
                    c["k4_stage"] for c in cases34},
            direct_ms=main34["k4_direct_ms"], split=main34["k4_split"],
            split_direct=main34["k4_split_direct"],
            fft_launches=sum(by_path("K4fft").values()),
            shapes=shapes(cases34, "k4_", "library_bwd_ms"),
            dw_err_of_max=max(c["dw_err_of_max"] for c in cases34),
            dw_err_of_max_direct_stage=max(
                c["dw_err_of_max_direct_stage"] for c in cases34),
            dlambd_rel_err=max(c["dlambd_rel_err"] for c in cases34)),
        _kernel_entry(
            "fused_fwd", "framed_fwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:68", by_path("K5"),
            max(c["logmel_max_abs_err"] for c in cases5), "log-mel", GATE,
            main5, **_library(main5, "library_ms"),
            **fft_fields("K5", main5, cases5),
            shapes=shapes(cases5, "", "library_ms"),
            reim_err_of_max=max(c["reim_err_of_max"] for c in cases5)),
        _kernel_entry(
            "specband_fwd_multi", "specband_fwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:476", by_path("K1m"),
            max(c["logmel_max_abs_err"] for c in cases_m), "log-mel", GATE,
            main_m, **_library(main_m, "library_ms"), k_sig=main_m["k_sig"],
            **fft_fields("K1m", main_m, cases_m),
            shapes=shapes(cases_m, "", "library_ms"),
            band_ms=main_m["band_ms"], band_bound_ms=main_m["band_bound_ms"],
            xext_err_of_max=max(c["xext_err_of_max"] for c in cases_m),
            logmel_err_vs_exact_route=max(
                c["logmel_err_vs_exact_route"] for c in cases_m)),
        _kernel_entry(
            "specband_bwd_multi", "specband_bwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:749", by_path("K2m"),
            max(c["drho_err_of_max"] for c in cases_m),
            "drho / max |drho|", DRHO_GATE, main_m, prefix="k2_",
            **_library(main_m, "library_bwd_ms"), k_sig=main_m["k_sig"],
            stage="none (no DFT)", split=main_m["k2_split"],
            shapes=shapes(cases_m, "k2_", "library_bwd_ms"),
            dlambd_rel_err=max(c["dlambd_rel_err"] for c in cases_m),
            dlambd_rel_err_vs_exact=max(
                c["dlambd_rel_err_vs_exact"] for c in cases_m)),
        _kernel_entry(
            "fused_bwd", "framed_bwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:152", by_path("K6"),
            max(c["dw_err_of_max"] for c in cases6), "dw / max |dw|",
            DW_GATE, main6, **_library(main6, "library_bwd_ms"),
            **fft_fields("K6", main6, cases6),
            dw_err_of_max_direct_stage=max(
                c["dw_err_of_max_direct_stage"] for c in cases6)),
    ]

    def bluestein_fields(key, case, all_cases):
        """A Bluestein-stage entry's fields: the stage at the main shape,
        the direct stage's time and both splits there, its launches on
        the Bluestein counter, whether every measured pack of two was
        bit for bit its single launches."""
        return dict(stage=case["stage"], m_pad=case["m_pad"],
                    radices=case["radices"], direct_ms=case["direct_ms"],
                    split=case["split"], split_direct=case["split_direct"],
                    bluestein_launches=sum(by_path(key).values()),
                    pack2_bit_identical=all(
                        c["pack2_fwd_bit_identical"]
                        and c["pack2_dw_bit_identical"] for c in all_cases))

    # Bluestein's stage of K5 and K6: B 512 x 2039 is the main shape
    bl5 = [c for c in cases5 if c["stage"] == "bluestein"]
    bl6 = [c for c in cases6 if c["stage"] == "bluestein"]
    main5b, main6b = bl5[-1], bl6[-1]
    kernels += [
        _kernel_entry(
            "fused_fwd_bluestein", "framed_fwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:68", by_path("K5bl"),
            max(c["logmel_max_abs_err"] for c in bl5), "log-mel", GATE,
            main5b, **_library(main5b, "library_ms"),
            **bluestein_fields("K5bl", main5b, bl5),
            shapes=shapes(bl5, "", "library_ms"),
            direct_ms_by_shape={f"B{c['batch']}-T{c['t']}": c["direct_ms"]
                                for c in bl5},
            reim_err_of_max=max(c["reim_err_of_max"] for c in bl5),
            dlambd_rel_err=max(c["dlambd_rel_err"] for c in bl5)),
        _kernel_entry(
            "fused_bwd_bluestein", "framed_bwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:152", by_path("K6bl"),
            max(c["dw_err_of_max"] for c in bl6), "dw / max |dw|", DW_GATE,
            main6b, **_library(main6b, "library_bwd_ms"),
            **bluestein_fields("K6bl", main6b, bl6),
            shapes=shapes(bl6, "", "library_bwd_ms"),
            direct_ms_by_shape={f"B{c['batch']}-T{c['t']}": c["direct_ms"]
                                for c in bl6},
            dw_err_of_max_direct_stage=max(
                c["dw_err_of_max_direct_stage"] for c in bl6)),
    ]

    def path_pack(case, prefix):
        """A packed entry's numbers at the pack its path launches."""
        return dict(trials=case["k"], lambd=case["lambd"],
                    ms=case[prefix + "ms"],
                    single_launches_ms=case[prefix + "single_launches_ms"],
                    plain_ms=case[prefix + "plain_ms"],
                    bound_ms=case[prefix + "bound_ms"])

    def packed_entry(name, source, replaces, key, err, err_of, gate, case,
                     prefix="", library=True, **fields):
        lib = (_library(case, "library_ms") if library else
               dict(library_ms=None))
        return _kernel_entry(
            name, source, replaces, by_path(key), err, err_of, gate, case,
            prefix=prefix, **lib, trials=case["k"], batch=case["batch"],
            n_fft=case["n_fft"],
            single_launches_ms=case[prefix + "single_launches_ms"],
            **fields)

    kernels += [
        packed_entry(
            "fused_fwd_packed", "framed_fwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:68", "K5p",
            pack5["logmel_max_abs_err"], "log-mel", GATE, pack5,
            bit_identical_to_single=pack5["fwd_bit_identical_to_single"],
            pack_of_one_is_single=pack_one["K5"]),
        packed_entry(
            "fused_bwd_packed", "framed_bwd.cu",
            "dmel_tpu/ops/pallas/fused_dmel.py:152", "K6p",
            pack5["dw_err_of_max"], "dw / max |dw|", DW_GATE, pack5,
            prefix="k6_", library=False,
            rel_err_vs_single=pack5["dw_rel_err_vs_single"],
            dlambd_rel_err=pack5["dlambd_rel_err"],
            pack_of_one_is_single=pack_one["K6"]),
        packed_entry(
            "specband_fwd_packed", "specband_fwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:476", "K1p",
            max(c["logmel_max_abs_err"] for c in (pack1, pack1_path)),
            "log-mel", GATE, pack1,
            bit_identical_to_single=(pack1["fwd_bit_identical_to_single"]
                                     and pack1_path[
                                         "fwd_bit_identical_to_single"]),
            pack_of_one_is_single=pack_one["K1"],
            band_ms=pack1["band_ms"], band_bound_ms=pack1["band_bound_ms"],
            path_pack=path_pack(pack1_path, "")),
        packed_entry(
            "specband_bwd_packed", "specband_bwd.cu",
            "dmel_tpu/ops/pallas/specband_dmel.py:749", "K2p",
            max(c["drho_err_of_max"] for c in (pack1, pack1_path)),
            "drho / max |drho|", DRHO_GATE, pack1,
            prefix="k2_", library=False,
            rel_err_vs_single=max(c["drho_rel_err_vs_single"]
                                  for c in (pack1, pack1_path)),
            dlambd_rel_err=pack1["dlambd_rel_err"]
            + pack1_path["dlambd_rel_err"],
            pack_of_one_is_single=pack_one["K2"],
            path_pack=path_pack(pack1_path, "k2_")),
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
