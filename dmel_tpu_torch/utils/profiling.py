"""Tracing and step timing (counterpart of
``dmel_tpu/utils/profiling.py``): a ``torch.profiler`` trace context and
a step timer that reports audio-seconds per second per device.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from dmel_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the body with ``torch.profiler`` (host activity, and the
    card's kernels where CUDA is available) and write a Chrome trace
    (``*.pt.trace.json``, viewable in Perfetto or TensorBoard) into
    ``log_dir``.  Yields the profiler, whose ``key_averages()`` give
    per-operator times."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class StepTimer:
    """Steps per second and audio-seconds per second per device over a
    run of steps on ``device`` (default ``cuda``).

    A CUDA step is timed from a synchronised start to a synchronised
    end, so the time is the card's work for the step and not the host's
    time to issue it.

    >>> timer = StepTimer(audio_seconds_per_batch=160.0, device="cpu")
    >>> with timer.step():
    ...     train_step(...)
    >>> timer.summary()["audio_s_per_s_per_chip"]
    """

    def __init__(self, audio_seconds_per_batch: float,
                 n_chips: int | None = None, skip_first: int = 1,
                 device=None):
        self.audio_s = audio_seconds_per_batch
        self.device = resolve_device(device)
        self.n_chips = n_chips or (torch.cuda.device_count()
                                   if self.device.type == "cuda" else 1)
        self.skip_first = skip_first   # the first steps build and tune
        self.times: list[float] = []
        self._all = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t
        self._all += 1
        if self._all > self.skip_first:
            self.times.append(dt)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        mean = sum(self.times) / len(self.times)
        return {
            "steps": len(self.times),
            "mean_step_s": mean,
            "steps_per_s": 1.0 / mean,
            "audio_s_per_s": self.audio_s / mean,
            "audio_s_per_s_per_chip": self.audio_s / mean / self.n_chips,
        }
