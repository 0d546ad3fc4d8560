"""The port's tracing and step timing (``dmel_tpu_torch.utils``), on the
CPU, against the JAX package's ``StepTimer`` summary."""

import json
import os

import pytest
import torch

from dmel_tpu.utils import profiling as jprofiling
from dmel_tpu_torch.utils import StepTimer, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace of a matmul lands in ``log_dir`` as one Chrome trace
    that names the operator."""
    with trace(str(tmp_path / "tr")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer_matches_jax_summary(monkeypatch):
    """The same step times give the same summary as the JAX package's
    timer: the first step skipped, audio-seconds per second per device."""
    clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.5])
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    got = StepTimer(audio_seconds_per_batch=160.0, n_chips=2, device="cpu")
    for _ in range(3):
        with got.step():
            pass
    want = jprofiling.StepTimer(audio_seconds_per_batch=160.0, n_chips=2)
    want.times = [0.25, 0.5]
    assert got.times == [0.25, 0.5]
    assert got.summary() == want.summary()
    assert StepTimer(1.0, device="cpu").summary() == {"steps": 0}


def test_step_timer_on_the_card_synchronises(monkeypatch):
    """A CUDA timer synchronises the card before and after each step,
    and without a card it raises at construction."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    timer = StepTimer(5.0)
    assert timer.n_chips == 1
    with timer.step():
        synced.append("step")
    assert synced == [torch.device("cuda", 0), "step",
                      torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StepTimer(5.0)
