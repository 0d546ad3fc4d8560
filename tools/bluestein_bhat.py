#!/usr/bin/env python3
"""Where K5's and K6's Bluestein stage should read its kernel from.

    python3 tools/bluestein_bhat.py

Bluestein's stage (``csrc/frame_fft.cuh:bluestein_frames``) multiplies
each frame's m_pad-point spectrum by ``FFT(b) / m_pad`` (B^), which the
kernels read from device memory (through L2: 16 KB at m_pad 2048, 32 KB at
4096, the same for every frame).  This script builds the two spectra
libraries (``framed_fwd``, ``framed_bwd``) three times from a copy of
``csrc/``, rewritten in the copy only:

- ``l2``: the source as it stands;
- ``smem``: B^ staged in shared memory once a block (m_pad float2 more a
  block, copied in by the block's threads before the first FFT), read
  from there;
- ``none``: no B^ read at all (the multiply by 1; wrong spectra, the
  time of a stage that would pay nothing for B^).

and times K5 (``fused.fused_fwd``) and K6 (``fused.fused_dwindow``) with
each at faithful mode's Bluestein shapes, by CUDA events (the median of 5
blocks of 10 calls after 3 warm-up calls), in turns in one process.  It
prints the card's name and power limit, whether ``smem`` gives ``l2``'s
results bit for bit, and one JSON line of times.  Needs one CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dmel_tpu_torch.ops import _cuda, framed, fused  # noqa: E402
from dmel_tpu_torch.ops.window import gaussian_window  # noqa: E402

#: (batch, T): faithful mode's Bluestein shapes of chip_smoke.py
SHAPES = ((32, 1021), (32, 2039), (512, 2039))

_READ = "__ldg(stage.bhat + (i & (mp - 1)))"
_SMEM_SIZE = ("  return 2 * sizeof(float2) * (size_t)fft_stage_frames(n_fft, "
              "stage) *\n         stage.m_pad;")
_FIRST_FFT = ("  const int mp = stage.m_pad;\n"
              "  float2* p = fft_frames(a, b, fr, 2 * mp, stage.plan, "
              "stage.table);")
VARIANTS = {
    "l2": [],
    "smem": [
        (_SMEM_SIZE, _SMEM_SIZE[:-1] + " + sizeof(float2) * stage.m_pad;"),
        # the callers pass their shared buffer's base as `a`; B^ goes
        # past both buffers, before fft_frames' first barrier
        (_FIRST_FFT, "  const int mp = stage.m_pad;\n"
                     "  float2* bh = a + 2 * fr * mp;\n"
                     "  for (int i = threadIdx.x; i < mp; i += FFT_THREADS)\n"
                     "    bh[i] = __ldg(stage.bhat + i);\n"
                     "  float2* p = fft_frames(a, b, fr, 2 * mp, stage.plan, "
                     "stage.table);"),
        (_READ, "bh[i & (mp - 1)]")],
    "none": [(_READ, "make_float2(1.f, 0.f)")],
}


def _variant_dir(root: Path, name: str) -> Path:
    src = root / name / "csrc"
    shutil.copytree(_cuda.SRC_DIR, src)
    header = src / "frame_fft.cuh"
    text = header.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    return src


def _use(src: Path):
    """Point `_cuda.load` at a variant's sources; forget loaded libs."""
    _cuda.SRC_DIR, _cuda.BUILD_DIR = src, src.parent / "build"
    _cuda._libs.clear()
    for name in ("framed_fwd", "framed_bwd"):
        _cuda.load(name)


def _ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    operands = []
    for b, t in SHAPES:
        x = torch.from_numpy(np.random.default_rng(t).standard_normal(
            (b, t)).astype(np.float32)).to(dev)
        g = framed.Geom(2 * t, 80, 64, 8000, 0.0, 4000.0)
        w = fused.pad_window(gaussian_window(
            torch.tensor(t / 5.0, device=dev), t), 2 * t)
        dmel = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (b, 64, t // 80 + 1)).astype(np.float32)).to(dev)
        operands.append((x, w, g, dmel))
    times, outputs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {name: _variant_dir(Path(tmp), name) for name in VARIANTS}
        for rnd in range(2):          # l2, smem, none, then again
            for name, src in srcs.items():
                _use(src)
                for (b, t), (x, w, g, dmel) in zip(SHAPES, operands):
                    out, reim = fused.fused_fwd(x, w, g)
                    dw = fused.fused_dwindow(x, reim, dmel, g)
                    outputs.setdefault(name, []).append((out, reim, dw))
                    key = f"{name} B{b}-T{t}"
                    k5 = _ms(lambda: fused.fused_fwd(x, w, g))
                    k6 = _ms(lambda: fused.fused_dwindow(x, reim, dmel, g))
                    times.setdefault(key, []).append(dict(k5_ms=k5,
                                                          k6_ms=k6))
    same = all(torch.equal(a, b) for ra, rb in zip(outputs["l2"],
                                                   outputs["smem"])
               for a, b in zip(ra, rb))
    print(f"smem variant bit for bit the l2 source: {same}", flush=True)
    print(json.dumps({"device": smi, "times_by_round": times}), flush=True)


if __name__ == "__main__":
    main()
