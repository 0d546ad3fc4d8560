#!/usr/bin/env python3
"""Where K5's and K6's Bluestein stage spends its time, phase by phase,
and whether this tree's kernels give a parent commit's results.

    mkdir -p _archive/parent && git archive <commit> dmel_tpu_torch/csrc \\
        | tar -x -C _archive/parent
    python3 tools/bluestein_split.py [--parent _archive/parent/dmel_tpu_torch/csrc]

Builds the spectra libraries (``framed_fwd``, ``framed_bwd``, and
``specband_fwd`` for K1) from copies of two ``csrc/`` trees: this
package's ("new") and, where ``--parent`` exists, the parent commit's
("parent", which reads Bluestein's tables in the parent's layout:
``fft_plan.table_np(2 m_pad)`` and ``bluestein_kernel_np``).  Each tree
is built as it stands ("plain") and with ``clock64()`` stamps compiled
into the copy only ("split"): at each phase boundary of the Bluestein
stage a barrier, then thread 0 adds the cycles since the last stamp to
its block's count of that phase; the counts of all blocks are summed.
A phase's share of the summed cycles, times the plain kernel's time, is
its time.  The parent is also built with its P-point stages' twiddles
read from the first 512 entries of their table ("tw_l1": the same loads,
all in L1; wrong results, timing only), which says how much the
twiddle table's reads from L2 cost.  This tree is also built with K5's
Bluestein kernel built for 4 blocks an SM, not 3 ("fwd4"), K6's for 3 and
4, not 2 ("bwd3", "bwd4"; its grid with it), and with every
stage boundary of its Bluestein stage fenced off from the compiler's
fusing of multiplies and adds ("fenced", see ``REGISTERS``).

At faithful mode's B 512 x 2039 and B 512 x 1021 (m_pad 4096 and 2048;
win T, n_fft 2 T, lambda T / 5, hop 80, 64 mels) it times K5
(``fused.fused_fwd``) and K6 (``fused.fused_dwindow``) of every build by
CUDA events (the median of 5 blocks of 10 calls after 3 warm-up calls),
in turns in one process (parent, new, new, parent), and prints:

- the card's name and power limit (nvidia-smi);
- ptxas's registers, spills and shared bytes of K5's and K6's
  instantiations in each tree;
- each build's times and each tree's split;
- whether each new build's K5 Re|Im and mel and K6 dw are the parent's
  bit for bit at both shapes, and how far from them (of their largest
  entry, and the share of Re|Im entries that differ), and whether the
  planned K5 and K6 (2048, 4096, faithful 3000), K1 (1024, 4096), K3
  (512, 1024) and K4 (512, 1024) are the parent's bit for bit;
- one JSON line of all of it, also written to
  ``chiprun_out/bluestein_split.json``.

Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dmel_tpu_torch.ops import (_cuda, fft_plan, framed, fused,  # noqa: E402
                                specband)
from dmel_tpu_torch.ops.window import gaussian_window  # noqa: E402

#: (batch, T): faithful mode's Bluestein shapes at real work
SHAPES = ((512, 2039), (512, 1021))
LIBS = ("framed_fwd", "framed_bwd", "specband_fwd")

_STAMPS = r"""
constexpr int SPLIT_PHASES = 16;
__device__ unsigned long long split_cycles[SPLIT_PHASES];
__shared__ long long split_last;
__shared__ unsigned long long split_acc[SPLIT_PHASES];
__device__ __forceinline__ void split_begin() {
  if (threadIdx.x == 0) {
    for (int k = 0; k < SPLIT_PHASES; ++k) split_acc[k] = 0;
    split_last = clock64();
  }
}
__device__ __forceinline__ void split_stamp(int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long now = clock64();
    split_acc[k] += now - split_last;
    split_last = now;
  }
}
__device__ __forceinline__ void split_end() {
  if (threadIdx.x == 0)
    for (int k = 0; k < SPLIT_PHASES; ++k)
      atomicAdd(&split_cycles[k], split_acc[k]);
}
"""
_READER = r"""
extern "C" int split_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, split_cycles,
                                       sizeof(split_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long zero[SPLIT_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(split_cycles, zero,
                                             sizeof(zero)));
}
"""

# the ping-pong design (a Stockham stage a pass through two shared-memory
# buffers): the
# stamps' places, each an (old, new) pair of one file of the copy
_PP_FFT = "frame_fft.cuh"
PINGPONG = {
    "phases": {0: "load with chirp (K6: pre-pass with chirp)", 1: "FFT 1",
               2: "B^ pass", 3: "FFT 2", 4: "chirp post-pass",
               5: "residual write", 6: "mel projection", 7: "dP and Y",
               8: "dw sums", 9: "block partial"},
    "split": [
        (_PP_FFT,
         "  const int mp = stage.m_pad;\n"
         "  float2* p = fft_frames(a, b, fr, 2 * mp, stage.plan, "
         "stage.table);\n",
         "  split_stamp(0);\n  const int mp = stage.m_pad;\n"
         "  float2* p = fft_frames(a, b, fr, 2 * mp, stage.plan, "
         "stage.table);\n  split_stamp(1);\n"),
        (_PP_FFT, "  float2* o = p == a ? b : a;\n",
         "  split_stamp(2);\n  float2* o = p == a ? b : a;\n"),
        (_PP_FFT,
         "  o = q == p ? o : p;             // the buffer the stages left "
         "free\n",
         "  o = q == p ? o : p;\n  split_stamp(3);\n"),
        (_PP_FFT, "  __syncthreads();\n  return o;\n}",
         "  split_stamp(4);\n  return o;\n}"),
        ("framed_fwd.cu",
         "  const int span = BLUESTEIN ? stage.m_pad : m;\n"
         "  const int row0 = blockIdx.x * fr;\n",
         "  const int span = BLUESTEIN ? stage.m_pad : m;\n"
         "  const int row0 = blockIdx.x * fr;\n  split_begin();\n"),
        ("framed_fwd.cu",
         "  __syncthreads();\n  mel_project<FFT_THREADS>(p, fb, mel_lo, "
         "mel_hi, out, row0, fr, rows, nfr,\n"
         "                           n_bins, n_mels);\n}",
         "  split_stamp(5);\n  mel_project<FFT_THREADS>(p, fb, mel_lo, "
         "mel_hi, out, row0, fr, rows, nfr,\n"
         "                           n_bins, n_mels);\n"
         "  split_stamp(6);\n  split_end();\n}"),
        ("framed_bwd.cu", "  const int n_groups = (rows + fr - 1) / fr;\n",
         "  const int n_groups = (rows + fr - 1) / fr;\n  split_begin();\n"),
        ("framed_bwd.cu",
         "      y[f * m + k] = v;\n    });\n    __syncthreads();\n",
         "      y[f * m + k] = v;\n    });\n    split_stamp(7);\n"),
        ("framed_bwd.cu",
         "                        acc[s]);\n      }\n    }\n  }\n",
         "                        acc[s]);\n      }\n    }\n"
         "    split_stamp(8);\n  }\n"),
        ("framed_bwd.cu",
         "    partials[(size_t)mm * gridDim.x + blockIdx.x] = v;\n  }\n}",
         "    partials[(size_t)mm * gridDim.x + blockIdx.x] = v;\n  }\n"
         "  split_stamp(9);\n  split_end();\n}"),
    ],
    "tw_l1": [
        (_PP_FFT,
         "                 : cmul(src[r * stride], fft_tw(tab, n, r * t));",
         "                 : cmul(src[r * stride], "
         "fft_tw(tab, n, (r * t) & 511));"),
    ],
}
# this design (register-resident passes, one padded buffer): the stamps'
# places; "fwd4" builds K5's Bluestein kernel for 4 blocks an SM, not 3,
# "bwd3" and "bwd4" K6's for 3 and 4, not 2 (its grid with it)
_REG_FFT = "frame_fft.cuh"
REGISTERS = {
    "phases": {0: "FFT 1 pass 1 with the load and chirp (K6: pre-pass)",
               1: "FFT 1 middle pass", 2: "FFT 1 last pass, B^, FFT 2 "
               "pass 1", 3: "FFT 2 middle pass", 4: "FFT 2 last pass, "
               "chirp, output", 5: "residual write", 6: "mel projection",
               7: "dP and Y", 8: "dw sums", 9: "block partial"},
    "split": [
        (_REG_FFT,
         "    __syncthreads();                 // the load's reads of buf are "
         "done\n    bl_write<4, 4>(v, fb, i0, q16, 1);\n"
         "    __syncthreads();\n",
         "    __syncthreads();\n    bl_write<4, 4>(v, fb, i0, q16, 1);\n"
         "    split_stamp(0);\n"),
        (_REG_FFT,
         "    bl_read<R1, R2>(v, fb, i0, q16);\n    __syncthreads();\n",
         "    split_stamp(1);\n    bl_read<R1, R2>(v, fb, i0, q16);\n"
         "    __syncthreads();\n"),
        (_REG_FFT,
         "  if (n_mid >= 0) {\n    bl_write<4, 4>(v, fb, i0, q16, 1);\n"
         "    __syncthreads();\n",
         "  if (n_mid >= 0) {\n    bl_write<4, 4>(v, fb, i0, q16, 1);\n"
         "    split_stamp(2);\n"),
        (_REG_FFT,
         "    bl_read<R1, R2>(v, fb, i0, q16);\n"
         "    bl_pass<R1, R2, false>(v, i0, q16, l, tw);\n  }\n",
         "    split_stamp(3);\n    bl_read<R1, R2>(v, fb, i0, q16);\n"
         "    bl_pass<R1, R2, false>(v, i0, q16, l, tw);\n  }\n"),
        (_REG_FFT,
         "  bl_out<R1, R2>(v, buf + f * m, i0, q16, m, chirp_t);\n"
         "  __syncthreads();\n}",
         "  bl_out<R1, R2>(v, buf + f * m, i0, q16, m, chirp_t);\n"
         "  split_stamp(4);\n}"),
        ("framed_fwd.cu",
         "  // fr x (m_pad + m_pad / 16) points\n"
         "  extern __shared__ __align__(16) float2 fft_buf[];\n",
         "  // fr x (m_pad + m_pad / 16) points\n"
         "  extern __shared__ __align__(16) float2 fft_buf[];\n"
         "  split_begin();\n"),
        ("framed_fwd.cu",
         "  __syncthreads();\n  mel_project_t<FFT_THREADS>(",
         "  split_stamp(5);\n  mel_project_t<FFT_THREADS>("),
        ("framed_fwd.cu",
         "                             nfr, n_bins, n_mels);\n}",
         "                             nfr, n_bins, n_mels);\n"
         "  split_stamp(6);\n  split_end();\n}"),
        ("framed_bwd.cu", "  const int n_groups = (rows + fr - 1) / fr;\n",
         "  const int n_groups = (rows + fr - 1) / fr;\n  split_begin();\n"),
        ("framed_bwd.cu",
         "      });\n    }\n    __syncthreads();\n    const float* z;",
         "      });\n    }\n    split_stamp(7);\n    const float* z;"),
        ("framed_bwd.cu",
         "                          sign * z[s * FFT_THREADS + threadIdx.x], "
         "acc[s]);\n          }\n        }\n      }\n    }\n",
         "                          sign * z[s * FFT_THREADS + threadIdx.x], "
         "acc[s]);\n          }\n        }\n      }\n    }\n"
         "    split_stamp(8);\n"),
        ("framed_bwd.cu",
         "    partials[(size_t)mm * gridDim.x + blockIdx.x] = v;\n  }\n}",
         "    partials[(size_t)mm * gridDim.x + blockIdx.x] = v;\n  }\n"
         "  split_stamp(9);\n  split_end();\n}"),
    ],
    "fwd4": [
        (_REG_FFT, "constexpr int BLUESTEIN_FWD_BLOCKS = 3;",
         "constexpr int BLUESTEIN_FWD_BLOCKS = 4;"),
    ],
    "bwd3": [
        (_REG_FFT, "constexpr int BLUESTEIN_BWD_BLOCKS = 2;",
         "constexpr int BLUESTEIN_BWD_BLOCKS = 3;"),
        ("framed_bwd.cu", "constexpr int DW_BLOCKS_BLUESTEIN = 264;",
         "constexpr int DW_BLOCKS_BLUESTEIN = 396;"),
    ],
    "bwd4": [
        (_REG_FFT, "constexpr int BLUESTEIN_BWD_BLOCKS = 2;",
         "constexpr int BLUESTEIN_BWD_BLOCKS = 4;"),
        ("framed_bwd.cu", "constexpr int DW_BLOCKS_BLUESTEIN = 264;",
         "constexpr int DW_BLOCKS_BLUESTEIN = 528;"),
    ],
}
# "fenced": this design with each stage's outputs, the chirp products and
# the hand-over passed through an opaque register move, and input 0 of
# every stage past the first multiplied by twiddle entry 0 (exactly 1) read
# from memory: each butterfly the expression the ping-pong kernel compiled,
# which says whether the compiler's fusing of multiplies and adds across
# stages is what makes the results differ from the ping-pong design's in
# their last bits
REGISTERS["fenced"] = [
    (_REG_FFT, "// a point's place in its frame's buffer",
     "__device__ __forceinline__ float2 bl_opaque(float2 v) {\n"
     "  asm(\"mov.b32 %0, %0;\" : \"+f\"(v.x));\n"
     "  asm(\"mov.b32 %0, %0;\" : \"+f\"(v.y));\n  return v;\n}\n"
     "// a point's place in its frame's buffer"),
    (_REG_FFT, "    v[c] = n < m ? cmul(load(f, n), __ldg(chirp_t + n))",
     "    v[c] = n < m ? bl_opaque(cmul(load(f, n), __ldg(chirp_t + n)))"),
    (_REG_FFT, "        t[c] = make_float2(b.x, -b.y);",
     "        t[c] = bl_opaque(make_float2(b.x, -b.y));"),
    (_REG_FFT,
     "        for (int r = 1; r < R1; ++r) a[r * R2] = cmul(a[r * R2], w1[r]);",
     "        a[0] = cmul(a[0], __ldg(tw));\n"
     "        for (int r = 1; r < R1; ++r) a[r * R2] = cmul(a[r * R2], w1[r]);"),
    (_REG_FFT,
     "        for (int rr = 1; rr < R2; ++rr)\n"
     "          a[rr] = cmul(a[rr], bl_tw(tw, ll, rr, q * l + k));",
     "        a[0] = cmul(a[0], __ldg(tw));\n"
     "        for (int rr = 1; rr < R2; ++rr)\n"
     "          a[rr] = cmul(a[rr], bl_tw(tw, ll, rr, q * l + k));"),
    (_REG_FFT, "  a3 = make_float2(t1.x - t3.y, t1.y + t3.x);\n}",
     "  a3 = make_float2(t1.x - t3.y, t1.y + t3.x);\n"
     "  a0 = bl_opaque(a0); a1 = bl_opaque(a1); a2 = bl_opaque(a2);\n"
     "  a3 = bl_opaque(a3);\n}"),
    (_REG_FFT, "  a3 = make_float2(t0.x - t2.y, t0.y + t2.x);\n}",
     "  a3 = make_float2(t0.x - t2.y, t0.y + t2.x);\n"
     "  a0 = bl_opaque(a0); a1 = bl_opaque(a1); a2 = bl_opaque(a2);\n"
     "  a3 = bl_opaque(a3);\n}"),
    (_REG_FFT, "  a1 = make_float2(t.x - a1.x, t.y - a1.y);\n}",
     "  a1 = make_float2(t.x - a1.x, t.y - a1.y);\n"
     "  a0 = bl_opaque(a0); a1 = bl_opaque(a1);\n}"),
]
DESIGNS = {"pingpong": PINGPONG, "registers": REGISTERS}


def design_of(src: Path) -> str:
    """Which stage design a csrc/ tree holds, read from its header."""
    text = (src / "frame_fft.cuh").read_text()
    return "pingpong" if "float2* p = fft_frames(a, b, fr, 2 * mp" in text \
        else "registers"


def _patched_copy(src: Path, dst: Path, variant: str) -> Path:
    """A copy of ``src`` with the variant's edits; "split" also gets the
    stamps and their reader."""
    shutil.copytree(src, dst)
    if variant == "plain":
        return dst
    for name, old, new in DESIGNS[design_of(src)][variant]:
        path = dst / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: {name} no longer holds {old!r}")
        path.write_text(text.replace(old, new))
    if variant == "split":
        header = dst / "frame_fft.cuh"
        header.write_text(_STAMPS + header.read_text())
        for name in ("framed_fwd.cu", "framed_bwd.cu"):
            with open(dst / name, "a") as f:
                f.write(_READER)
    return dst


def _nvcc(src: Path, name: str) -> tuple[Path, str]:
    out = src.parent / "build" / f"lib{name}.so"
    out.parent.mkdir(exist_ok=True)
    proc = subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out),
                           str(src / f"{name}.cu")], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=_cuda.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src}/{name}: {proc.stdout}")
    return out, proc.stdout


def ptxas_lines(log: str, marker: str) -> list[str]:
    """ptxas's lines for the entries whose mangled name holds
    ``marker``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = marker in line
        if keep and ("registers" in line or "spill" in line
                     or "Compiling entry" in line):
            lines.append(line.strip())
    return lines


_FWD_LIB = framed._fwd_lib


class _NoFbT:
    """A forward library whose entries take no ``fb_t`` (the ping-pong
    design's): drops
    the fifth argument of the calls ``framed.launch_fwd`` makes."""

    def __init__(self, cdll):
        self.cdll = cdll

    def __getattr__(self, name):
        fn = getattr(self.cdll, name)
        if name in ("framed_fwd", "fused_fwd"):
            return lambda *a: fn(*a[:4], *a[5:])
        return fn


def _fwd_lib_no_fb_t():
    lib = _cuda.load("framed_fwd").cdll
    for entry in (lib.framed_fwd, lib.fused_fwd):
        entry.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                          + framed._STAGE_ARGTYPES + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
    lib.framed_fwd_error_string.argtypes = [ctypes.c_int]
    lib.framed_fwd_error_string.restype = ctypes.c_char_p
    return _NoFbT(lib)


class Build:
    """One tree's libraries, and the host code that drives them."""

    def __init__(self, src: Path, stage_args):
        self.src, self.stage_args = src, stage_args
        self.libs, self.logs = {}, {}
        self.fwd_lib = (_FWD_LIB if "fb_t" in (src / "framed_fwd.cu")
                        .read_text() else _fwd_lib_no_fb_t)

    def use(self):
        """Point the wrappers at this build's libraries."""
        def load(name):
            return self.libs[name]
        _cuda.load = load
        framed._stage_args = self.stage_args
        framed._fwd_lib = self.fwd_lib


@functools.lru_cache(maxsize=8)
def _parent_tables(n_fft: int, m_pad: int, device: torch.device):
    return (torch.tensor(fft_plan.table_np(2 * m_pad), device=device),
            torch.tensor(fft_plan.bluestein_kernel_np(n_fft, m_pad),
                         device=device))


def parent_stage_args(stage, n_fft: int, device: torch.device):
    """The ping-pong design's five stage arguments: Bluestein's ``(2, 2
    m_pad)`` table
    and ``FFT(b) / m_pad``."""
    if isinstance(stage, fft_plan.Bluestein):
        table, bhat = _parent_tables(n_fft, stage.m_pad, device)
        return (*_cuda.plan_args(stage.radices), stage.m_pad,
                table.data_ptr(), bhat.data_ptr())
    return (*_cuda.plan_args(stage), 0, None, None)


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


def _operands(dev, b: int, t: int):
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (b, t)).astype(np.float32)).to(dev)
    g = framed.Geom(2 * t, 80, 64, 8000, 0.0, 4000.0)
    w = fused.pad_window(gaussian_window(torch.tensor(t / 5.0, device=dev),
                                         t), 2 * t)
    nfr = t // 80 + 1
    dmel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, 64, nfr)).astype(np.float32)).to(dev)
    return x, w, g, dmel


def _k5_k6(x, w, g, dmel):
    out, reim = fused.fused_fwd(x, w, g)
    return out, reim, fused.fused_dwindow(x, reim, dmel, g)


def _others(dev) -> dict:
    """The outputs that must not move: planned K5 and K6, K1, K3, K4."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 16000)).astype(
        np.float32)).to(dev)
    res = {}
    for n_fft, win, lam in ((2048, 2048, 300.0), (4096, 4096, 600.0),
                            (3000, 1500, 300.0)):
        g = framed.Geom(n_fft, 80, 64, 8000, 0.0, 4000.0)
        w = fused.pad_window(gaussian_window(
            torch.tensor(lam, device=dev), win), n_fft)
        dmel = torch.from_numpy(rng.standard_normal(
            (8, 64, 201)).astype(np.float32)).to(dev)
        res[f"K5/K6 {n_fft}"] = _k5_k6(x, w, g, dmel)
    for n_fft, lam in ((1024, 128.0), (4096, 400.0)):
        w = gaussian_window(torch.tensor(lam, device=dev), n_fft)
        res[f"K1 {n_fft}"] = (specband.specband_mel_power(
            x, w, n_fft=n_fft, hop_length=80, n_mels=64, sample_rate=8000),)
    for n_fft, lam in ((512, 46.7), (1024, 150.0)):
        g = framed.Geom(n_fft, 80, 64, 8000, 0.0, 4000.0)
        w = gaussian_window(torch.tensor(lam, device=dev), n_fft)
        out, reim = framed.framed_fwd(x, w, g)
        dmel = torch.from_numpy(rng.standard_normal(
            tuple(out.shape)).astype(np.float32)).to(dev)
        res[f"K3/K4 {n_fft}"] = (out, reim,
                                 framed.framed_dwindow(x, reim, dmel, g))
    torch.cuda.synchronize()
    return res


def _split(build: Build, fn, name: str) -> dict:
    """Each phase's share of the summed block cycles of one call."""
    lib = build.libs[name].cdll
    lib.split_read.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * 16)()
    fn()
    torch.cuda.synchronize()
    lib.split_read(cycles)            # clears the warm-up's counts
    fn()
    torch.cuda.synchronize()
    rc = lib.split_read(cycles)
    if rc != 0:
        raise RuntimeError(f"split_read: {rc}")
    total = sum(cycles)
    return {k: cycles[k] / total for k in range(16) if cycles[k]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    default=ROOT / "_archive/parent/dmel_tpu_torch/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    trees = {"new": (_cuda.SRC_DIR, framed._stage_args)}
    if args.parent.is_dir():
        trees = {"parent": (args.parent, parent_stage_args), **trees}
    else:
        print(f"no parent tree at {args.parent}: the new tree alone",
              flush=True)
    report = {"device": smi, "ptxas": {}, "ms": {}, "split": {},
              "phases": {}, "bit_identical": {},
              "err_of_parent_max": {}}
    with tempfile.TemporaryDirectory() as tmp:
        builds, jobs = {}, []
        for tree, (src, stage_args) in trees.items():
            variants = ["plain", "split"] + [
                v for v in ("tw_l1", "fwd4", "bwd3", "bwd4", "fenced")
                if v in DESIGNS[design_of(src)]]
            for variant in variants:
                copy = _patched_copy(src, Path(tmp) / f"{tree}-{variant}"
                                     / "csrc", variant)
                build = builds[tree, variant] = Build(copy, stage_args)
                names = LIBS if variant == "plain" else LIBS[:2]
                jobs += [(build, name) for name in names]
            report["phases"][tree] = DESIGNS[design_of(src)]["phases"]
        with ThreadPoolExecutor(8) as ex:
            built = list(ex.map(lambda j: _nvcc(j[0].src, j[1]), jobs))
        for (build, name), (path, log) in zip(jobs, built):
            build.libs[name] = _cuda.Lib(ctypes.CDLL(str(path)), path, 0.0,
                                         log)
            build.logs[name] = log
        for tree in trees:
            b = builds[tree, "plain"]
            lines = (ptxas_lines(b.logs["framed_fwd"], "fused_")
                     + ptxas_lines(b.logs["framed_bwd"],
                                   "adjoint_fft_dw_kernel"))
            report["ptxas"][tree] = lines
            print(f"{tree} ptxas:", *lines, sep="\n  ", flush=True)

        operands = {f"B{b}-T{t}": _operands(dev, b, t) for b, t in SHAPES}
        outputs = {}
        order = list(builds)
        for rnd in range(2):
            for key in (order if rnd == 0 else order[::-1]):
                build = builds[key]
                build.use()
                name = "-".join(key)
                for shape, (x, w, g, dmel) in operands.items():
                    out, reim, dw = _k5_k6(x, w, g, dmel)
                    torch.cuda.synchronize()
                    if rnd == 0:
                        outputs[key, shape] = (out, reim, dw)
                    k5 = _ms(lambda: fused.fused_fwd(x, w, g))
                    k6 = _ms(lambda: fused.fused_dwindow(x, reim, dmel, g))
                    report["ms"].setdefault(f"{name} {shape}", []).append(
                        {"k5_ms": k5, "k6_ms": k6})
                    print(f"round {rnd} {name} {shape}: K5 {k5:.4f} ms, "
                          f"K6 {k6:.4f} ms", flush=True)
        for tree in trees:
            build = builds[tree, "split"]
            build.use()
            for shape, (x, w, g, dmel) in operands.items():
                _, reim, _ = outputs[(tree, "plain"), shape]
                report["split"][f"{tree} {shape}"] = {
                    "k5": _split(build, lambda: fused.fused_fwd(x, w, g),
                                 "framed_fwd"),
                    "k6": _split(build, lambda: fused.fused_dwindow(
                        x, reim, dmel, g), "framed_bwd")}
        if "parent" in trees:
            for key in builds:
                if key[0] != "new" or key[1] in ("split", "tw_l1"):
                    continue
                name = "-".join(key)
                for shape in operands:
                    want = outputs[("parent", "plain"), shape]
                    got = outputs[key, shape]
                    report["bit_identical"][
                        f"{name} K5 Re|Im, log-mel {shape}"] = all(
                        torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
                    report["bit_identical"][f"{name} K6 dw {shape}"] = \
                        torch.equal(got[2], want[2])
                    report["err_of_parent_max"][f"{name} {shape}"] = {
                        what: float((a - b).abs().max() / b.abs().max())
                        for what, a, b in zip(("mel", "Re|Im", "dw"),
                                              got, want)}
                    report["err_of_parent_max"][f"{name} {shape}"][
                        "Re|Im share differing"] = float(
                        (got[1] != want[1]).float().mean())
            others = {}
            for tree in trees:
                builds[tree, "plain"].use()
                others[tree] = _others(dev)
            for key, got in others["new"].items():
                report["bit_identical"][key] = all(
                    torch.equal(a, b) for a, b in zip(got,
                                                      others["parent"][key]))
    for key, shares in report["split"].items():
        tree, shape = key.split(" ")
        plain = report["ms"][f"{tree}-plain {shape}"]
        for kern in ("k5", "k6"):
            ms = float(np.mean([r[f"{kern}_ms"] for r in plain]))
            names = report["phases"][tree]
            print(f"{key} {kern.upper()} ({ms:.4f} ms):", ", ".join(
                f"{names.get(k, k)} {s * 100:.1f} % ({s * ms:.4f} ms)"
                for k, s in shares[kern].items()), flush=True)
    for key, same in report["bit_identical"].items():
        print(f"bit for bit the parent's: {key}: {same}", flush=True)
    for key, errs in report["err_of_parent_max"].items():
        print(f"{key} against the parent, of its largest entry: " + ", ".join(
            f"{what} {err:.3e}" for what, err in errs.items()), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bluestein_split.json").write_text(json.dumps(report))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
