"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface.  It is
compiled at first use by ``nvcc`` into a shared library and loaded with
``ctypes``; PyTorch's extension builder is not used, so a build takes
seconds, needs no PyTorch headers and leaves no lock file behind.

The library lands in ``dmel_tpu_torch/_build/`` under a name keyed by a
hash of its source, the ``csrc/*.cuh`` headers and the flags.  It is compiled to a temporary name and
renamed into place, so a half-written library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds one nvcc run may take before the build is declared failed
BUILD_TIMEOUT_S = 240


class Lib(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    seconds: float      # build time; 0.0 when the library was already built
    log: str            # nvcc's output, with ptxas's register lines


_libs: dict[str, Lib] = {}


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _build(name: str) -> tuple[Path, float, str]:
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name}: nvcc timed out\n{e.output}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout


def load(name: str) -> Lib:
    """The library of ``csrc/<name>.cu``, built if needed; raises if
    ``nvcc`` fails."""
    lib = _libs.get(name)
    if lib is None:
        path, seconds, log = _build(name)
        lib = _libs[name] = Lib(ctypes.CDLL(str(path)), path, seconds, log)
    return lib


def plan_args(radices: tuple[int, ...] | None):
    """A spectra stage's two C arguments: the FFT plan's radices as a
    ctypes int array and their count, or ``(None, -1)`` for the direct
    DFT."""
    if radices is None:
        return None, -1
    return (ctypes.c_int * len(radices))(*radices), len(radices)
