"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by one ``nvcc`` call into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), loaded with ``ctypes``. The library is rebuilt when any source
is newer than it, so the first use on a fresh checkout builds it. It
lives under ``build/repro_torch/`` at the repository root, which git
ignores.

Nothing here runs at import time: the CPU tests import every module of
the port on hosts that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported entry point: (argtypes, restype)
SIGNATURES = {
    # (x, scale, out, rows, d, eps, stream) -> cudaError_t
    "rmsnorm_f32": ((_P, _P, _P, _I, _I, _F, _P), _I),
    "rmsnorm_bf16": ((_P, _P, _P, _I, _I, _F, _P), _I),
    # (q, k, v, out, dtype, b, sq, sk, h, kv, d, dv, causal, window,
    #  scale, stream) -> cudaError_t
    "flash_attention_fwd": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F, _P), _I),
    "repro_cuda_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""        # ptxas resource report of the last build


class LaunchCounter:
    """Launches of one kernel. Its wrapper adds one where it launches the
    kernel and nowhere else, so a run can show that it went through it."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built with the "
            "CUDA toolkit on the machine that has the GPU")
    return nvcc


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile every source into the shared library unless it is newer
    than all of them. Returns its path."""
    global build_log
    out = BUILD_DIR / LIB_NAME
    srcs = sources()
    newest = max(p.stat().st_mtime
                 for p in srcs + sorted(CSRC.glob("*.cuh")))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees old or new
    build_log = proc.stderr
    return out


def load() -> ctypes.CDLL:
    """Build if stale, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise on a launch the runtime refused (it would never run, and
    ``torch.cuda.synchronize()`` would not report it)."""
    if rc != 0:
        msg = load().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
