"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds),
loaded with ``ctypes``. The library is rebuilt when any source
is newer than it, so the first use on a fresh checkout builds it. It
lives under ``build/repro_torch/`` at the repository root, which git
ignores.

Nothing here runs at import time: the CPU tests import every module of
the port on hosts that have no ``nvcc``. The wrappers reach the library
through :func:`entry` and :func:`stream`, which build, load and bind
once and then cost a dict lookup and one C call per launch.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signature of every exported entry point: (argtypes, restype)
SIGNATURES = {
    # (x, scale, out, rows, d, eps, stream) -> cudaError_t
    "rmsnorm_f32": ((_P, _P, _P, _I, _I, _F, _P), _I),
    "rmsnorm_bf16": ((_P, _P, _P, _I, _I, _F, _P), _I),
    # (q, k, v, out, lse or null, dtype, b, sq, sk, h, kv, d, dv, causal,
    #  window, scale, stream) -> cudaError_t
    "flash_attention_fwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _P), _I),
    # (q, k, v, out, dout, lse, delta, dq, dk, dv, dtype, b, sq, sk, h, kv,
    #  d, dv, causal, window, scale, stream) -> cudaError_t
    "flash_attention_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _P), _I),
    # (q, k, v, out, dtype, b, smax, h, kv, d, dv, lo, hi, splits, chunk,
    #  head_groups, scale, stream) -> cudaError_t
    "decode_attention_fwd": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _P), _I),
    # (dtype, h, kv, d, dv, splits, head_groups, int *clusters)
    #  -> cudaError_t
    "decode_attention_max_clusters": ((_I, _I, _I, _I, _I, _I, _I,
                                       ctypes.POINTER(_I)), _I),
    # (dt, x, b, c, a, h0, y, h_out, dtype, batch, len, d, n, stream)
    #  -> cudaError_t
    "mamba_scan_fwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P), _I),
    # (dtype, batch, len, d, n, int *grid, int *ctas_per_sm) -> cudaError_t
    "mamba_scan_plan": ((_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                         ctypes.POINTER(_I)), _I),
    # (dt, x, b, c, a, h0, dy, dh, ddt, dx, db, dc, da, dh0, work, dtype,
    #  batch, len, d, n, stream) -> cudaError_t
    "mamba_scan_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _I, _I, _I, _I, _I, _P), _I),
    # (batch, len, d, n, long long *floats) -> cudaError_t
    "mamba_scan_bwd_workspace": ((_I, _I, _I, _I, ctypes.POINTER(_L)), _I),
    # (dtype, batch, len, d, n, int *grid, int *ctas_per_sm) -> cudaError_t
    "mamba_scan_bwd_plan": ((_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                             ctypes.POINTER(_I)), _I),
    # (ready, k, luts, lut_stride, eff, timeout, pools, pool_cap, lanes,
    #  out, batches, n_batches, base_last, arrivals, rpc, stream)
    #  -> cudaError_t
    "sim_fill_static": ((_P, _L, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                         _P, _P, _D, _P), _I),
    # (ready, k, lut, eff, timeout_s, pool, n_free, ev_t, ev_d, m, rem_t,
    #  trips, done, batches, n_batches, stream) -> cudaError_t
    "sim_fill_dynamic": ((_P, _L, _P, _L, _D, _P, _L, _P, _P, _L, _P, _L,
                          _P, _P, _P, _P), _I),
    # (rows, k, seg, m, lanes, r0, r1, out, stream) -> cudaError_t
    "sim_select": ((_P, _L, _P, _L, _I, _L, _L, _P, _P), _I),
    # (k, m, lanes, int *path, int *cluster, int *smem, int *resident)
    #  -> cudaError_t
    "sim_select_plan": ((_L, _L, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                         ctypes.POINTER(_I), ctypes.POINTER(_I)), _I),
    "repro_cuda_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_entries: Dict[str, Callable] = {}     # bound entry points, by name
build_log = ""        # ptxas resource report of the last build


class LaunchCounter:
    """Launches of one kernel. Its wrapper calls ``add`` where it launches
    the kernel and nowhere else, so a run can show that it went through
    it. ``add`` is ``itertools.count.__next__``: one C call that no other
    thread can interleave, so the executor's threads may launch at once
    with no lock on the launch path. A CUDA graph replay runs no wrapper:
    its caller adds the launches the graph's capture counted with
    ``add_many(k)``, which takes a lock of its own and is as safe from
    several threads as ``add``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self._ticks = itertools.count()
        self.add = self._ticks.__next__
        self._many = 0

    def add_many(self, k: int) -> None:
        with self._lock:
            self._many += k

    @property
    def count(self) -> int:
        # repr is "count(n)", n the next value: the calls so far
        return int(repr(self._ticks)[len("count("):-1]) + self._many


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


def fresh() -> bool:
    """Whether the shared library exists and is newer than every source."""
    out = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime
                 for p in sources() + sorted(CSRC.glob("*.cuh")))
    return out.exists() and out.stat().st_mtime >= newest


def build() -> Path:
    """Compile every source into the shared library unless it is newer
    than all of them. Returns its path."""
    global build_log
    out = BUILD_DIR / LIB_NAME
    srcs = sources()
    if fresh():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[1] for proc in procs]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    try:
        for cmd, proc, err in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:"
                                   f"\n{' '.join(cmd)}\n{err}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {link.returncode}:\n"
                               f"{' '.join(cmd)}\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)      # atomic: a concurrent loader sees old or new
    build_log = "".join(logs)
    return out


def load(rebuild: bool = True) -> ctypes.CDLL:
    """Build if stale, then load the library once per process. With
    ``rebuild=False`` a missing or stale library raises instead: a
    serving worker process loads the build its parent made and never
    starts ``nvcc`` itself."""
    global _lib
    with _lock:
        if _lib is None:
            if not rebuild and not fresh():
                raise RuntimeError(
                    f"{BUILD_DIR / LIB_NAME} is missing or older than its "
                    f"sources: build it (kernels._build.build()) before "
                    f"starting worker processes")
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def entry(name: str) -> Callable:
    """The C entry point ``name`` with its signature set. The first call
    builds and loads the library; later ones are a dict lookup, with no
    lock."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, getattr(load(), name))
    return fn


def stream(device_index: int) -> int:
    """The raw handle of the current CUDA stream of a device, read
    without building a ``torch.cuda.Stream`` object (PyTorch's own
    kernel launchers read it the same way)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(rc: int, kernel: str) -> None:
    """Raise on a launch the runtime refused (it would never run, and
    ``torch.cuda.synchronize()`` would not report it)."""
    if rc != 0:
        msg = load().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
