"""Selective scan of the Mamba block: the CUDA kernel
``csrc/mamba_scan.cu`` and its wrapper.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan``. A
tensor on the CPU takes the plain version (:func:`ref.mamba_scan_ref`);
a CUDA tensor launches the kernel or raises, and refuses under grad
(the kernel has no backward yet). The kernel takes any
sequence length in one launch (the state is carried through ``h0``
between calls), so it has no chunk argument: the reference's model path
calls its kernel with ``chunk = L`` too.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (8, 16, 32, 64)     # N: one register array per thread

counter = _build.LaunchCounter()


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B,L,D); b, c: (B,L,N); a: (D,N); h0: (B,D,N) float32.
    Returns (y (B,L,D) in x's dtype, h_last (B,D,N) float32)."""
    if dt.device.type == "cpu":
        return ref.mamba_scan_ref(dt, x, b, c, a, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {dt.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, x, b, c, a, h0)):
        raise NotImplementedError(
            "mamba_scan has no backward kernel yet, so the hybrid does not "
            "train on the card (ROADMAP A14); the plain version on the CPU "
            "is differentiable")
    return _launch(dt, x, b, c, a, h0)


def _launch(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, a: torch.Tensor,
            h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if dt.dim() != 3:
        raise ValueError("mamba_scan takes (B, L, D) dt and x")
    bsz, length, d = dt.shape
    n = a.shape[-1] if a.dim() == 2 else -1
    if x.shape != dt.shape or b.shape != (bsz, length, n) or \
            c.shape != b.shape or a.shape != (d, n) or \
            h0.shape != (bsz, d, n):
        raise ValueError(
            f"mamba_scan: shapes dt {tuple(dt.shape)} x {tuple(x.shape)} "
            f"b {tuple(b.shape)} c {tuple(c.shape)} a {tuple(a.shape)} "
            f"h0 {tuple(h0.shape)} disagree")
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel takes a state size N in "
                         f"{STATE_SIZES}, got {n}")
    if length < 1:
        raise ValueError("mamba_scan kernel needs L >= 1")
    dtype = KERNEL_DTYPES.get(x.dtype)
    if dtype is None or not (dt.dtype == b.dtype == c.dtype == x.dtype):
        raise TypeError(f"mamba_scan kernel takes float32 or bfloat16 dt, "
                        f"x, b, c of one dtype, got {dt.dtype}, {x.dtype}, "
                        f"{b.dtype}, {c.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"mamba_scan kernel carries a float32 state, got "
                        f"h0 {h0.dtype}")
    if not all(t.device == dt.device for t in (x, b, c, a, h0)):
        raise ValueError("mamba_scan: inputs on different devices")
    a = a.to(torch.float32).contiguous()          # (D, N): small
    if not all(t.is_contiguous() for t in (dt, x, b, c, h0)):
        raise ValueError("mamba_scan kernel needs contiguous dt, x, b, c "
                         "and h0")
    if (a.data_ptr() | h0.data_ptr()) % 16:
        raise ValueError("mamba_scan kernel needs 16-byte-aligned a and h0 "
                         "(16-byte loads)")
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    rc = _build.entry("mamba_scan_fwd")(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), dtype,
        bsz, length, d, n, _build.stream(dt.get_device()))
    if rc:
        _build.check(rc, "mamba_scan")
    counter.add()
    return y, h_out


def launch_plan(dtype: torch.dtype, b: int, length: int, d: int,
                n: int) -> Tuple[int, int]:
    """(CTAs of the grid, CTAs one SM holds at once) of the kernel a call
    with these sizes launches: the step kernel at ``length`` 1, the scan
    kernel otherwise (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    grid, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.entry("mamba_scan_plan")(
        KERNEL_DTYPES[dtype], b, length, d, n, ctypes.byref(grid),
        ctypes.byref(per_sm)), "mamba_scan_plan")
    return grid.value, per_sm.value
