"""Selective scan of the Mamba block: the CUDA kernels
``csrc/mamba_scan.cu`` (forward) and ``csrc/mamba_scan_bwd.cu``
(backward), and their wrapper.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan``. A
tensor on the CPU takes the plain versions (:func:`ref.mamba_scan_ref`,
:func:`ref.mamba_scan_bwd_ref`); a CUDA tensor launches the kernels or
raises. The kernels take any sequence length in one launch (the state is
carried through ``h0`` between calls), so there is no chunk argument:
the reference's model path calls its kernel with ``chunk = L`` too.

With grad enabled and an input that requires it, the call is
:class:`MambaScan`: it saves the forward's inputs, and its backward
launches the backward kernel, which rebuilds the states from ``h0``.
Otherwise the call launches the forward alone, as a served CUDA graph
captures it.

The backward takes a workspace of float32 from the allocator each call:
the states entering its segments of 16 steps (a checkpoint a segment but
the first and last, rebuilt forwards from ``h0`` with the forward's own
arithmetic, so each is the state the forward carried), one dB/dC
partial a CTA a step, and at batch > 1 dA's partial a batch row.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, meta, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (8, 16, 32, 64)     # N: one register array per thread
# the scan's arithmetic a (b, l, d, n) element, for the meta branch: the
# forward's exp(dt a), the state's product and sum, dt x times B, and
# C h's product and sum; the backward rebuilds the states (the
# forward's 7) and runs the reverse recurrence and its four gradients
FWD_OPS, BWD_OPS = 7, 21
# threads of a backward CTA by N (csrc/mamba_scan_bwd.cu, BwdShape): four
# states a lane, 64 channels a CTA (32 at N 64); steps of its segments
BWD_THREADS = {8: 128, 16: 256, 32: 512, 64: 512}
BWD_SEGMENT = 16

counter = _build.LaunchCounter()       # forward launches
bwd_counter = _build.LaunchCounter()   # backward launches (2-3 kernels each)


def mamba_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x: (B,L,D); b, c: (B,L,N); a: (D,N); h0: (B,D,N) float32.
    Returns (y (B,L,D) in x's dtype, h_last (B,D,N) float32).
    Differentiable in every input. Inside :func:`meta.shapes_only`,
    ``meta`` tensors take the meta branch."""
    if dt.device.type not in ("cpu", "cuda") and not meta.takes(dt):
        raise ValueError(f"mamba_scan: unsupported device {dt.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, x, b, c, a, h0)):
        return MambaScan.apply(dt, x, b, c, a, h0)
    return _forward(dt, x, b, c, a, h0)


def _forward(dt, x, b, c, a, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    if dt.is_cuda:
        return _launch(dt, x, b, c, a, h0)
    if dt.is_meta:
        y, h = torch.empty_like(x), torch.empty_like(h0)
        meta.add(FWD_OPS * dt.numel() * a.shape[-1], dt, x, b, c, a, h0,
                 y, h)
        return y, h
    return ref.mamba_scan_ref(dt, x, b, c, a, h0)


class MambaScan(torch.autograd.Function):
    """The forward kernel, and the backward kernel from the saved inputs
    (it rebuilds the states). On the CPU both are the plain versions."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a, h0):
        y, h = _forward(dt, x, b, c, a, h0)
        ctx.save_for_backward(dt, x, b, c, a, h0)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        return mamba_scan_backward(*ctx.saved_tensors, dy, dh)


def mamba_scan_backward(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                        dy: torch.Tensor, dh: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """(ddt, dx, db, dc, da, dh0) from the forward's inputs and the
    gradients of its outputs, dy (B,L,D) and dh (B,D,N), each in its
    input's dtype. A CUDA tensor launches the backward kernel; a CPU
    tensor takes the plain reverse recurrence."""
    if dt.is_cuda:
        return _launch_bwd(dt, x, b, c, a, h0, dy, dh)
    if meta.takes(dt):
        grads = tuple(torch.empty_like(t) for t in (dt, x, b, c, a, h0))
        meta.add(BWD_OPS * dt.numel() * a.shape[-1], dt, x, b, c, a, h0,
                 dy, dh, *grads)
        return grads
    if dt.device.type == "cpu":
        return ref.mamba_scan_bwd_ref(dt, x, b, c, a, h0, dy, dh)
    raise ValueError(f"mamba_scan_backward: unsupported device {dt.device}")


def _check(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return the dtype code."""
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
    if not all(t.is_contiguous() for t in (dt, x, b, c, h0)):
        raise ValueError("mamba_scan kernel needs contiguous dt, x, b, c "
                         "and h0")
    return dtype


def _launch(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, a: torch.Tensor,
            h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype = _check(dt, x, b, c, a, h0)
    bsz, length, d = dt.shape
    a = a.to(torch.float32).contiguous()          # (D, N): small
    if (a.data_ptr() | h0.data_ptr()) % 16:
        raise ValueError("mamba_scan kernel needs 16-byte-aligned a and h0 "
                         "(16-byte loads)")
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    rc = _build.entry("mamba_scan_fwd")(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), dtype,
        bsz, length, d, a.shape[1], _build.stream(dt.get_device()))
    if rc:
        _build.check(rc, "mamba_scan")
    counter.add()
    return y, h_out


def _launch_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                dy: torch.Tensor, dh: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    dtype = _check(dt, x, b, c, a, h0)
    bsz, length, d = dt.shape
    n = a.shape[1]
    # y and h_last were returned in x's dtype and f32: their gradients
    # come back so, but a caller may hand others
    dy = dy.to(x.dtype).contiguous()
    dh = dh.to(torch.float32).contiguous()
    if dy.shape != dt.shape or dh.shape != h0.shape or \
            dy.device != dt.device or dh.device != dt.device:
        raise ValueError(f"mamba_scan backward: dy {tuple(dy.shape)} and dh "
                         f"{tuple(dh.shape)} do not match the forward's "
                         f"y {tuple(dt.shape)} and h {tuple(h0.shape)}")
    # the kernel stages B, C and the entering states with 16-byte copies
    b, c, h0, dh = (_aligned(t) for t in (b, c, h0, dh))
    a32 = _aligned(a.to(torch.float32).contiguous())
    work = torch.empty(bwd_workspace_floats(bsz, length, d, n),
                       dtype=torch.float32, device=dt.device)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da, dh0 = torch.empty_like(a32), torch.empty_like(h0)
    rc = _build.entry("mamba_scan_bwd")(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a32.data_ptr(), h0.data_ptr(), dy.data_ptr(), dh.data_ptr(),
        ddt.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), dh0.data_ptr(), work.data_ptr(), dtype, bsz, length,
        d, n, _build.stream(dt.get_device()))
    if rc:
        _build.check(rc, "mamba_scan backward")
    bwd_counter.add()
    return ddt, dx, db, dc, da.to(a.dtype), dh0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bwd_workspace_floats(b: int, length: int, d: int, n: int) -> int:
    """Floats of the workspace a backward call with these sizes takes."""
    floats = ctypes.c_longlong(0)
    _build.check(_build.entry("mamba_scan_bwd_workspace")(
        b, length, d, n, ctypes.byref(floats)), "mamba_scan_bwd_workspace")
    return floats.value


def bwd_launch_plan(dtype: torch.dtype, b: int, length: int, d: int,
                    n: int) -> Tuple[int, int]:
    """(CTAs of the grid, CTAs one SM holds at once) of the backward's
    main kernel for these sizes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); a CTA is
    ``BWD_THREADS[n]`` threads."""
    grid, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.entry("mamba_scan_bwd_plan")(
        KERNEL_DTYPES[dtype], b, length, d, n, ctypes.byref(grid),
        ctypes.byref(per_sm)), "mamba_scan_bwd_plan")
    return grid.value, per_sm.value


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
