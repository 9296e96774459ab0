"""The planner sweep's order statistics: the CUDA kernel
``csrc/sim_select.cu``, its wrapper and its plain PyTorch version.

Replaces the reference's host tail of the sweep,
``repro/sim/jax_backend.py`` ``grid_stage_percentiles``: ``np.partition``
of each candidate's latencies and ``part[prev], part[nxt]``. A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or
raises. The two values of each candidate are members of its multiset,
so the host's lerp of them is ``np.percentile`` bit for bit.

The kernel takes one of two paths, by ``k + m`` (the row and the shared
segment): up to :data:`CLUSTER_CAP` a cluster of :data:`CLUSTER` CTAs a
candidate reads the row from device memory once into its distributed
shared memory; a larger row streams from device memory a pass.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

counter = _build.LaunchCounter()
# launches by path, beside ``counter``
path_counters = {"cluster": _build.LaunchCounter(),
                 "stream": _build.LaunchCounter()}

F64 = torch.float64
CLUSTER = 16                 # csrc kCluster: CTAs a candidate
CLUSTER_CAP = CLUSTER * 8 * 3072     # csrc kClusterCap: keys a cluster holds


def path(n: int) -> str:
    """The kernel's path for ``n = k + m`` keys a candidate."""
    return "cluster" if n <= CLUSTER_CAP else "stream"


def plan(k: int, m: int, lanes: int) -> dict:
    """The launch the kernel makes for (lanes, k) rows and a segment of m,
    as the CUDA source reports it: the path, its CTAs a candidate, their
    dynamic shared memory (bytes), and how many clusters (cluster path)
    or CTAs (stream path) of it the current card holds at once."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = _build.entry("sim_select_plan")(k, m, lanes,
                                         *map(ctypes.byref, vals))
    if rc:
        _build.check(rc, "sim_select_plan")
    code, cluster, smem, resident = (v.value for v in vals)
    return {"path": "cluster" if code == 1 else "stream",
            "cluster": cluster, "smem": smem, "resident": resident}


def select(rows: torch.Tensor, seg: torch.Tensor, r0: int,
           r1: int) -> torch.Tensor:
    """The values of ranks ``r0 <= r1`` (0-based, ascending, NaN last as
    numpy sorts) in each row's multiset together with ``seg``.

    rows: (C, k) float64; seg: (m,) float64, shared by every row (may be
    empty); ``0 <= r0 <= r1 < k + m``. Returns (C, 2) float64."""
    if rows.is_cuda:
        return _launch(rows, seg, r0, r1)
    if rows.device.type == "cpu":
        return select_ref(rows, seg, r0, r1)
    raise ValueError(f"sim_select: unsupported device {rows.device}")


def _launch(rows, seg, r0, r1):
    dev = rows.get_device()
    if rows.dtype != F64 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"sim_select: rows must be a contiguous float64 "
                         f"(C, k) on cuda:{dev}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if seg.dtype != F64 or seg.dim() != 1 or seg.get_device() != dev or \
            not seg.is_contiguous():
        raise ValueError(f"sim_select: seg must be a contiguous float64 "
                         f"(m,) on cuda:{dev}, got {seg.dtype} "
                         f"{tuple(seg.shape)} on {seg.device}")
    lanes, k = rows.shape
    n = k + seg.shape[0]
    if not 0 <= r0 <= r1 < n or n >= 1 << 32:
        raise ValueError(f"sim_select: needs 0 <= r0 <= r1 < {n} < 2**32, "
                         f"got r0={r0}, r1={r1}")
    out = torch.empty((lanes, 2), dtype=F64, device=rows.device)
    if lanes == 0:
        return out
    rc = _build.entry("sim_select")(
        rows.data_ptr(), k, seg.data_ptr(), seg.shape[0], lanes, r0, r1,
        out.data_ptr(), _build.stream(dev))
    if rc:
        _build.check(rc, "sim_select")
    counter.add()
    path_counters[path(n)].add()
    return out


def select_ref(rows: torch.Tensor, seg: torch.Tensor, r0: int,
               r1: int) -> torch.Tensor:
    """``torch.sort`` of each row with the segment, read at the two
    ranks, on any device. Same arguments and result as :func:`select`."""
    full = torch.cat([rows, seg.expand(rows.shape[0], -1)], 1)
    s = torch.sort(full, dim=1).values
    return torch.stack([s[:, r0], s[:, r1]], 1)
