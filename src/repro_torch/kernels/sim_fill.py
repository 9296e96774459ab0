"""The planner's FIFO fill: the CUDA kernel ``csrc/sim_fill.cu``, its
wrappers and its plain PyTorch versions.

Replaces the reference's device code for the planner sweep,
``repro/sim/jax_backend.py`` ``_static_fill_core`` (vmapped over a
candidate grid) and ``_dynamic_fill_fn``. A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises. All values
are float64 and every result is bit-identical to the numpy fill
(``repro_torch.sim.queueing``): the recurrence only compares, takes
maxima and minima, and adds.

:func:`fill_static` fills C lanes over one sorted queue, each with its
own LUT, effective batch, timeout and static pool; :func:`fill_dynamic`
fills one lane whose pool changes with unit ``(t, +1/-1)`` events. Both
write each query's completion in sorted-queue order. :func:`fill_latency`
is the planner grid's launch of the static kernel: it writes each
query's latency instead, ``(max(base_last, end) - arrival) + rpc`` as
the reference's host tail computes it. One counter counts the launches
of all three.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

FAR_FUTURE = 1e18         # repro_torch.sim.queueing._FAR_FUTURE
MAX_QUERIES = (1 << 31) - 65    # the static kernel's 32-bit indices

counter = _build.LaunchCounter()

F64, I64 = torch.float64, torch.int64


def fill_static(ready_pad: torch.Tensor, k: int, luts: torch.Tensor,
                eff: torch.Tensor, timeouts: torch.Tensor,
                pools: torch.Tensor, with_batches: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """Static-pool FIFO fills of C lanes over one sorted queue.

    ready_pad: (k + Bmax,) float64, the queue then ``+inf``; luts:
    (C, Bmax + 1) float64; eff: (C,) int64 effective batches, each at
    most Bmax; timeouts: (C,) float64; pools: (C, R) float64, each row
    sorted (0 for each replica, ``+inf`` after, at least one replica),
    updated in place. Returns done (C, k) float64 and, with
    ``with_batches``, the batch sizes (C, k) int64 (the first n of a row
    are its batches) and their counts n (C,) int64, else None twice."""
    if ready_pad.is_cuda:
        return _launch_static(ready_pad, k, luts, eff, timeouts, pools,
                              with_batches)
    if ready_pad.device.type == "cpu":
        return fill_static_ref(ready_pad, k, luts, eff, timeouts, pools,
                               with_batches)
    raise ValueError(f"sim_fill: unsupported device {ready_pad.device}")


def fill_latency(ready_pad: torch.Tensor, k: int, luts: torch.Tensor,
                 eff: torch.Tensor, timeouts: torch.Tensor,
                 pools: torch.Tensor, base_last: torch.Tensor,
                 arrivals: torch.Tensor, rpc: float) -> torch.Tensor:
    """Static-pool fills of C lanes, as :func:`fill_static`, that return
    each query's latency: (C, k) float64, in sorted-queue order, where
    ``base_last`` and ``arrivals`` (k,) are the queue's accumulated
    completion maximum over the other stages and its arrival times, in
    the same order. Element j is ``(np.maximum(base_last[j], end_j) -
    arrivals[j]) + rpc``. ``rpc`` must be at least 0: then, with
    ``arrivals >= 0`` and ``base_last >= arrivals``, no latency is -0.0,
    which the select's keys would order below +0.0."""
    if not rpc >= 0.0:
        raise ValueError(f"sim_fill: rpc must be at least 0, got {rpc}")
    if ready_pad.is_cuda:
        return _launch_static(ready_pad, k, luts, eff, timeouts, pools,
                              False, (base_last, arrivals, float(rpc)))[0]
    if ready_pad.device.type == "cpu":
        return fill_latency_ref(ready_pad, k, luts, eff, timeouts, pools,
                                base_last, arrivals, rpc)
    raise ValueError(f"sim_fill: unsupported device {ready_pad.device}")


def fill_dynamic(ready_pad: torch.Tensor, k: int, lut: torch.Tensor,
                 eff: int, timeout_s: float, pool: torch.Tensor,
                 n_free: int, ev_t: torch.Tensor, ev_d: torch.Tensor,
                 rem_t: torch.Tensor, trips: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lane's FIFO fill with unit replica events.

    ready_pad: (k + eff,) float64; lut: (eff + 1,) float64; pool: (R,)
    float64 with room for every replica the events can add, sorted, its
    first ``n_free`` entries 0 (updated in place); ev_t/ev_d: (M,)
    float64 / int64 unit events (+1 or -1) in time order; rem_t: the
    removals' times in order; ``trips`` bounds the steps (k + M +
    removals + 2). Returns done (k,) float64, batches (k,) int64 and
    their count (1,) int64. Queries left when the pool is empty for good
    complete at ``FAR_FUTURE`` and form no batch."""
    if ready_pad.is_cuda:
        return _launch_dynamic(ready_pad, k, lut, eff, timeout_s, pool,
                               n_free, ev_t, ev_d, rem_t, trips)
    if ready_pad.device.type == "cpu":
        return fill_dynamic_ref(ready_pad, k, lut, eff, timeout_s, pool,
                                n_free, ev_t, ev_d, rem_t, trips)
    raise ValueError(f"sim_fill: unsupported device {ready_pad.device}")


# ------------------------------------------------------------------ launches

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           dev: int) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or \
            t.get_device() != dev or not t.is_contiguous():
        raise ValueError(
            f"sim_fill: {name} must be a contiguous {dtype} {shape} on "
            f"cuda:{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_static(ready_pad, k, luts, eff, timeouts, pools, with_batches,
                   latency=None):
    """One launch of the static kernel; ``latency``, where given, is
    (base_last, arrivals, rpc) and the output holds latencies."""
    dev = ready_pad.get_device()
    lanes, lut_w = luts.shape
    cap = pools.shape[1]
    _check("ready_pad", ready_pad, F64, (k + lut_w - 1,), dev)
    _check("luts", luts, F64, (lanes, lut_w), dev)
    _check("eff", eff, I64, (lanes,), dev)
    _check("timeouts", timeouts, F64, (lanes,), dev)
    _check("pools", pools, F64, (lanes, cap), dev)
    bl_ptr = arr_ptr = None
    rpc = 0.0
    if latency is not None:
        base_last, arrivals, rpc = latency
        _check("base_last", base_last, F64, (k,), dev)
        _check("arrivals", arrivals, F64, (k,), dev)
        bl_ptr, arr_ptr = base_last.data_ptr(), arrivals.data_ptr()
    if k < 1 or lanes < 1 or cap < 1:
        raise ValueError(f"sim_fill: needs k, lanes and a pool of at least "
                         f"1, got k={k}, {lanes} lanes, pool {cap}")
    if k > MAX_QUERIES:
        raise ValueError(f"sim_fill: a queue of at most {MAX_QUERIES} "
                         f"queries (32-bit indices), got {k}")
    out = torch.empty((lanes, k), dtype=F64, device=ready_pad.device)
    batches = n_batches = None
    if with_batches:
        batches = torch.empty((lanes, k), dtype=I64, device=ready_pad.device)
        n_batches = torch.empty(lanes, dtype=I64, device=ready_pad.device)
    rc = _build.entry("sim_fill_static")(
        ready_pad.data_ptr(), k, luts.data_ptr(), lut_w, eff.data_ptr(),
        timeouts.data_ptr(), pools.data_ptr(), cap, lanes, out.data_ptr(),
        batches.data_ptr() if with_batches else None,
        n_batches.data_ptr() if with_batches else None, bl_ptr, arr_ptr,
        rpc, _build.stream(dev))
    if rc:
        _build.check(rc, "sim_fill_static")
    counter.add()
    return out, batches, n_batches


def _launch_dynamic(ready_pad, k, lut, eff, timeout_s, pool, n_free, ev_t,
                    ev_d, rem_t, trips):
    dev = ready_pad.get_device()
    m = ev_t.shape[0]
    _check("ready_pad", ready_pad, F64, (k + eff,), dev)
    _check("lut", lut, F64, (eff + 1,), dev)
    _check("pool", pool, F64, (pool.shape[0],), dev)
    _check("ev_t", ev_t, F64, (m,), dev)
    _check("ev_d", ev_d, I64, (m,), dev)
    _check("rem_t", rem_t, F64, (rem_t.shape[0],), dev)
    adds = int((ev_d > 0).sum()) if m else 0
    if k < 1 or eff < 1 or pool.shape[0] < max(n_free + adds, 1):
        raise ValueError(f"sim_fill: needs k and eff of at least 1 and a "
                         f"pool of {n_free} + {adds} slots, got k={k}, "
                         f"eff={eff}, pool {pool.shape[0]}")
    done = torch.empty(k, dtype=F64, device=ready_pad.device)
    batches = torch.empty(k, dtype=I64, device=ready_pad.device)
    n_batches = torch.empty(1, dtype=I64, device=ready_pad.device)
    rc = _build.entry("sim_fill_dynamic")(
        ready_pad.data_ptr(), k, lut.data_ptr(), eff, float(timeout_s),
        pool.data_ptr(), n_free, ev_t.data_ptr(), ev_d.data_ptr(), m,
        rem_t.data_ptr(), trips, done.data_ptr(), batches.data_ptr(),
        n_batches.data_ptr(), _build.stream(dev))
    if rc:
        _build.check(rc, "sim_fill_dynamic")
    counter.add()
    return done, batches, n_batches


# ------------------------------------------------------------ plain versions

def _form(ready_pad, k, ptr, eff, timeouts, f, with_timeout=True):
    """Batch formation of every lane at its pool minimum ``f``: (start,
    boundary), with the timeout hold, as the kernel's ``form``. On the
    sorted queue the kernel's count up to the first arrival past the
    start is a right-sided search, cut at the batch limit; a drained
    lane (ptr == k) forms an empty batch."""
    ready = ready_pad[:k]
    r0 = ready_pad[ptr]
    start = torch.where(r0 > f, r0, f)
    full = ptr + eff
    limit = torch.clamp(full, max=k)
    hi = torch.minimum(torch.searchsorted(ready, start, right=True), limit)
    if not with_timeout:
        return start, hi
    hold_until = r0 + timeouts
    fill_t = torch.where(full - 1 < k, ready_pad[full - 1],
                         torch.full_like(r0, FAR_FUTURE))
    held = torch.where(fill_t > start, fill_t, start)
    start1 = torch.where(hold_until < held, hold_until, held)
    need = (timeouts > 0.0) & (hi < limit) & (hold_until > start)
    start = torch.where(need, start1, start)
    hi = torch.where(need, torch.minimum(
        torch.searchsorted(ready, start, right=True), limit), hi)
    return start, hi


def fill_static_ref(ready_pad: torch.Tensor, k: int, luts: torch.Tensor,
                    eff: torch.Tensor, timeouts: torch.Tensor,
                    pools: torch.Tensor, with_batches: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """The kernel's recurrence in torch ops on any device: vectorized
    over lanes, a Python loop over steps (every active lane forms one
    batch a step; a drained lane's batch is empty). Same arguments and
    results as :func:`fill_static`."""
    dev = ready_pad.device
    lanes = luts.shape[0]
    rows = torch.arange(lanes, device=dev)
    idx_r = torch.arange(pools.shape[1], device=dev)
    with_timeout = bool((timeouts > 0.0).any())
    ptr = torch.zeros(lanes, dtype=I64, device=dev)
    ends, sizes = [], []
    for step in range(k):         # an active lane takes >= 1 query a step
        active = ptr < k
        # a drained lane's steps form empty batches and leave its pool,
        # so the loop asks the device whether any lane is left only
        # every 32 steps
        if step % 32 == 0 and not bool(active.any()):
            break
        start, hi = _form(ready_pad, k, ptr, eff, timeouts, pools[:, 0],
                          with_timeout)
        b = hi - ptr
        end = start + luts[rows, b]
        ends.append(end)
        sizes.append(b)
        # sorted-pool replacement: rank count(free < end) - 1, -1 keeps it
        p = torch.searchsorted(pools, end[:, None]) - 1
        shifted = torch.cat([pools[:, 1:], pools[:, -1:]], 1)
        new = torch.where(idx_r < p, shifted,
                          torch.where(idx_r == p, end[:, None], pools))
        pools.copy_(torch.where(active[:, None], new, pools))
        ptr = hi
    ends_t = torch.stack(ends, 1)
    sizes_t = torch.stack(sizes, 1)
    done = torch.stack([torch.repeat_interleave(ends_t[i], sizes_t[i])
                        for i in range(lanes)])
    if not with_batches:
        return done, None, None
    n_batches = (sizes_t > 0).sum(1)
    batches = torch.zeros((lanes, k), dtype=I64, device=dev)
    for i in range(lanes):
        batches[i, :int(n_batches[i])] = sizes_t[i][sizes_t[i] > 0]
    return done, batches, n_batches


def latency_ref(done: torch.Tensor, base_last: torch.Tensor,
                arrivals: torch.Tensor, rpc: float) -> torch.Tensor:
    """The reference's latency assembly on completions ``done`` (C, k):
    ``last = np.maximum(base_last, done)``, with numpy's rule (the first
    argument where it is at least the second or NaN), then ``(last -
    arrivals) + rpc``."""
    last = torch.where((base_last >= done) | torch.isnan(base_last),
                       base_last, done)
    return (last - arrivals) + rpc


def fill_latency_ref(ready_pad: torch.Tensor, k: int, luts: torch.Tensor,
                     eff: torch.Tensor, timeouts: torch.Tensor,
                     pools: torch.Tensor, base_last: torch.Tensor,
                     arrivals: torch.Tensor, rpc: float) -> torch.Tensor:
    """:func:`fill_static_ref`'s completions through :func:`latency_ref`.
    Same arguments and result as :func:`fill_latency`."""
    done = fill_static_ref(ready_pad, k, luts, eff, timeouts, pools)[0]
    return latency_ref(done, base_last, arrivals, rpc)


def fill_dynamic_ref(ready_pad: torch.Tensor, k: int, lut: torch.Tensor,
                     eff: int, timeout_s: float, pool: torch.Tensor,
                     n_free: int, ev_t: torch.Tensor, ev_d: torch.Tensor,
                     rem_t: torch.Tensor, trips: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dynamic kernel's loop in torch ops on any device, one lane,
    its branches taken on the host. Same arguments and results as
    :func:`fill_dynamic`."""
    dev = ready_pad.device
    eff_t = torch.tensor([eff], dtype=I64, device=dev)
    tmo = torch.tensor([timeout_s], dtype=F64, device=dev)
    done = torch.empty(k, dtype=F64, device=dev)
    batches = torch.zeros(k, dtype=I64, device=dev)
    ev_tl, ev_dl, rem_tl = ev_t.tolist(), ev_d.tolist(), rem_t.tolist()
    m = len(ev_tl)
    ptr = ev_i = rem_app = rem_ret = nb = 0

    def insert(n: int, t: torch.Tensor) -> None:
        j = int((pool[:n] < t).sum())
        pool[j + 1:n + 1] = pool[j:n].clone()
        pool[j] = t

    def apply_events(bound: float, n: int) -> int:
        nonlocal ev_i, rem_app
        while ev_i < m and ev_tl[ev_i] <= bound:
            if ev_dl[ev_i] > 0:
                insert(n, ev_t[ev_i])
                n += 1
            else:
                rem_app += 1
            ev_i += 1
        return n

    for _ in range(trips):
        if ptr >= k:
            break
        if n_free == 0:
            if ev_i < m:
                n_free = apply_events(ev_tl[ev_i], n_free)
                continue
            done[ptr:] = FAR_FUTURE
            ptr = k
            break
        f = pool[0].clone()
        pool[:n_free - 1] = pool[1:n_free].clone()
        n_free -= 1
        r0 = ready_pad[ptr]
        dispatch = torch.where(r0 > f, r0, f)
        n_free = apply_events(float(dispatch), n_free)
        if rem_ret < rem_app and rem_tl[rem_ret] <= float(dispatch):
            rem_ret += 1
            continue
        ptr_t = torch.tensor([ptr], dtype=I64, device=dev)
        start, hi = _form(ready_pad, k, ptr_t, eff_t, tmo, f[None])
        hi_i = int(hi[0])
        end = start[0] + lut[hi_i - ptr]
        done[ptr:hi_i] = end
        batches[nb] = hi_i - ptr
        nb += 1
        ptr = hi_i
        insert(n_free, end)
        n_free += 1
    return done, batches, torch.tensor([nb], dtype=I64, device=dev)
