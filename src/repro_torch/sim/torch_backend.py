"""Torch (CUDA) backend for the FIFO fill recurrence + device planner grids.

The counterpart of the reference's ``repro.sim.jax_backend``, with its
public names. Two execution surfaces, both bit-identical to the numpy
kernels in :mod:`repro_torch.sim.queueing` (float64 end to end; held to
the reference's numpy results in ``tests/test_torch_sim_backend.py``):

* :func:`fifo_fill` — one stage's FIFO fill, for static AND dynamic
  replica pools, through the hand-written kernel
  :mod:`repro_torch.kernels.sim_fill` (one thread, one lane). The pool is
  a sorted buffer (head = minimum, a completion inserted at its rank):
  the numpy heap's pop sequence depends only on the value multiset, so a
  sorted buffer with the same contents pops the same values.
* :func:`grid_stage_percentiles` — the planner sweep: one launch fills a
  whole (hw, batch, replica, timeout) candidate grid, a thread per
  candidate, each writing its completions in sorted-queue order. Lanes
  are laid out by expected step count (:func:`_expected_steps`, stable
  argsort) so that lanes of similar load share a warp. The reference's
  ``_GRID_SEGMENTS`` has no counterpart: it let lanes of a lockstep scan
  stop early between segments, and a thread per lane stops by itself.
  The O(n) tail — scatter into arrival order, latency assembly,
  ``np.partition`` selection and the exact ``np.percentile`` lerp — runs
  on the host as the reference's numpy code, so identity is structural.
  :meth:`repro_torch.sim.TraceSession.percentile_many` routes eligible
  candidate grids here when the session's ``backend`` is ``"torch"``.

Devices: every entry takes a ``torch.device``; on a CUDA device the
kernel runs (a build or launch failure raises), on the CPU its plain
torch version does (the tests). Nothing falls back to numpy quietly:
the only routes to numpy are the reference's own — a single fill below
``_FILL_THRESHOLD`` queries (off by default: the reference measured a
single device fill slower than numpy at every size, so the device
earns its keep on grid width), a negative profiled latency, or an
empty static pool.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import sim_fill

_FAR_FUTURE = 1e18

# single-fill crossover: off (numpy for every single fill) unless set
# lower; the tests and the chip run's crossover set it to 0
_FILL_THRESHOLD = 1 << 62
# device grid gating: fewer uncached candidates than this (or shorter
# fills) are cheaper through the host loop's shared caches
_GRID_MIN_CANDIDATES = 48
_GRID_MIN_QUERIES = 2048
# device bytes of one launch's (lanes, k) float64 completions: a grid
# larger than this fills in several launches of whole lanes
_GRID_OUT_BYTES = 1 << 31

def available() -> bool:
    """True when torch sees a CUDA GPU (the backend's default device)."""
    return torch.cuda.is_available()


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _ready_pad(ready: np.ndarray, pad: int,
               device: torch.device) -> torch.Tensor:
    """The sorted queue and ``pad`` ``+inf`` slots after it, so a batch
    window never reads past the end."""
    return _to(np.concatenate([np.asarray(ready, dtype=np.float64),
                               np.full(pad, np.inf)]), device)


# ---------------------------------------------------------------------------
# single fills
# ---------------------------------------------------------------------------


def fill_static(ready: np.ndarray, lut: np.ndarray, eff_batch: int,
                replicas: int, timeout_s: float, device: torch.device
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Static-pool FIFO fill on ``device``; (done, batch sizes) aligned
    like the numpy kernel's outputs. Caller guarantees k >= 1, replicas
    >= 1, and a non-negative LUT over [1, eff_batch]."""
    k = int(ready.shape[0])
    done, batches, n_batches = sim_fill.fill_static(
        _ready_pad(ready, eff_batch, device), k,
        _to(np.asarray(lut[:eff_batch + 1], dtype=np.float64)[None], device),
        torch.full((1,), eff_batch, dtype=torch.int64, device=device),
        torch.full((1,), float(timeout_s), dtype=torch.float64,
                   device=device),
        torch.zeros((1, replicas), dtype=torch.float64, device=device),
        with_batches=True)
    n = int(n_batches[0])
    return done[0].cpu().numpy(), batches[0, :n].cpu().numpy()


def dynamic_inputs(ready: np.ndarray, lut: np.ndarray, eff_batch: int,
                   replicas: int,
                   replica_events: Sequence[Tuple[float, int]],
                   timeout_s: float, device: torch.device) -> tuple:
    """The arguments of :func:`repro_torch.kernels.sim_fill.fill_dynamic`
    for one fill: the events unit-expanded (each step applies at most
    one replica delta), the removals' times in order (they retire in
    that order), and a pool with room for every replica the events can
    add."""
    k = int(ready.shape[0])
    ev_t: List[float] = []
    ev_d: List[int] = []
    for t, d in replica_events:
        for _ in range(abs(int(d))):
            ev_t.append(float(t))
            ev_d.append(1 if d > 0 else -1)
    rem_t = [t for t, d in zip(ev_t, ev_d) if d < 0]
    m, mr = len(ev_t), len(rem_t)
    pool = np.full(max(replicas + (m - mr), 1), np.inf)
    pool[:replicas] = 0.0
    return (_ready_pad(ready, eff_batch, device), k,
            _to(np.asarray(lut[:eff_batch + 1], dtype=np.float64), device),
            eff_batch, float(timeout_s), _to(pool, device), replicas,
            _to(np.asarray(ev_t, dtype=np.float64), device),
            _to(np.asarray(ev_d, dtype=np.int64), device),
            _to(np.asarray(rem_t, dtype=np.float64), device),
            k + m + mr + 2)


def fill_dynamic(ready: np.ndarray, lut: np.ndarray, eff_batch: int,
                 replicas: int, replica_events: Sequence[Tuple[float, int]],
                 timeout_s: float, device: torch.device
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Dynamic-pool FIFO fill on ``device`` (parity surface; the
    planner's hot grids are static-pool)."""
    done, batches, n_batches = sim_fill.fill_dynamic(*dynamic_inputs(
        ready, lut, eff_batch, replicas, replica_events, timeout_s, device))
    n = int(n_batches[0])
    return done.cpu().numpy(), batches[:n].cpu().numpy()


def fifo_fill(ready: np.ndarray, latency_lut: np.ndarray, eff_batch: int,
              replicas: int,
              replica_events: Optional[Sequence[Tuple[float, int]]],
              timeout_s: float, device: torch.device
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Device FIFO fill, or None when the numpy kernel should run
    instead: the fill is below the crossover threshold, a profiled
    latency is negative (the sorted-buffer insert assumes completions
    never precede starts, like the numpy blocked kernel), or a static
    pool is empty."""
    k = int(ready.shape[0])
    if k < _FILL_THRESHOLD or k == 0:
        return None
    if float(np.min(latency_lut[1:eff_batch + 1])) < 0.0:
        return None
    if replica_events:
        return fill_dynamic(ready, latency_lut, eff_batch, replicas,
                            replica_events, timeout_s, device)
    if replicas <= 0:
        return None
    return fill_static(ready, latency_lut, eff_batch, replicas, timeout_s,
                       device)


# ---------------------------------------------------------------------------
# exact np.percentile (linear interpolation)
# ---------------------------------------------------------------------------


def _quantile_params(n: int, p: float) -> Tuple[int, int, float]:
    """(prev_index, next_index, gamma) exactly as np.percentile computes
    them — same expression, same IEEE-754 doubles."""
    # numpy's "linear" method computes the virtual index as
    # ``(n - 1) * q`` directly (NOT the generic alpha/beta formula, which
    # rounds differently in the last ulp)
    q = float(np.true_divide(p, 100))
    virt = (n - 1) * q
    if virt < 0.0:
        return 0, 0, 0.0
    if virt >= n - 1:
        return n - 1, n - 1, 0.0
    prev = int(math.floor(virt))
    return prev, prev + 1, virt - prev


def _host_lerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """numpy's ``_lerp`` verbatim (the t >= 0.5 branch computes from b),
    in host doubles: the interpolation stays IEEE-faithful whatever the
    device would contract."""
    diff = b - a
    res = a + diff * t
    if t >= 0.5:
        res = b - diff * (1.0 - t)
    return res


def percentile_1d(values: np.ndarray, p: float,
                  device: torch.device) -> float:
    """np.percentile(values, p) with the sort on ``device`` and the two
    order statistics interpolated on the host — bit-identical, +inf
    tails included."""
    n = int(values.shape[0])
    if n == 0:
        return 0.0
    prev, nxt, gamma = _quantile_params(n, p)
    s = torch.sort(_to(np.asarray(values, dtype=np.float64), device)).values
    a, b = float(s[prev]), float(s[nxt])
    return float(_host_lerp(np.float64(a), np.float64(b), gamma))


# ---------------------------------------------------------------------------
# the (hw, batch, replica, timeout) candidate grid
# ---------------------------------------------------------------------------


def _expected_steps(k: float, lam: float, lut: np.ndarray, eff: int,
                    r: int) -> float:
    """Rough step count for one lane: k / expected batch size.

    Expected fullness ~ arrivals per replica-service-time, capped at the
    effective batch. Heuristic only — it orders the lanes so that a
    warp's lanes end after a similar number of steps."""
    service = float(lut[eff])
    if service <= 0.0 or r <= 0:
        return k
    fullness = min(float(eff), max(1.0, lam * service / r))
    return k / fullness


def lane_inputs(luts: Sequence[np.ndarray], eff_batches: Sequence[int],
                replicas: Sequence[int], timeouts: Sequence[float]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The static fill's per-lane inputs as host arrays: LUTs (C, Bmax +
    1) zero past each lane's effective batch, effective batches (C,)
    int64, timeouts (C,) and pools (C, max replicas), 0 for each of a
    lane's replicas and ``+inf`` after."""
    C = len(luts)
    luts_pad = np.zeros((C, int(max(eff_batches)) + 1))
    for i, lut in enumerate(luts):
        e = int(eff_batches[i])
        luts_pad[i, :e + 1] = lut[:e + 1]
    pools = np.full((C, int(max(replicas))), np.inf)
    for i, r in enumerate(replicas):
        pools[i, :int(r)] = 0.0
    return (luts_pad, np.asarray(eff_batches, dtype=np.int64),
            np.asarray(timeouts, dtype=np.float64), pools)


def grid_stage_percentiles(
    sorted_ready: np.ndarray,
    order: np.ndarray,
    base_last: np.ndarray,
    arrivals: np.ndarray,
    rpc_delay_s: float,
    luts: Sequence[np.ndarray],
    eff_batches: Sequence[int],
    replicas: Sequence[int],
    timeouts: Sequence[float],
    p: float,
    device: torch.device,
    split: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Score a candidate grid that varies ONE sink stage, on ``device``.

    ``sorted_ready``/``order`` are the varied stage's (fixed) input
    queue; ``base_last`` is the accumulated completion maximum over
    every *other* stage (they are candidate-invariant because the varied
    stage has no descendants). Per candidate: LUT, effective batch,
    replica count, formation timeout. Returns one ``np.percentile``-
    bit-identical latency percentile per candidate.

    The device runs the fills, a thread per candidate, and returns each
    candidate's completions in sorted-queue order; the host assembles
    latencies and selects the percentile with the reference's numpy
    ops, in the reference's order. ``split``, where given, receives the
    host-clock seconds of the parts: inputs to the device, the fill
    (launch to synchronize), completions to the host, the host tail.
    """
    C = len(luts)
    k = int(sorted_ready.shape[0])
    n = int(arrivals.shape[0])
    bmax = int(max(eff_batches))
    prev, nxt, gamma = _quantile_params(n, p)
    luts_pad, eff_arr, tmo_arr, free0 = lane_inputs(luts, eff_batches,
                                                    replicas, timeouts)
    span = float(sorted_ready[-1] - sorted_ready[0]) if k > 1 else 1.0
    lam = k / max(span, 1e-12)
    perm = np.argsort([
        _expected_steps(k, lam, luts_pad[i], int(eff_arr[i]),
                        int(replicas[i]))
        for i in range(C)
    ], kind="stable")
    per_launch = max(1, _GRID_OUT_BYTES // (8 * k))
    out = np.empty(C)
    kth = (prev, nxt) if nxt > prev else (prev,)
    parts = dict.fromkeys(("upload_s", "fill_s", "copy_s", "tail_s"), 0.0)
    t0 = time.perf_counter()
    ready_d = _ready_pad(sorted_ready, bmax, device)
    for s in range(0, C, per_launch):
        lanes = perm[s:s + per_launch]
        args = (_to(luts_pad[lanes], device), _to(eff_arr[lanes], device),
                _to(tmo_arr[lanes], device), _to(free0[lanes], device))
        t1 = time.perf_counter()
        done, _, _ = sim_fill.fill_static(ready_d, k, *args)
        if done.is_cuda:
            torch.cuda.synchronize(done.device)
        t2 = time.perf_counter()
        done_h = done.cpu().numpy()
        del done
        t3 = time.perf_counter()
        for j, lane in enumerate(lanes):
            comp = np.full(n, -np.inf)
            comp[order] = done_h[j]
            last = np.maximum(base_last, comp)
            lat = last - arrivals + rpc_delay_s
            part = np.partition(lat, kth)
            out[lane] = _host_lerp(part[prev], part[nxt], gamma)
        t4 = time.perf_counter()
        parts["upload_s"] += t1 - t0
        parts["fill_s"] += t2 - t1
        parts["copy_s"] += t3 - t2
        parts["tail_s"] += t4 - t3
        t0 = t4
    if split is not None:
        split.clear()
        split.update(parts, launches=-(-C // per_launch), lanes=C, queries=k)
    return out
