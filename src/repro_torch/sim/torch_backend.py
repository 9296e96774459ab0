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
* :func:`grid_stage_percentiles` — the planner sweep, two launches a
  chunk of candidates: the fill kernel fills the whole (hw, batch,
  replica, timeout) candidate grid, a warp per candidate, writing each
  query's *latency* in sorted-queue order; the select kernel
  (:mod:`repro_torch.kernels.sim_select`) returns each candidate's two
  order statistics, the reference's ``np.partition`` ranks. Only those
  (C, 2) doubles come back; the exact ``np.percentile`` lerp runs on the
  host, as in :func:`percentile_1d`. A selection does not care about
  order, so the reference's scatter into arrival order has no
  counterpart, and the queries that never reach the varied stage form
  one segment of latencies that every candidate's select reads. Lanes
  are laid out by expected step count (:func:`_expected_steps`, stable
  argsort). The reference's ``_GRID_SEGMENTS`` has no counterpart: it
  let lanes of a lockstep scan stop early between segments, and a warp
  per lane stops by itself.
  :meth:`repro_torch.sim.TraceSession.percentile_many` routes eligible
  candidate grids here when the session's ``backend`` is ``"torch"``.

Devices: every entry takes a ``torch.device``; on a CUDA device the
kernels run (a build or launch failure raises), on the CPU their plain
torch versions do (the tests). Nothing falls back to numpy quietly:
the only routes to numpy are the reference's own — a single fill below
``_FILL_THRESHOLD`` queries (off by default: the reference measured a
single device fill slower than numpy at every size, so the device
earns its keep on grid width), a negative profiled latency, or an
empty static pool.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import sim_fill, sim_select

_FAR_FUTURE = 1e18

# single-fill crossover: off (numpy for every single fill) unless set
# lower; the tests and the chip run's crossover set it to 0
_FILL_THRESHOLD = 1 << 62
# device grid gating: fewer uncached candidates than this (or shorter
# fills) are cheaper through the host loop's shared caches
_GRID_MIN_CANDIDATES = 48
_GRID_MIN_QUERIES = 2048
# device bytes of one chunk's (lanes, k) float64 latencies: a grid
# larger than this fills and selects in several chunks of whole lanes
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


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The grid's order statistics to the host (one seam for timing the
    copy back from outside the package)."""
    return t.cpu().numpy()


def _host_lerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """numpy's ``_lerp`` verbatim (the t >= 0.5 branch computes from b),
    in host doubles: the interpolation stays IEEE-faithful whatever the
    device would contract. Elementwise on arrays, so each element equals
    the scalar call."""
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


def _unvisited(order: np.ndarray, base_last: np.ndarray,
               arrivals: np.ndarray, rpc_delay_s: float,
               device: torch.device) -> torch.Tensor:
    """The latencies of the queries that never reach the varied stage
    (conditional routing), computed once on ``device``: the reference's
    ``comp`` is ``-inf`` there, so ``last`` is ``base_last`` and the
    latency ``(base_last - arrivals) + rpc``."""
    mask = np.ones(arrivals.shape[0], dtype=bool)
    mask[order] = False
    u = np.nonzero(mask)[0]
    return (_to(base_last[u], device) - _to(arrivals[u], device)) + \
        rpc_delay_s


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
    split: Optional[Dict[str, int]] = None,
) -> np.ndarray:
    """Score a candidate grid that varies ONE sink stage, on ``device``.

    ``sorted_ready``/``order`` are the varied stage's (fixed) input
    queue; ``base_last`` is the accumulated completion maximum over
    every *other* stage (they are candidate-invariant because the varied
    stage has no descendants). Per candidate: LUT, effective batch,
    replica count, formation timeout. Returns one ``np.percentile``-
    bit-identical latency percentile per candidate.

    Each chunk of candidates is two launches: the fill writes each
    query's latency, a warp per candidate, and the select reduces each
    candidate's latencies, with the shared segment of the queries that
    skip the stage, to the two order statistics that ``np.percentile``
    interpolates. The host receives (C, 2) doubles and lerps them.
    ``split``, where given, receives the counts: chunks, launches (two
    a chunk), lanes and queries.
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
    ready_d = _ready_pad(sorted_ready, bmax, device)
    bl_s = _to(base_last[order], device)
    arr_s = _to(arrivals[order], device)
    seg = _unvisited(order, base_last, arrivals, rpc_delay_s, device)
    stats = []
    for s in range(0, C, per_launch):
        lanes = perm[s:s + per_launch]
        lat = sim_fill.fill_latency(
            ready_d, k, _to(luts_pad[lanes], device),
            _to(eff_arr[lanes], device), _to(tmo_arr[lanes], device),
            _to(free0[lanes], device), bl_s, arr_s, rpc_delay_s)
        stats.append(sim_select.select(lat, seg, prev, nxt))
        del lat
    ab = _to_host(torch.cat(stats))
    out = np.empty(C)
    out[perm] = _host_lerp(ab[:, 0], ab[:, 1], gamma)
    if split is not None:
        split.clear()
        split.update(chunks=len(stats), launches=2 * len(stats), lanes=C,
                     queries=k)
    return out
