"""Per-stage queueing policies: one centralized batched queue, R servers.

Each policy simulates ONE stage — a single queue feeding ``replicas``
batch-servers whose batch latency is given by a lookup table — and is
selected per stage via ``StageConfig.policy``:

* ``fifo``      — the paper's greedy arrival-order batching, plus the
  beyond-paper batch-formation timeout (``StageConfig.timeout_s``). This
  is the seed estimator's exact semantics, bit-identical, but the fill
  loop is a *blocked, vectorized batch-boundary scan* (see below) so
  long stretches of steady-state traffic cost a handful of numpy calls,
  not one Python iteration per batch.
* ``edf``       — earliest-deadline-first: among the queries ready at
  dispatch time, serve the ``batch`` with the earliest deadlines.
  Deadline scheduling lets late-but-urgent queries (e.g. a query delayed
  on a slow sibling branch) jump the queue at join stages.
* ``slo-drop``  — FIFO with SLO-aware load shedding (admission control at
  dequeue): a query that can no longer meet its deadline even if served
  alone right now is dropped instead of poisoning the batch behind it.
  Dropped queries complete at ``+inf`` and are flagged in the returned
  drop mask.

Vectorized FIFO fill (EXPERIMENTS.md §Perf)
-------------------------------------------
The FIFO recurrence is sequential in general (each batch's start depends
on the replica freed by earlier batches), but almost every batch falls
into one of two regimes with closed vectorized forms:

* **underload** (a replica is free when the head-of-line query arrives):
  the batch start equals the head arrival, so batch boundaries are the
  run-length decomposition of tied ready times capped at the max batch —
  computable for a whole block with one ``np.repeat``/``arange``
  expansion. The replica pool never delays these batches; validity is
  checked per batch with an order-statistic count (``searchsorted`` +
  ``bincount`` + ``cumsum``) over the pool's free times and the block's
  own completions.
* **backlog with full batches** (every query of a max-size batch is
  already waiting when a replica frees): service times are all equal, so
  the pop sequence of the replica heap is the sorted merge of R
  arithmetic progressions — generated exactly with a per-lane
  ``np.cumsum`` (sequential adds, bit-identical to repeated scalar
  addition) and one ``argsort``.

Each block is evaluated optimistically and committed up to the first
batch that violates its regime; mixed stretches fall back to a scalar
burst with exponential backoff so churny stages never pay block setup
per batch. The scalar step itself is leaner than the seed loop: with no
timeout, batch boundaries come from a precomputed run-length table
instead of a per-query walk. All paths are bit-identical to the
reference's ``repro.sim.queueing`` (``tests/test_torch_plan.py`` holds
each branch to it), which is itself held to the reference's frozen seed
oracle.

All policies share the dynamic replica-pool semantics of the seed engine:
``replica_events`` is a sorted list of ``(t, +1/-1)`` scale events; ``+1``
adds a replica free at ``t``, ``-1`` retires the next replica to go idle
at/after ``t``.

Admission control (the closed-loop Tuner): the
``slo-drop`` policy additionally accepts ``shed_events`` — a sorted list
of ``(t, margin_s)`` pairs defining a piecewise-constant shed margin
``m(t)``. A query is shed at dequeue iff
``deadline < batch_start + lut[1] + m(batch_start)``; the margin before
the first event is 0 (the policy's historical behavior), ``m > 0`` sheds
proactively (queries that would poison the batch behind them), and
``m = -inf`` disables shedding entirely. ``fifo`` and ``edf`` ignore
``shed_events``.

Defensive LUT clamp: the effective max batch is clamped to the profiled
range (``len(lut) - 1``), so a configured ``batch_size`` above the
profile's largest batch can never silently extrapolate a bogus latency
(the seed scaled ``lut[-1] * b / (len - 1)``, i.e. linear-through-origin,
which can be wildly wrong for constant-latency stages).

Policy core (:mod:`repro_torch.core.policy`): the batch-formation *semantics*
— the scalar selection loops, the shed-margin schedule, the replica
pool — live in the runtime-agnostic policy core shared with the
wall-clock executor (:mod:`repro_torch.serving.executor`); this module is the
simulator's optimized driver over those primitives. The core's scalar
reference simulator (:func:`repro_torch.core.policy.simulate_stage_ref`) is
bit-identical to every policy here and carries the piecewise
policy-switching path (:func:`switched`).

``backend="torch"`` runs the FIFO fill through the hand-written CUDA
kernel (:mod:`repro_torch.sim.torch_backend`, on ``device``: CUDA
unless the caller asks for the CPU, where the kernel's plain torch
version runs); single fills below that module's threshold stay on
numpy, as the reference's ``"jax"`` does. Any other backend raises
``ValueError``, ``"jax"`` included. A fault spec with events routes
through the fault-aware event loop
(:func:`repro_torch.faults.simstage.simulate_stage_faults`).
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import (
    ReplicaPool as _ReplicaPool,
    ShedMarginSchedule,
    edf_select,
    effective_max_batch as _effective_max_batch,
    simulate_stage_ref,
    slo_drop_select,
)
from repro_torch.device import resolve_device

_FAR_FUTURE = 1e18
_INF = float("inf")

# (completion times, batch sizes formed, dropped mask) — all aligned with
# the sorted `ready` input except `batches`, which is per batch formed.
StageOutcome = Tuple[np.ndarray, np.ndarray, np.ndarray]


# Linear walks beat np.searchsorted's per-call overhead for short fills;
# wide fills (large batches) cross over to the O(log k) boundary search.
_SCAN_CROSSOVER = 64

# Blocked-fill tuning: the attempt size doubles while blocks commit in
# full and halves when they come up short; a block that commits fewer
# than _MIN_COMMIT batches triggers a scalar burst whose length doubles
# on repeated failures (and halves again on success), so stages that
# interleave regimes every few batches converge to pure scalar stepping
# and never pay block setup per batch.
_BLOCK_MIN = 128
_BLOCK_MAX = 8192
_MIN_COMMIT = 96
_BURST_MIN = 64
_BURST_MAX = 8192
# below this many queries a fill never attempts blocks: numpy call
# overhead cannot amortize against the lean scalar loop on short fills
# (planner probe traces are ~10k queries; hour-scale traces are >100k).
# The reference's measured crossover on its benchmark host.
_BLOCK_THRESHOLD = 32768


def fifo(
    ready: np.ndarray,
    latency_lut: np.ndarray,
    max_batch: int,
    replicas: int,
    replica_events: Optional[Sequence[Tuple[float, int]]] = None,
    timeout_s: float = 0.0,
    deadline: Optional[np.ndarray] = None,
    shed_events: Optional[Sequence[Tuple[float, float]]] = None,
    backend: str = "numpy",
    device=None,
) -> StageOutcome:
    """Arrival-order batching (the paper's policy). `deadline` and
    `shed_events` are ignored.

    Bit-identical to the seed estimator's ``_simulate_stage``; the fill
    runs through the blocked vectorized kernel (module docstring), or —
    with ``backend="torch"`` — through the CUDA fill kernel on
    ``device`` (:mod:`repro_torch.sim.torch_backend`), which leaves fills
    below its crossover threshold to numpy.
    """
    k = ready.shape[0]
    dropped = np.zeros(k, dtype=bool)
    if k == 0:
        return np.empty(0, dtype=np.float64), np.zeros(0, dtype=np.int64), \
            dropped
    eff_batch = _effective_max_batch(latency_lut, max_batch)
    if backend == "torch":
        from repro_torch.sim import torch_backend
        out = torch_backend.fifo_fill(ready, latency_lut, eff_batch,
                                      replicas, replica_events, timeout_s,
                                      device)
        if out is not None:
            done, batches = out
            return done, batches, dropped
    if not replica_events:
        if replicas <= 0:
            return (np.full(k, _FAR_FUTURE), np.zeros(0, dtype=np.int64),
                    dropped)
        if eff_batch == 1:
            done, batches = _fifo_batch1_static(ready, latency_lut,
                                                replicas)
            return done, batches, dropped
        pool = None
    else:
        pool = _ReplicaPool(replicas, replica_events)
    fill = _FifoFill(ready, latency_lut, eff_batch, timeout_s)
    if pool is None:
        done, batches = fill.run_static(replicas)
    else:
        done, batches = fill.run_dynamic(pool)
    return done, batches, dropped


def _fifo_batch1_static(ready: np.ndarray, latency_lut: np.ndarray,
                        replicas: int) -> Tuple[np.ndarray, np.ndarray]:
    """batch=1, fixed pool: the fill scan is vacuous (every batch is one
    query, so the timeout hold never applies) and the loop is a scalar
    recurrence. With R identical servers the replica-pool minimum at
    step i is exactly the completion of query i-R (services are equal,
    so completions leave the pool in insertion order): the heap reduces
    to ``done[i-R]``, bit-identical and allocation-free — cheaper per
    query than the blocked kernel's scalar step, and the planner's
    batch=1 probes are exactly this shape."""
    ready_l = ready.tolist()
    lat1 = latency_lut.tolist()[1]
    k = len(ready_l)
    ends: List[float] = []
    if replicas == 1:
        f = 0.0
        for r in ready_l:
            f = (r if r > f else f) + lat1
            ends.append(f)
    else:
        R = replicas
        for i, r in enumerate(ready_l):
            f = ends[i - R] if i >= R else 0.0
            ends.append((r if r > f else f) + lat1)
    return (np.asarray(ends, dtype=np.float64), np.ones(k, dtype=np.int64))


def _fill_boundary(ready: np.ndarray, ready_l: List[float],
                   ptr: int, limit: int, t: float) -> int:
    """First index in [ptr, limit) whose ready time exceeds `t`.

    `ready_l[ptr] <= t` always holds at call sites, so the right-bisection
    over the full array equals the seed's linear walk from `ptr`.
    """
    if limit - ptr <= _SCAN_CROSSOVER:
        hi = ptr + 1
        while hi < limit and ready_l[hi] <= t:
            hi += 1
        return hi
    hi = int(ready.searchsorted(t, side="right"))
    return hi if hi < limit else limit


class _FifoFill:
    """One FIFO fill: blocked vectorized fast paths + exact scalar steps.

    Completions are accumulated as run-length segments (a list of
    (batch-end, batch-size) array pairs) and materialized once at the
    end with ``np.repeat`` — identical to the seed's per-batch writes.
    """

    def __init__(self, ready: np.ndarray, latency_lut: np.ndarray,
                 eff_batch: int, timeout_s: float):
        self.ready = ready
        self.ready_l: List[float] = ready.tolist()
        self.lut = latency_lut
        self.lut_l: List[float] = latency_lut.tolist()
        self.B = eff_batch
        self.k = ready.shape[0]
        self.timeout_s = timeout_s
        self.ptr = 0
        self.block_batches = _BLOCK_MIN
        # (ends, counts) alternating scalar lists and committed block arrays
        self._seg_ends: List[np.ndarray] = []
        self._seg_counts: List[np.ndarray] = []
        self._sc_ends: List[float] = []
        self._sc_counts: List[int] = []
        # blocks assume completions never precede starts (lut >= 0); a
        # negative "latency" would break the order-statistic argument.
        # Short fills skip blocks outright (see _BLOCK_THRESHOLD).
        self._blocks_ok = (self.k >= _BLOCK_THRESHOLD
                           and min(self.lut_l[1:eff_batch + 1]) >= 0.0)
        self._runs_built = False
        self._nb_l: Optional[List[int]] = None

    # -- run-length precomputation ---------------------------------------
    def _build_runs(self) -> None:
        ready, k = self.ready, self.k
        newrun = np.empty(k, dtype=bool)
        newrun[0] = True
        np.not_equal(ready[1:], ready[:-1], out=newrun[1:])
        self._run_idx = np.cumsum(newrun) - 1
        self._run_starts = np.nonzero(newrun)[0]
        self._run_ends = np.append(self._run_starts[1:], k)
        self._runs_built = True

    def _nb(self) -> List[int]:
        """nb[p]: boundary of an underload batch headed at p (timeout=0) —
        min(p + B, end of p's tie run). One vectorized table replaces the
        seed's per-query fill walk in the scalar path."""
        if self._nb_l is None:
            if not self._runs_built:
                self._build_runs()
            nb = np.minimum(np.arange(self.k) + self.B,
                            self._run_ends[self._run_idx])
            self._nb_l = nb.tolist()
        return self._nb_l

    # -- segment bookkeeping ----------------------------------------------
    def _flush_scalar(self) -> None:
        if self._sc_ends:
            self._seg_ends.append(np.asarray(self._sc_ends, dtype=np.float64))
            self._seg_counts.append(
                np.asarray(self._sc_counts, dtype=np.int64))
            # clear in place: the drivers hold bound .append methods
            self._sc_ends.clear()
            self._sc_counts.clear()

    def _commit_block(self, ends: np.ndarray, counts: np.ndarray) -> None:
        self._flush_scalar()
        self._seg_ends.append(ends)
        self._seg_counts.append(counts)

    def _finish(self) -> Tuple[np.ndarray, np.ndarray]:
        self._flush_scalar()
        if not self._seg_ends:
            return (np.empty(0, dtype=np.float64),
                    np.zeros(0, dtype=np.int64))
        ends = (self._seg_ends[0] if len(self._seg_ends) == 1
                else np.concatenate(self._seg_ends))
        counts = (self._seg_counts[0] if len(self._seg_counts) == 1
                  else np.concatenate(self._seg_counts))
        return np.repeat(ends, counts), counts

    # -- vectorized blocks -------------------------------------------------
    def _under_block(self, free: List[float], t_gate: float) -> int:
        """Underload block: batches are tie runs of `ready` capped at B,
        started at their head arrival. Valid while the replica pool has a
        server free by each head arrival — checked en masse by counting,
        per batch j, pool free times and earlier block completions at or
        below the head arrival: the (j+1)-th smallest such value is the
        server that would be popped. Commits the valid prefix; returns
        the number of batches committed."""
        if not self._runs_built:
            self._build_runs()
        ptr, B = self.ptr, self.B
        cap = self.block_batches
        r0i = int(self._run_idx[ptr])
        nruns = self._run_starts.shape[0]
        # each run yields >= 1 batch, so `cap` runs suffice
        hi_run = min(r0i + cap, nruns)
        starts = self._run_starts[r0i:hi_run].copy()
        starts[0] = ptr
        rends = self._run_ends[r0i:hi_run]
        cnts = -((starts - rends) // B)          # ceil((end - start) / B)
        ccum = np.cumsum(cnts)
        need = int(np.searchsorted(ccum, cap, side="left")) + 1
        if need < starts.shape[0]:
            starts, rends = starts[:need], rends[:need]
            cnts, ccum = cnts[:need], ccum[:need]
        total = int(ccum[-1])
        # expand runs -> batch head positions and sizes
        offs = np.repeat(ccum - cnts, cnts)
        within = np.arange(total) - offs
        bs = np.repeat(starts, cnts) + B * within
        sizes = np.minimum(np.repeat(rends, cnts) - bs, B)
        if total > cap:
            bs, sizes = bs[:cap], sizes[:cap]
            total = cap
        r0v = self.ready[bs]
        ends = r0v + self.lut[sizes]
        # validity: batch j is served at its head arrival iff >= j+1 of
        # {pool free times} ∪ {block completions 0..j-1} are <= r0v[j]
        h = np.sort(np.asarray(free, dtype=np.float64))
        avail = np.searchsorted(h, r0v, side="right")
        t_m = np.searchsorted(r0v, ends, side="left")
        pos = np.maximum(t_m, np.arange(1, total + 1))
        np.minimum(pos, total, out=pos)
        avail += np.cumsum(np.bincount(pos, minlength=total + 1))[:total]
        valid = avail >= np.arange(1, total + 1)
        if t_gate != _INF:
            valid &= r0v < t_gate
        j = int(np.argmin(valid)) if not valid.all() else total
        if j == 0:
            return 0
        ends_c, sizes_c = ends[:j], sizes[:j]
        self._commit_block(ends_c, sizes_c)
        self.ptr = int(bs[j - 1]) + int(sizes_c[j - 1])
        merged = np.sort(np.concatenate([h, ends_c]))
        free[:] = merged[j:].tolist()            # sorted list is a heap
        return j

    def _over_block(self, free: List[float], t_gate: float) -> int:
        """Backlog block: consecutive full-size batches. All services
        equal lut[B], so the heap's pop sequence is the sorted merge of
        one arithmetic progression per server (exact via per-lane cumsum,
        which accumulates sequentially like the scalar loop). Valid while
        each batch's last query arrived by its server's free time."""
        ptr, B, k = self.ptr, self.B, self.k
        L = self.lut_l[B]
        if L <= 0.0:                  # degenerate: progressions collapse
            return 0
        total = min((k - ptr) // B, self.block_batches)
        if total <= 0:
            return 0
        R = len(free)
        nterms = (total + R - 1) // R + 2
        mat = np.empty((R, nterms), dtype=np.float64)
        mat[:, 0] = np.sort(np.asarray(free, dtype=np.float64))
        mat[:, 1:] = L
        np.cumsum(mat, axis=1, out=mat)
        flat = mat.ravel()
        order = np.argsort(flat, kind="stable")[:total]
        f = flat[order]
        # last query of batch j must be waiting when its server frees
        lasts = self.ready[ptr + B - 1: ptr + total * B: B]
        valid = lasts <= f
        # beyond min(lane tails) the merge may miss ungenerated elements
        valid &= f <= mat[:, -1].min()
        if t_gate != _INF:
            valid &= f < t_gate
        j = int(np.argmin(valid)) if not valid.all() else total
        if j == 0:
            return 0
        ends_c = f[:j] + L
        self._commit_block(ends_c, np.full(j, B, dtype=np.int64))
        self.ptr = ptr + j * B
        popped = np.bincount(order[:j] // nterms, minlength=R)
        exhausted = popped >= nterms              # == only; advance by +L
        lane_next = mat[np.arange(R), np.minimum(popped, nterms - 1)]
        lane_next = np.where(exhausted, lane_next + L, lane_next)
        free[:] = np.sort(lane_next).tolist()
        return j

    def _try_block(self, free: List[float], t_gate: float) -> int:
        """One block attempt; adapts the attempt size to the commit rate
        so steadily-committing fills grow their blocks and churny fills
        shrink them."""
        if not self._blocks_ok or not free:
            return 0
        if self.ready_l[self.ptr] >= free[0]:     # heap min: regime probe
            if self.timeout_s > 0.0:
                got = 0       # underload + timeout: holds alter boundaries
            else:
                got = self._under_block(free, t_gate)
        else:
            got = self._over_block(free, t_gate)
        if got >= self.block_batches:
            self.block_batches = min(self.block_batches * 2, _BLOCK_MAX)
        elif got < _MIN_COMMIT:
            # failed attempt: restart small so churny stretches pay the
            # cheapest possible setup on the next try
            self.block_batches = _BLOCK_MIN
        elif got < self.block_batches // 4:
            self.block_batches = max(self.block_batches // 2, _BLOCK_MIN)
        return got

    # -- drivers -----------------------------------------------------------
    def run_static(self, replicas: int) -> Tuple[np.ndarray, np.ndarray]:
        """Static replica pool (the planner's hot path). Scalar stepping
        is inlined with local bindings: per batch it is one heap pop, a
        boundary lookup (precomputed run table when there is no timeout),
        one add, and a heap push — the seed's per-query fill walk and all
        numpy scalar indexing are gone."""
        free = [0.0] * replicas
        heapq.heapify(free)
        pop, push = heapq.heappop, heapq.heappush
        ready, ready_l, lut_l = self.ready, self.ready_l, self.lut_l
        k, B = self.k, self.B
        timeout_s = self.timeout_s
        end_app = self._sc_ends.append
        cnt_app = self._sc_counts.append
        nb_l: Optional[List[int]] = None
        ptr = 0
        burst, backoff = 0, _BURST_MIN
        while ptr < k:
            if burst == 0:
                self.ptr = ptr
                got = self._try_block(free, _INF)
                ptr = self.ptr
                if got >= _MIN_COMMIT:
                    backoff = max(backoff // 2, _BURST_MIN)
                    continue
                burst = backoff
                backoff = min(backoff * 2, _BURST_MAX)
                if ptr >= k:
                    break
                if nb_l is None and timeout_s == 0.0:
                    nb_l = self._nb()
            f = pop(free)
            r0 = ready_l[ptr]
            if nb_l is not None and r0 >= f:
                # underload, no timeout: boundary from the run table; the
                # start value is r0 whether the seed's max picked r0
                # (r0 > f) or the tied f (r0 == f)
                hi = nb_l[ptr]
                b = hi - ptr
                end = r0 + lut_l[b]
            else:
                start = r0 if r0 > f else f
                full_limit = ptr + B
                limit = full_limit if full_limit < k else k
                hi = _fill_boundary(ready, ready_l, ptr, limit, start)
                if timeout_s > 0.0 and hi < limit:
                    # timeout batching (beyond-paper): hold the batch open
                    # until either max_batch queries are ready or
                    # `timeout_s` elapses from the head-of-line arrival
                    hold_until = r0 + timeout_s
                    if hold_until > start:
                        # a batch that can never fill waits out the timeout
                        fill_t = ready_l[full_limit - 1] \
                            if full_limit - 1 < k else _FAR_FUTURE
                        start = min(max(start, fill_t), hold_until)
                        hi = _fill_boundary(ready, ready_l, ptr, limit,
                                            start)
                b = hi - ptr
                end = start + lut_l[b]
            end_app(end)
            cnt_app(b)
            ptr = hi
            push(free, end)
            burst -= 1
        self.ptr = ptr
        return self._finish()

    def run_dynamic(self, pool: _ReplicaPool) -> Tuple[np.ndarray, np.ndarray]:
        ready, ready_l, lut_l = self.ready, self.ready_l, self.lut_l
        k, B = self.k, self.B
        starved = False
        burst, backoff = 0, _BURST_MIN
        while self.ptr < k:
            if not pool.free:
                if pool.has_future_adds():
                    pool.fast_forward()
                    continue
                self._sc_ends.append(_FAR_FUTURE)  # no capacity ever again
                self._sc_counts.append(k - self.ptr)
                starved = True
                break
            if burst == 0:
                # blocks must not cross a scale event or a pending
                # retirement — both mutate the pool mid-fill
                if not pool.pending_removals:
                    t_gate = (pool.events[pool.ev_i][0]
                              if pool.ev_i < len(pool.events) else _INF)
                    got = self._try_block(pool.free, t_gate)
                    if got >= _MIN_COMMIT:
                        backoff = max(backoff // 2, _BURST_MIN)
                        continue
                burst = backoff
                backoff = min(backoff * 2, _BURST_MAX)
                if self.ptr >= k:
                    break
            ptr = self.ptr
            f = heapq.heappop(pool.free)
            r0 = ready_l[ptr]
            start = r0 if r0 > f else f
            pool.apply_events(start)
            if pool.retire_if_pending(start):
                burst -= 1
                continue
            full_limit = ptr + B
            limit = full_limit if full_limit < k else k
            hi = _fill_boundary(ready, ready_l, ptr, limit, start)
            if self.timeout_s > 0.0 and hi < limit:
                hold_until = r0 + self.timeout_s
                if hold_until > start:
                    fill_t = ready_l[full_limit - 1] if full_limit - 1 < k \
                        else _FAR_FUTURE
                    start = min(max(start, fill_t), hold_until)
                    hi = _fill_boundary(ready, ready_l, ptr, limit, start)
            b = hi - ptr
            end = start + lut_l[b]
            self._sc_ends.append(end)
            self._sc_counts.append(b)
            self.ptr = hi
            heapq.heappush(pool.free, end)
            burst -= 1
        done, counts = self._finish()
        # the capacity-exhausted tail is a run, not a served batch
        return done, (counts[:-1] if starved else counts)


def edf(
    ready: np.ndarray,
    latency_lut: np.ndarray,
    max_batch: int,
    replicas: int,
    replica_events: Optional[Sequence[Tuple[float, int]]] = None,
    timeout_s: float = 0.0,
    deadline: Optional[np.ndarray] = None,
    shed_events: Optional[Sequence[Tuple[float, float]]] = None,
    backend: str = "numpy",
    device=None,
) -> StageOutcome:
    """Earliest-deadline-first batching. ``shed_events``, ``backend`` and
    ``device`` are ignored (the scalar deadline-heap loop has no device
    analogue).

    At each dispatch, the batch is the (up to) ``max_batch`` queries with
    the earliest deadlines among those ready. Without deadlines this
    degrades to ordering by ready time (= FIFO). ``timeout_s`` is ignored:
    EDF already trades head latency explicitly via the deadline order.

    The pending set is a (deadline, index) heap, so sustained backlog —
    exactly the regime EDF targets — costs O(n log n), not O(n^2). A
    popped entry that is not yet ready at this dispatch instant (possible
    because dispatch times are not monotone across replicas) is deferred
    and re-pushed; deferrals only arise after idle-jump admissions and
    stay rare.
    """
    k = ready.shape[0]
    done = np.full(k, _FAR_FUTURE, dtype=np.float64)
    dropped = np.zeros(k, dtype=bool)
    if k == 0:
        return done, np.zeros(0, dtype=np.int64), dropped
    eff_batch = _effective_max_batch(latency_lut, max_batch)
    pool = _ReplicaPool(replicas, replica_events)
    batches: List[int] = []
    ready_l = ready.tolist()
    lut_l = latency_lut.tolist()
    key_l = deadline.tolist() if deadline is not None else ready_l

    pending: List[Tuple[float, int]] = []   # heap of (deadline, idx)
    ai = 0                         # next un-admitted index (ready-sorted)
    served = 0
    while served < k:
        if not pool.free:
            if pool.has_future_adds():
                pool.fast_forward()
                continue
            break                   # unserved queries keep _FAR_FUTURE
        f = heapq.heappop(pool.free)
        start = f
        take: List[int] = []
        retired = False
        while True:
            if pool.events:
                pool.apply_events(start)
                if pool.retire_if_pending(start):
                    retired = True
                    break
            while ai < k and ready_l[ai] <= start:
                heapq.heappush(pending, (key_l[ai], ai))
                ai += 1
            take = edf_select(pending, ready_l, start, eff_batch)
            if take:
                break
            # nothing serviceable at `start`: the replica idles until the
            # earliest instant any unserved query becomes ready
            t_next = min((ready_l[i] for _, i in pending), default=np.inf)
            if ai < k and ready_l[ai] < t_next:
                t_next = ready_l[ai]
            start = t_next          # finite: served < k => queries remain
        if retired:
            continue
        b = len(take)
        end = start + lut_l[b]
        for i in take:
            done[i] = end
        batches.append(b)
        served += b
        heapq.heappush(pool.free, end)
    return done, np.asarray(batches, dtype=np.int64), dropped


def slo_drop(
    ready: np.ndarray,
    latency_lut: np.ndarray,
    max_batch: int,
    replicas: int,
    replica_events: Optional[Sequence[Tuple[float, int]]] = None,
    timeout_s: float = 0.0,
    deadline: Optional[np.ndarray] = None,
    shed_events: Optional[Sequence[Tuple[float, float]]] = None,
    backend: str = "numpy",
    device=None,
) -> StageOutcome:
    """FIFO with SLO-aware shedding at dequeue (admission control).

    When a batch is formed at time ``start``, any candidate query whose
    deadline cannot be met even by a batch-1 dispatch right now
    (``deadline < start + lut[1] + m(start)``) is dropped rather than
    served: it completes at ``+inf`` and is flagged in the drop mask.
    Under overload this keeps the queue from collapsing — the paper's
    feasibility-only planner has no answer once the offered load exceeds
    capacity. The shed margin ``m(t)`` defaults to 0 and is piecewise
    reprogrammable via ``shed_events`` (module docstring) — the
    closed-loop Tuner's admission-control knob.

    ``timeout_s`` is ignored (as in ``edf``) — holding a batch open is
    at odds with shedding already-late work — and it is ignored
    consistently whether or not deadlines are supplied, so a stage
    config means the same system with and without an ``slo_s``.
    Without deadlines there is nothing to shed against and the policy
    reduces to greedy-batching ``fifo``.

    Hot-loop engineering: like ``fifo``, all per-query numpy scalar
    indexing (``ready[ptr]``, ``deadline[i]``, the LUT) is hoisted to
    native lists — exact same IEEE-754 values, regression-tested against
    the original loop in ``tests/test_fill_kernel.py``.
    """
    if deadline is None:
        return fifo(ready, latency_lut, max_batch, replicas,
                    replica_events, timeout_s=0.0, backend=backend,
                    device=device)
    k = ready.shape[0]
    done = np.empty(k, dtype=np.float64)
    dropped = np.zeros(k, dtype=bool)
    if k == 0:
        return done, np.zeros(0, dtype=np.int64), dropped
    eff_batch = _effective_max_batch(latency_lut, max_batch)
    ready_l = ready.tolist()
    deadline_l = deadline.tolist()
    lut_l = latency_lut.tolist()
    solo_lat = lut_l[1]
    pool = _ReplicaPool(replicas, replica_events)
    batches: List[int] = []
    # piecewise-constant shed margin (policy core): batch starts are not
    # monotone under dynamic pools (a replica added at an earlier t can
    # pop below the previous start), so each batch bisects the schedule
    shed = ShedMarginSchedule(shed_events)

    ptr = 0
    while ptr < k:
        if not pool.free:
            if pool.has_future_adds():
                pool.fast_forward()
                continue
            done[ptr:] = _FAR_FUTURE
            break
        f = heapq.heappop(pool.free)
        r0 = ready_l[ptr]
        start = r0 if r0 > f else f
        pool.apply_events(start)
        if pool.retire_if_pending(start):
            continue
        # form the batch in arrival order, shedding hopeless queries
        floor = start + solo_lat + shed.margin(start)
        take, shed_idx, ptr = slo_drop_select(
            ready_l, deadline_l, None, ptr, k, start, floor, eff_batch)
        for i in shed_idx:
            dropped[i] = True
            done[i] = np.inf
        if not take:                 # everything scanned was shed
            heapq.heappush(pool.free, f)
            continue
        b = len(take)
        end = start + lut_l[b]
        done[take] = end
        batches.append(b)
        heapq.heappush(pool.free, end)
    return done, np.asarray(batches, dtype=np.int64), dropped


PolicyFn = Callable[..., StageOutcome]

QUEUE_POLICIES: Dict[str, PolicyFn] = {
    "fifo": fifo,
    "edf": edf,
    "slo-drop": slo_drop,
}


def get_policy(name: str) -> PolicyFn:
    try:
        return QUEUE_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown queueing policy {name!r}; "
            f"have {sorted(QUEUE_POLICIES)}") from None


def simulate_stage(
    policy: str,
    ready: np.ndarray,
    latency_lut: np.ndarray,
    max_batch: int,
    replicas: int,
    replica_events: Optional[Sequence[Tuple[float, int]]] = None,
    timeout_s: float = 0.0,
    deadline: Optional[np.ndarray] = None,
    shed_events: Optional[Sequence[Tuple[float, float]]] = None,
    policy_events: Optional[Sequence[Tuple[float, str]]] = None,
    backend: str = "numpy",
    fault_spec=None,
    device=None,
) -> StageOutcome:
    """Dispatch to a named policy. `ready` must be sorted ascending.

    A non-empty ``policy_events`` (sorted ``(t, policy_name)`` switch
    points) routes through :func:`switched` instead — the policy-core
    scalar path that re-evaluates the policy at every batch dispatch.

    ``backend`` selects the fill kernel implementation for policies that
    have one (``fifo``): ``"numpy"`` (default) or ``"torch"``, the CUDA
    kernel of :mod:`repro_torch.sim.torch_backend` on ``device`` (None:
    CUDA, which raises on a host without a GPU; ``"cpu"`` runs the
    kernel's plain torch version). Both are bit-identical. A single fill
    stays on numpy unless that module's ``_FILL_THRESHOLD`` is lowered;
    the engine routes candidate grids through ``grid_stage_percentiles``
    directly.

    A non-empty ``fault_spec`` (:class:`repro_torch.faults.schedule
    .StageFaults`) routes through the scalar fault-aware event loop
    (:func:`repro_torch.faults.simstage.simulate_stage_faults`) which
    handles crashes/stragglers/transient errors plus retry/hedge recovery
    and folds ``policy_events`` itself; ``None`` or empty specs take the
    existing paths untouched (bit-identical no-fault guarantee).
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"have ('numpy', 'torch')")
    if backend == "torch":
        device = resolve_device(device)
    if fault_spec is not None and fault_spec.events:
        from repro_torch.faults.simstage import simulate_stage_faults

        return simulate_stage_faults(
            policy, ready, latency_lut, max_batch, replicas,
            replica_events, timeout_s, deadline, shed_events,
            policy_events, fault_spec)
    if policy_events:
        return switched(ready, latency_lut, max_batch, replicas,
                        replica_events, timeout_s, deadline, shed_events,
                        policy, policy_events)
    return get_policy(policy)(ready, latency_lut, max_batch, replicas,
                              replica_events, timeout_s, deadline,
                              shed_events, backend=backend, device=device)


def switched(
    ready: np.ndarray,
    latency_lut: np.ndarray,
    max_batch: int,
    replicas: int,
    replica_events: Optional[Sequence[Tuple[float, int]]] = None,
    timeout_s: float = 0.0,
    deadline: Optional[np.ndarray] = None,
    shed_events: Optional[Sequence[Tuple[float, float]]] = None,
    policy: str = "fifo",
    policy_events: Optional[Sequence[Tuple[float, str]]] = None,
) -> StageOutcome:
    """Piecewise policy schedule: serve with ``policy`` until the first
    ``(t, name)`` switch event, re-evaluating the in-force policy at each
    batch's dispatch instant (see :class:`repro_torch.core.policy
    .PolicySchedule`). With no switch events this is bit-identical to the
    dedicated policy (property-tested); the scalar policy-core stepping
    trades the vectorized FIFO fill for full mid-run reprogrammability —
    the closed-loop Tuner's schedulable fifo->edf control events land
    here.
    """
    get_policy(policy)            # validate the base name eagerly
    return simulate_stage_ref(ready, latency_lut, max_batch, replicas,
                              replica_events, timeout_s, deadline,
                              shed_events, policy, policy_events)
