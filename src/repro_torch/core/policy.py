"""Runtime-agnostic queueing-policy core (shared by sim and live serving).

InferLine's contract (§3, §5) is that the planner/tuner manage *any*
serving runtime offering centralized batched queues, a configurable max
batch size, and runtime replica scaling. That only holds if the
controller's model of the queue discipline matches what the runtime
actually does — so the batch-formation semantics of the three queueing
policies live HERE, in one module, and both backends consume them:

* the discrete-event simulator (:mod:`repro_torch.sim.queueing`) calls the
  scalar selection primitives (:func:`edf_select`,
  :func:`slo_drop_select`) and the :class:`ShedMarginSchedule`
  evaluation inside its per-stage loops (its vectorized FIFO fill is an
  optimized equivalent, golden-guarded bit-identical to
  :func:`fifo_select`-driven stepping);
* the wall-clock executor drives a :class:`LiveQueue` per stage, whose
  ``form_batch`` applies the same primitives to streaming requests.

The module also hosts :func:`simulate_stage_ref` — a scalar reference
simulator over the primitives. It is the equivalence oracle for the
policy-core property suite (bit-identical to every
:mod:`repro_torch.sim.queueing` policy on random traces) and the
execution path for *policy-switching* stages: a
:class:`PolicySchedule` (piecewise ``fifo -> edf`` etc.) is evaluated at
each batch start, which is exactly what a schedulable policy-switch
policy-switch control event folds into.

A copy of the reference's ``repro.core.policy``; ``tests/test_torch_plan.py``
holds the port's simulator, which runs on it, bit-identical to the
reference's.

Policy semantics (shared, batch formed at dispatch instant ``start``):

* ``fifo``     — arrival order, up to ``max_batch`` of the queries with
  ``ready <= start`` (plus the optional batch-formation timeout hold);
* ``edf``      — among queries with ``ready <= start``, the ``max_batch``
  earliest deadlines;
* ``slo-drop`` — arrival order, but a query whose deadline cannot be met
  even by a batch-1 dispatch right now
  (``deadline < start + solo_latency + margin(start)``) is shed instead
  of served.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_FAR_FUTURE = 1e18

POLICY_NAMES: Tuple[str, ...] = ("fifo", "edf", "slo-drop")


def check_policy_name(name: str) -> str:
    if name not in POLICY_NAMES:
        raise ValueError(
            f"unknown queueing policy {name!r}; have {sorted(POLICY_NAMES)}")
    return name


def effective_max_batch(latency_lut: np.ndarray, max_batch: int) -> int:
    """Clamp the configured max batch to the profiled LUT range (a batch
    above the largest profiled size must never silently extrapolate)."""
    lat_len = int(latency_lut.shape[0])
    if lat_len < 2:
        raise ValueError(
            f"latency LUT must cover at least batch=1 (got {lat_len} entries)")
    return min(int(max_batch), lat_len - 1)


# -- piecewise-constant control schedules -----------------------------------


class ShedMarginSchedule:
    """Piecewise-constant slo-drop shed margin ``m(t)``.

    Built from a sorted ``(t, margin_s)`` event list; before the first
    event the margin is 0 (the policy's historical behavior), ``m > 0``
    sheds proactively, ``m = -inf`` disables shedding entirely. Batch
    starts are not monotone under dynamic replica pools, so lookups
    bisect rather than stream.
    """

    __slots__ = ("ts", "ms")

    def __init__(self, events: Optional[Sequence[Tuple[float, float]]] = None):
        ev = sorted(events) if events else []
        self.ts: List[float] = [t for t, _ in ev]
        self.ms: List[float] = [m for _, m in ev]

    def margin(self, t: float) -> float:
        if not self.ts:
            return 0.0
        si = bisect.bisect_right(self.ts, t)
        return self.ms[si - 1] if si else 0.0

    def __bool__(self) -> bool:
        return bool(self.ts)


class PolicySchedule:
    """Piecewise-constant queueing policy ``p(t)``: a base policy plus
    sorted ``(t, policy_name)`` switch events. The policy in force for a
    batch is ``policy_at(start)`` of the batch's dispatch instant —
    the semantics a scheduled fifo->edf control event lands with, in
    simulation and live serving alike."""

    __slots__ = ("base", "ts", "ps")

    def __init__(self, base: str,
                 events: Optional[Sequence[Tuple[float, str]]] = None):
        self.base = check_policy_name(base)
        ev = sorted(events, key=lambda e: e[0]) if events else []
        self.ts: List[float] = [t for t, _ in ev]
        self.ps: List[str] = [check_policy_name(p) for _, p in ev]

    def policy_at(self, t: float) -> str:
        if not self.ts:
            return self.base
        si = bisect.bisect_right(self.ts, t)
        return self.ps[si - 1] if si else self.base

    def constant(self) -> bool:
        return not self.ts

    def __bool__(self) -> bool:
        return bool(self.ts)


# -- the shared replica pool ------------------------------------------------


class ReplicaPool:
    """Heap of replica free-times plus the (t, +/-1) dynamic scale events.

    ``+1`` adds a replica free at ``t``; ``-1`` retires the next replica
    to go idle at/after ``t`` (scale-down drains: an in-service batch
    always completes). Shared by every simulator policy loop.
    """

    def __init__(self, replicas: int,
                 events: Optional[Sequence[Tuple[float, int]]]):
        self.free: List[float] = [0.0] * max(replicas, 0)
        heapq.heapify(self.free)
        # sort by t only (stable): a same-t (+1,-1) churn pair must keep
        # arrival order — a full-tuple sort would drain before adding
        self.events = (sorted(events, key=lambda e: e[0])
                       if events else [])
        self.ev_i = 0
        self.pending_removals: List[float] = []

    def apply_events(self, now: float) -> None:
        while self.ev_i < len(self.events) and self.events[self.ev_i][0] <= now:
            t, delta = self.events[self.ev_i]
            self.ev_i += 1
            if delta > 0:
                for _ in range(delta):
                    heapq.heappush(self.free, t)
            else:
                for _ in range(-delta):
                    self.pending_removals.append(t)

    def has_future_adds(self) -> bool:
        return self.ev_i < len(self.events)

    def fast_forward(self) -> None:
        self.apply_events(self.events[self.ev_i][0])

    def retire_if_pending(self, now: float) -> bool:
        """True if the just-popped replica is retired by a pending removal."""
        if self.pending_removals and self.pending_removals[0] <= now:
            self.pending_removals.pop(0)
            return True
        return False


# -- batch-formation primitives ---------------------------------------------
#
# These are the exact scalar selection loops of the simulator policies,
# parameterized so the live executor and the reference simulator can run
# them over non-contiguous pending sets: `served` (optional mapping
# index -> consumed?) lets a caller interleave policies over one queue.


def fifo_select(ready_l, served, i: int, k: int, start: float,
                max_batch: int) -> Tuple[List[int], int]:
    """Arrival-order batch at `start`: up to `max_batch` entries with
    ``ready <= start`` from cursor `i`. Returns (take, new_cursor).

    Semantics are mirrored by the streaming walk in
    :meth:`LiveQueue.form_batch` — change both together."""
    take: List[int] = []
    while i < k and len(take) < max_batch:
        if served is not None and served[i]:
            i += 1
            continue
        if ready_l[i] > start:
            break
        take.append(i)
        i += 1
    return take, i


def edf_select(pending: List[Tuple[float, int]], ready_l, start: float,
               max_batch: int, served=None) -> List[int]:
    """Pop the (up to) `max_batch` earliest-deadline READY entries off the
    ``(deadline, idx)`` heap. A popped entry not yet ready at `start`
    (dispatch times are not monotone across replicas) is deferred and
    re-pushed; an entry consumed by another policy while queued
    (``served``) is discarded."""
    take: List[int] = []
    deferred: List[Tuple[float, int]] = []
    while pending and len(take) < max_batch:
        item = heapq.heappop(pending)
        if served is not None and served[item[1]]:
            continue
        if ready_l[item[1]] <= start:
            take.append(item[1])
        else:
            deferred.append(item)
    for item in deferred:
        heapq.heappush(pending, item)
    return take


def slo_drop_select(ready_l, deadline_l, served, i: int, k: int,
                    start: float, floor: float, max_batch: int
                    ) -> Tuple[List[int], List[int], int]:
    """Arrival-order batch with SLO-aware shedding at dequeue: an entry
    whose ``deadline < floor`` (``floor = start + solo_latency +
    margin(start)``) is shed instead of served. Returns
    (take, shed, new_cursor); every scanned entry is consumed.

    Semantics are mirrored by the streaming walk in
    :meth:`LiveQueue.form_batch` — change both together."""
    take: List[int] = []
    shed: List[int] = []
    while i < k and len(take) < max_batch:
        if served is not None and served[i]:
            i += 1
            continue
        if ready_l[i] > start:
            break
        if deadline_l[i] < floor:
            shed.append(i)
        else:
            take.append(i)
        i += 1
    return take, shed, i


# -- scalar reference stage simulator ---------------------------------------


def simulate_stage_ref(
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
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One centralized stage queue, R servers, policy-core stepping.

    The canonical scalar semantics of all three policies over one
    pending set — bit-identical to the dedicated (vectorized/hoisted)
    :mod:`repro_torch.sim.queueing` policies when ``policy_events`` is empty
    (pinned by the reference's policy-core tests), and the execution path
    for piecewise policy schedules: the policy in force is evaluated at
    each batch's dispatch instant, so a fifo->edf switch at ``t`` starts
    deadline-ordering every batch dispatched from ``t`` on, over the
    queue as it stands.

    ``timeout_s`` applies to batches formed under ``fifo`` (the
    beyond-paper formation hold); ``edf``/``slo-drop`` batches ignore it,
    exactly as the dedicated policies do. Returns (completion times
    aligned with `ready`, per-batch sizes, shed mask).
    """
    k = int(ready.shape[0])
    done = np.full(k, _FAR_FUTURE, dtype=np.float64)
    dropped = np.zeros(k, dtype=bool)
    if k == 0:
        return done, np.zeros(0, dtype=np.int64), dropped
    eff_batch = effective_max_batch(latency_lut, max_batch)
    pol = PolicySchedule(policy, policy_events)
    # the dedicated slo-drop (and edf key) semantics without deadlines:
    # slo-drop reduces to greedy fifo (timeout ignored), edf orders by
    # ready time
    have_deadline = deadline is not None
    ready_l: List[float] = ready.tolist()
    lut_l: List[float] = latency_lut.tolist()
    deadline_l: List[float] = (deadline.tolist() if have_deadline
                               else ready_l)
    solo_lat = lut_l[1]
    shed = ShedMarginSchedule(shed_events)
    pool = ReplicaPool(replicas, replica_events)
    served = [False] * k
    batches: List[int] = []
    edf_heap: List[Tuple[float, int]] = []     # (deadline, idx), lazily fed
    ai = 0                                     # next un-admitted index
    ptr = 0                                    # first possibly-pending index
    remaining = k

    while remaining > 0:
        if not pool.free:
            if pool.has_future_adds():
                pool.fast_forward()
                continue
            break                   # starved: leftovers keep _FAR_FUTURE
        f = heapq.heappop(pool.free)
        while ptr < k and served[ptr]:
            ptr += 1
        r0 = ready_l[ptr]           # earliest pending ready (sorted input)
        start = r0 if r0 > f else f
        pool.apply_events(start)
        if pool.retire_if_pending(start):
            continue
        p = pol.policy_at(start)
        # the formation timeout belongs to fifo alone; a deadline-less
        # slo-drop batch degrades to greedy fifo but keeps timeout
        # disabled, so a stage config means the same system with and
        # without an slo_s (the dedicated policy's documented contract)
        p_timeout = timeout_s if p == "fifo" else 0.0
        if p == "slo-drop" and not have_deadline:
            p = "fifo"

        if p == "edf":
            while ai < k and ready_l[ai] <= start:
                if not served[ai]:
                    heapq.heappush(edf_heap, (deadline_l[ai], ai))
                ai += 1
            take = edf_select(edf_heap, ready_l, start, eff_batch, served)
            # start >= r0 and queries remain, so a batch always forms
        elif p == "slo-drop":
            floor = start + solo_lat + shed.margin(start)
            take, shed_idx, ptr = slo_drop_select(
                ready_l, deadline_l, served, ptr, k, start, floor, eff_batch)
            for i in shed_idx:
                dropped[i] = True
                done[i] = np.inf
                served[i] = True
            remaining -= len(shed_idx)
            if not take:             # everything scanned was shed
                heapq.heappush(pool.free, f)
                continue
        else:                        # fifo (+ optional formation timeout)
            take, hi = fifo_select(ready_l, served, ptr, k, start, eff_batch)
            if p_timeout > 0.0 and take:
                # candidate window: the first eff_batch pending entries in
                # arrival order, ready or not — the batch holds open until
                # it can fill (the window's last entry arrives) or
                # `timeout_s` elapses from the head-of-line arrival
                cand: List[int] = []
                j = ptr
                while j < k and len(cand) < eff_batch:
                    if not served[j]:
                        cand.append(j)
                    j += 1
                if len(take) < len(cand):
                    hold_until = r0 + timeout_s
                    if hold_until > start:
                        fill_t = (ready_l[cand[-1]]
                                  if len(cand) == eff_batch else _FAR_FUTURE)
                        start = min(max(start, fill_t), hold_until)
                        take = [i for i in cand if ready_l[i] <= start]
                        hi = take[-1] + 1
            ptr = hi

        b = len(take)
        end = start + lut_l[b]
        for i in take:
            done[i] = end
            served[i] = True
        remaining -= b
        batches.append(b)
        heapq.heappush(pool.free, end)

    return done, np.asarray(batches, dtype=np.int64), dropped


# -- live (streaming) centralized queue -------------------------------------


class LiveQueue:
    """Policy-aware centralized queue over streaming work items — the
    wall-clock executor's per-stage queue.

    Items are pushed with their queue-ready instant (arrival + upstream
    hop delay) and optional deadline; :meth:`form_batch` implements the
    same batch-formation semantics the simulator's policies run — edf
    literally calls :func:`edf_select`, while the fifo/slo-drop branch
    is an arrival-heap walk mirroring :func:`fifo_select` /
    :func:`slo_drop_select` (those operate on index cursors, the live
    queue on a streaming heap; any semantics change there must land in
    both places — see the cross-references on the primitives). Policy,
    shed margin, and deadlines are all reprogrammable at runtime (the
    control plane's knobs).

    Not thread-safe by itself — the executor serializes access under the
    stage lock.
    """

    def __init__(self, policy: str = "fifo", timeout_s: float = 0.0):
        self.policy = check_policy_name(policy)
        self.shed_margin = 0.0
        # batch-formation hold (StageConfig.timeout_s): a partial fifo
        # batch is held open until `timeout_s` past the head-of-line
        # ready instant — the simulator's beyond-paper timeout semantics
        # (repro_torch.sim.queueing.fifo). edf/slo-drop ignore it, as in the
        # simulator.
        self.timeout_s = float(timeout_s)
        self._seq = itertools.count()
        # arrival order: (ready, seq) heap; deadline order: (deadline, seq)
        self._arr: List[Tuple[float, int]] = []
        self._edf: List[Tuple[float, int]] = []
        self._items: Dict[int, object] = {}
        self._ready: Dict[int, float] = {}
        self._deadline: Dict[int, float] = {}
        # liveness view for the shared selection primitives: an entry is
        # consumed iff its seq left _items — no per-seq tombstone dict,
        # so bookkeeping cannot grow past the live set
        self._gone = _ConsumedView(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def clear(self) -> None:
        """Discard every queued item (a serving-run reset)."""
        self._items.clear()
        self._ready.clear()
        self._deadline.clear()
        self._arr.clear()
        self._edf.clear()

    def set_policy(self, name: str) -> None:
        self.policy = check_policy_name(name)

    def drain_all(self) -> List[object]:
        """Pop every queued item in arrival (push) order and empty the
        queue — the starved-stage release path: when no replica is left
        to serve a stage, the executor drains it and resolves the items
        upstream. Hedged duplicates of the same item come out once per
        queued occurrence; the caller's resolve-once dedup absorbs them."""
        out = [self._items[seq] for seq in sorted(self._items)]
        self.clear()
        return out

    def push(self, item, ready: float,
             deadline: float = float("inf")) -> None:
        seq = next(self._seq)
        self._items[seq] = item
        self._ready[seq] = ready
        self._deadline[seq] = deadline
        heapq.heappush(self._arr, (ready, seq))
        heapq.heappush(self._edf, (deadline, seq))

    def _prune(self, heap: List[Tuple[float, int]]) -> None:
        """Drop consumed entries off a heap's head — keeps BOTH heaps
        from accumulating tombstones of entries the other order already
        served (a fifo-only queue would otherwise never drain _edf)."""
        items = self._items
        while heap and heap[0][1] not in items:
            heapq.heappop(heap)

    def next_ready_after(self, now: float,
                         max_batch: Optional[int] = None) -> Optional[float]:
        """Earliest instant a dispatch could produce work after `now`
        (None if empty) — what a worker's timed wait should sleep until.

        With a fifo formation hold active (``timeout_s > 0``) and
        ``max_batch`` supplied, a head-of-line item inside its hold
        window reports the hold's *release* instant unless enough items
        are already ready to fill the batch — so workers sleep through
        the hold instead of busy-polling empty ``form_batch`` calls."""
        self._prune(self._arr)
        if not self._arr:
            return None
        head = self._arr[0][0]
        if (self.policy == "fifo" and self.timeout_s > 0.0
                and max_batch is not None and head <= now):
            release = head + self.timeout_s
            if release > now:
                n_ready = sum(1 for r in self._ready.values() if r <= now)
                if n_ready < max_batch:
                    return release
        return max(head, now)

    def _pop_seq(self, seq: int):
        item = self._items.pop(seq)
        self._ready.pop(seq)
        self._deadline.pop(seq)
        return item

    def form_batch(self, now: float, max_batch: int,
                   solo_latency_s: float = 0.0
                   ) -> Tuple[List[object], List[object]]:
        """(batch, shed) for a dispatch at `now` under the current policy.

        Consumes the returned items; an empty batch means nothing is
        serviceable at `now` (the caller waits for
        :meth:`next_ready_after`)."""
        take_seqs: List[int] = []
        shed_seqs: List[int] = []
        if self.policy == "edf":
            # the simulator's edf_select over the (deadline, seq) heap;
            # consumed entries are discarded lazily, not-ready ones
            # deferred
            take_seqs = edf_select(self._edf, self._ready, now, max_batch,
                                   served=self._gone)
        else:
            shed_floor = (now + solo_latency_s + self.shed_margin
                          if self.policy == "slo-drop" else None)
            popped: List[Tuple[float, int]] = []
            while self._arr and len(take_seqs) < max_batch:
                ready, seq = self._arr[0]
                if seq not in self._items:
                    heapq.heappop(self._arr)
                    continue
                if ready > now:
                    break
                heapq.heappop(self._arr)
                popped.append((ready, seq))
                if (shed_floor is not None
                        and self._deadline[seq] < shed_floor):
                    shed_seqs.append(seq)
                else:
                    take_seqs.append(seq)
            # fifo formation hold (StageConfig.timeout_s): a partial
            # batch stays queued until max_batch items are ready or the
            # hold expires `timeout_s` past the head-of-line ready
            # instant — mirrors the simulator's timeout batching
            # (repro_torch.sim.queueing.fifo); slo-drop ignores the hold there
            # and here alike
            if (self.policy == "fifo" and self.timeout_s > 0.0
                    and take_seqs and len(take_seqs) < max_batch
                    and now < popped[0][0] + self.timeout_s):
                for entry in popped:
                    heapq.heappush(self._arr, entry)
                return [], []
        out = ([self._pop_seq(s) for s in take_seqs],
               [self._pop_seq(s) for s in shed_seqs])
        self._prune(self._arr)
        self._prune(self._edf)
        return out


class _ConsumedView:
    """`served`-mapping adapter for the selection primitives: truthy for
    any seq no longer in the live item table."""

    __slots__ = ("_items",)

    def __init__(self, items: Dict[int, object]):
        self._items = items

    def __getitem__(self, seq: int) -> bool:
        return seq not in self._items
