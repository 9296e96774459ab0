"""Scalar fault-aware stage simulation (the engine's fault path): a copy
of the reference's ``repro.faults.simstage``.

`simulate_stage_faults` is the discrete-event counterpart of the live
executor's crash/straggle/error handling: one centralized queue, R
servers, policy-core batch formation — extended with the fault vocabulary
of :mod:`repro_torch.faults.schedule`:

* **crash** events kill a replica at ``t`` (idle victims first; a busy
  victim's in-flight batch aborts and its members requeue immediately —
  or fail permanently when recovery is disabled);
* **straggle** windows stretch the service time of every batch
  dispatched inside them;
* **error** windows fail whole batches with probability ``p`` (drawn in
  dispatch order from the stage's seeded substream, so a replay with the
  same seed is bit-identical); failed members requeue after the
  recovery policy's exponential backoff, with an optional hedged
  duplicate when the remaining deadline budget is below
  ``hedge_slack_s`` (resolve-once semantics keep delivery exactly-once).

A request whose retries exhaust resolves like a shed query (``inf``
completion, dropped mask set); requests stranded by a fully-crashed
pool keep the engine's unserved sentinel (``1e18``), matching the
reference kernels' starvation semantics. The no-fault configurations
never route here — the dispatcher (:func:`repro_torch.sim.queueing
.simulate_stage`) only calls this loop for stages with a non-empty
:class:`~repro_torch.faults.schedule.StageFaults` spec, keeping existing
outputs bit-identical.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import (
    PolicySchedule,
    ShedMarginSchedule,
    effective_max_batch,
)
from repro_torch.faults.schedule import StageFaults

_FAR_FUTURE = 1e18


class _Rep:
    """One replica: next-free instant, liveness, last dispatched batch
    (kept so a crash can abort the in-flight members). `idx` is the
    stable creation-order tie-breaker for dispatch determinism."""

    __slots__ = ("free", "alive", "batch", "idx")

    def __init__(self, idx: int, free: float = 0.0):
        self.idx = idx
        self.free = free
        self.alive = True
        self.batch: Optional[List[int]] = None


def simulate_stage_faults(
    policy: str,
    ready: np.ndarray,
    latency_lut: np.ndarray,
    max_batch: int,
    replicas: int,
    replica_events: Optional[Sequence[Tuple[float, int]]],
    timeout_s: float,
    deadline: Optional[np.ndarray],
    shed_events: Optional[Sequence[Tuple[float, float]]],
    policy_events: Optional[Sequence[Tuple[float, str]]],
    spec: StageFaults,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One faulty stage over a sorted `ready` stream.

    Returns (completion times aligned with `ready`, per-batch sizes —
    failed batches included, matching the live executor's batch log —
    and the dropped mask: shed queries plus retry-exhausted failures).
    """
    ready = np.asarray(ready, dtype=np.float64)
    k = int(ready.shape[0])
    done = np.full(k, _FAR_FUTURE, dtype=np.float64)
    dropped = np.zeros(k, dtype=bool)
    batches: List[int] = []
    if k == 0:
        return done, np.asarray(batches, dtype=np.int64), dropped

    lut_l: List[float] = np.asarray(latency_lut, dtype=np.float64).tolist()
    eff_batch = effective_max_batch(latency_lut, max_batch)
    solo_lat = lut_l[1]
    pol = PolicySchedule(policy, policy_events)
    shed = ShedMarginSchedule(shed_events)
    rec = spec.recovery
    rng = spec.rng()
    have_ddl = deadline is not None
    ddl_l: List[float] = (np.asarray(deadline, dtype=np.float64).tolist()
                          if have_ddl else ready.tolist())

    # queue entries: (ready_t, seq, idx, attempt). An entry is stale —
    # a served item, a superseded attempt, or a hedged twin's leftover —
    # iff resolved[idx] or attempt != attempts[idx].
    q: List[Tuple[float, int, int, int]] = []
    seq = 0
    attempts = [1] * k
    resolved = [False] * k
    for i in range(k):
        heapq.heappush(q, (float(ready[i]), seq, i, 1))
        seq += 1
    remaining = k

    reps: List[_Rep] = [_Rep(i) for i in range(max(int(replicas), 0))]
    adds: List[Tuple[float, int]] = []
    removals: List[float] = []
    for t, d in (replica_events or ()):
        if d > 0:
            adds.append((float(t), int(d)))
        else:
            removals.extend([float(t)] * (-int(d)))
    adds.sort()
    removals.sort()
    ai = 0
    crash_ts: List[float] = []
    for t, n in spec.crashes():
        crash_ts.extend([float(t)] * n)
    crash_ts.sort()
    ci = 0

    def _retry(i: int, t_base: float, with_backoff: bool) -> int:
        """Requeue item `i` after a failure observed at `t_base`.
        Returns the change in `remaining` (-1 when retries exhaust)."""
        nonlocal seq
        attempts[i] += 1
        if (not rec.enabled) or attempts[i] > int(rec.max_attempts):
            done[i] = np.inf
            dropped[i] = True
            resolved[i] = True
            return -1
        t_ready = t_base + (rec.backoff(attempts[i] - 1)
                            if with_backoff else 0.0)
        heapq.heappush(q, (t_ready, seq, i, attempts[i]))
        seq += 1
        if (rec.hedge_slack_s > 0.0 and have_ddl
                and ddl_l[i] - t_ready < rec.hedge_slack_s):
            # hedged duplicate: same attempt number, resolve-once dedup
            heapq.heappush(q, (t_ready, seq, i, attempts[i]))
            seq += 1
        return 0

    def _apply_crash(tc: float) -> int:
        """Kill one replica at `tc`; abort+requeue its in-flight batch.
        Returns the change in `remaining`."""
        victim: Optional[_Rep] = None
        for r in reps:                      # idle victims first
            if r.alive and r.free <= tc:
                victim = r
                break
        if victim is None:
            for r in reps:
                if r.alive:
                    victim = r
                    break
        if victim is None:
            return 0
        victim.alive = False
        delta = 0
        if victim.batch is not None and victim.free > tc:
            # in-flight batch dies with the replica: members un-resolve
            # and requeue at the crash instant (no backoff — the work
            # never failed, the server did)
            for i in victim.batch:
                resolved[i] = False
                done[i] = _FAR_FUTURE
                delta += 1
                delta += _retry(i, tc, with_backoff=False)
        victim.batch = None
        return delta

    # iteration guard: each loop either resolves work, processes one
    # event batch, or advances a formation hold — all finite
    max_iters = 64 * (k * int(rec.max_attempts) + len(adds)
                      + len(removals) + len(crash_ts) + 8)
    iters = 0
    start_floor = 0.0

    while remaining > 0:
        iters += 1
        if iters > max_iters:
            raise RuntimeError(
                f"simulate_stage_faults failed to converge on stage "
                f"{spec.stage!r} ({remaining} unresolved after "
                f"{max_iters} iterations)")
        # drop stale heap heads
        while q and (resolved[q[0][2]] or q[0][3] != attempts[q[0][2]]):
            heapq.heappop(q)
        if not q:
            break                           # every live item is resolved
        alive = [r for r in reps if r.alive]
        if not alive:
            if ai < len(adds):
                # fast-forward to the next scale-up
                t_add, n_add = adds[ai]
                ai += 1
                for _ in range(n_add):
                    reps.append(_Rep(len(reps), t_add))
                continue
            break                # starved: leftovers keep _FAR_FUTURE
        f = min(r.free for r in alive)
        head_ready = q[0][0]
        start = max(f, head_ready, start_floor)
        # land control adds / crashes at or before this dispatch instant
        t_ev = math.inf
        if ai < len(adds):
            t_ev = min(t_ev, adds[ai][0])
        if ci < len(crash_ts):
            t_ev = min(t_ev, crash_ts[ci])
        if t_ev <= start:
            while ai < len(adds) and adds[ai][0] <= t_ev:
                t_add, n_add = adds[ai]
                ai += 1
                for _ in range(n_add):
                    reps.append(_Rep(len(reps), t_add))
            while ci < len(crash_ts) and crash_ts[ci] <= t_ev:
                remaining += _apply_crash(crash_ts[ci])
                ci += 1
            continue                        # recompute with the new pool
        # drain-retire: the replica about to dispatch absorbs a pending
        # removal instead (ReplicaPool.retire_if_pending semantics)
        chosen = min(alive, key=lambda r: (r.free, r.idx))
        if removals and removals[0] <= start:
            removals.pop(0)
            chosen.alive = False
            continue

        p = pol.policy_at(start)
        if p == "slo-drop" and not have_ddl:
            p = "fifo"
        # batch formation over the heap (policy-core semantics)
        take: List[int] = []
        popped: List[Tuple[float, int, int, int]] = []
        while q and len(take) < eff_batch:
            entry = q[0]
            t_r, _, i, att = entry
            if resolved[i] or att != attempts[i]:
                heapq.heappop(q)
                continue
            if t_r > start:
                break
            heapq.heappop(q)
            popped.append(entry)
            if i in take:
                continue                    # hedged twin of a taken item
            if p == "slo-drop":
                floor = start + solo_lat + shed.margin(start)
                if ddl_l[i] < floor:
                    done[i] = np.inf
                    dropped[i] = True
                    resolved[i] = True
                    remaining -= 1
                    continue
            take.append(i)
        if p == "edf" and take:
            # deadline order among the ready set; overflow re-queues
            take.sort(key=lambda i: (ddl_l[i], i))
            for i in take[eff_batch:]:
                heapq.heappush(q, (start, seq, i, attempts[i]))
                seq += 1
            take = take[:eff_batch]
        if not take:
            start_floor = 0.0
            continue                        # everything scanned was shed
        if (p == "fifo" and timeout_s > 0.0 and len(take) < eff_batch):
            # fifo formation hold: wait for the batch to fill or for
            # `timeout_s` past the head-of-line ready instant
            head = min(popped[0][0], *(float(ready[i]) for i in take))
            hold_until = head + timeout_s
            if hold_until > start:
                need = eff_batch - len(take)
                future = sorted(
                    t_r for t_r, _, i, att in q
                    if not resolved[i] and att == attempts[i]
                    and i not in take)
                fill_t = future[need - 1] if len(future) >= need else math.inf
                t_hold = min(hold_until, fill_t)
                if t_hold > start:
                    for entry in popped:
                        heapq.heappush(q, entry)
                    start_floor = t_hold
                    continue
        start_floor = 0.0

        b = len(take)
        lat = lut_l[b] * max(1.0, spec.slowdown_at(start))
        end = start + lat
        batches.append(b)
        chosen.free = end
        p_err = spec.error_p(start)
        failed = p_err > 0.0 and bool(rng.random() < p_err)
        if failed:
            # the whole batch fails at completion: the replica burned
            # the service time, the members retry after backoff
            chosen.batch = None
            for i in take:
                remaining += _retry(i, end, with_backoff=True)
        else:
            chosen.batch = list(take)
            for i in take:
                done[i] = end
                resolved[i] = True
            remaining -= b

    return done, np.asarray(batches, dtype=np.int64), dropped
