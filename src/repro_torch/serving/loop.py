"""Closed-loop control of the REAL executor (wall-clock epoch stepping):
a copy of the reference's ``repro.serving.loop``.

:class:`LiveControlLoop` is the runtime twin of
:class:`repro_torch.sim.control.ControlLoopSession`: it serves a trace on a
:class:`~repro_torch.serving.executor.PipelineExecutor` while sampling
:class:`~repro_torch.sim.result.EpochTelemetry` at fixed control epochs and
feeding it to the SAME controller interface
(``step(EpochTelemetry) -> [ControlEvent]``) the co-simulation drives —
the :class:`~repro_torch.core.tuner.ClosedLoopTuner`, the
:class:`~repro_torch.core.tuner.OpenLoopTunerController` adapter, and
:class:`~repro_torch.control.ScheduleController` all run unchanged against
real threads.

Telemetry is assembled with the simulator's exact window semantics
(per-stage arrived/completed/dropped deltas over ``(t0, t1]``, live
queue depth and in-service counts, pipeline-level completed/missed/
overdue/drops/p99 over the window, the streaming ingress envelope), and
each stage's ``replicas`` field is derived from the folded replica
schedule exactly as the engine derives it — so a controller cannot tell
which backend it is scaling except through the numbers themselves.
``chip_smoke.py`` phase 4d prints the live run beside the co-simulated
twin on the same trace.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import (
    ControlEvent,
    CostAccounting,
    fold_control_event,
    replica_cost_timeline,
)
from repro_torch.core.envelope import IncrementalEnvelope
from repro_torch.serving.executor import PipelineExecutor, _Request
from repro_torch.sim.result import EpochTelemetry, StageTelemetry

DEFAULT_EPOCH_S = 1.0


@dataclasses.dataclass
class LiveLoopResult(CostAccounting):
    """Outcome of one wall-clock closed-loop run — shaped like
    :class:`repro_torch.sim.control.ClosedLoopResult` so benchmark and test
    code can compare the two backends field-for-field."""

    arrival: np.ndarray            # actual injection times (loop clock)
    latency: np.ndarray            # measured end-to-end (inf: shed/released)
    dropped: np.ndarray            # shed by an slo-drop stage
    released: int                  # unfinished at drain timeout, cancelled
    slo: float
    telemetry: List[EpochTelemetry]
    events: List[ControlEvent]
    replica_schedules: Dict[str, List[Tuple[float, int]]]
    shed_schedules: Dict[str, List[Tuple[float, float]]]
    policy_schedules: Dict[str, List[Tuple[float, str]]]
    cost_times: np.ndarray
    cost_per_hr: np.ndarray
    replica_timeline: Dict[str, List[Tuple[float, int]]]
    batch_sizes: Dict[str, np.ndarray]

    @property
    def miss_rate(self) -> float:
        if not self.latency.size:
            return 0.0
        miss = (self.latency > self.slo) | self.dropped
        return float(miss.mean())

    @property
    def attainment(self) -> float:
        return 1.0 - self.miss_rate

    def _cost_t_end_default(self) -> float:
        return float(self.arrival.max()) if self.arrival.size else 0.0

    def batch_stats(self) -> Dict[str, float]:
        return {s: (float(b.mean()) if b.size else 0.0)
                for s, b in self.batch_sizes.items()}


class LiveControlLoop:
    """Wall-clock epoch stepping of one executor + one controller.

    ``run(arrivals, controller, payload_fn)`` injects the trace in real
    time from a background thread while the main thread samples
    telemetry at every epoch boundary, invokes the controller, and lands
    its events on the executor (scale-ups activate at ``t_effective``,
    scale-downs drain, shed-margin and policy switches reprogram the
    live queues). Events are simultaneously folded into per-stage
    schedule streams with the shared :func:`repro_torch.control
    .fold_control_event`, so the run record (cost timeline, replica
    timeline) is computed by the same code path as the simulated loops.
    """

    def __init__(self, executor: PipelineExecutor, slo: float,
                 epoch_s: float = DEFAULT_EPOCH_S,
                 service_time_s: float = 0.05,
                 envelope_max_window_s: float = 60.0,
                 drain_timeout_s: float = 30.0):
        if epoch_s <= 0:
            raise ValueError(f"epoch_s must be positive, got {epoch_s}")
        self.executor = executor
        self.pipeline = executor.pipeline
        self.config = executor.config
        self.slo = float(slo)
        self.epoch_s = float(epoch_s)
        self.service_time_s = float(service_time_s)
        self.envelope_max_window_s = float(envelope_max_window_s)
        self.drain_timeout_s = float(drain_timeout_s)

    # -- trace injection ---------------------------------------------------
    def _inject_all(self, arrivals: np.ndarray, payload_fn,
                    reqs: List[_Request], stop: threading.Event) -> None:
        ex = self.executor
        n = int(arrivals.size)
        # payloads are pre-built so payload_fn cost never eats into the
        # inter-arrival gaps at high rate
        payloads = [payload_fn(i) for i in range(n)]
        lags: List[float] = []
        for i in range(n):
            t_arr = float(arrivals[i])
            # absolute-deadline wait on the stop event: a stop (run cut
            # short by t_end) is honored IMMEDIATELY even mid-gap — no
            # sleep slicing — and never injects the arrival the
            # interrupted wait was waiting on; a late injection catches
            # up on the next arrival instead of compounding drift
            while True:
                dt = t_arr - ex.now()
                if dt <= 0.0:
                    break
                if stop.wait(dt):
                    ex._note_injection_lags(np.asarray(lags))
                    return
            if stop.is_set():
                break
            # nominal-arrival stamp: latency and the SLO deadline are
            # charged against the intended schedule, not the drifted
            # injection instant
            req = _Request(i, t_arr, payloads[i], t_arr + self.slo)
            reqs.append(req)
            ex.inject(req)
            lags.append(ex.now() - t_arr)
        ex._note_injection_lags(np.asarray(lags))

    # -- one epoch's telemetry --------------------------------------------
    def _telemetry(self, epoch: int, t0: float, t1: float,
                   reqs: List[_Request], prev: Dict[str, Dict[str, float]],
                   base_replicas: Dict[str, int],
                   sched: Dict[str, List[Tuple[float, int]]],
                   env: IncrementalEnvelope) -> EpochTelemetry:
        ex = self.executor
        # the first epoch's window is closed at both ends, matching the
        # co-simulation loop's partition of the run
        t_lo = -np.inf if epoch == 1 else t0
        counters = ex.telemetry_counters()
        fdel = ex.fault_deltas()
        stages: Dict[str, StageTelemetry] = {}
        for s, cur in counters.items():
            p = prev.get(s, {})
            # replicas exactly as the engine computes them: the fleet
            # the executor actually carried at run start (it may have
            # been scaled since deployment) plus the folded schedule's
            # deltas landed by t1
            replicas = base_replicas[s] + sum(
                d for (t, d) in sched.get(s, ()) if t <= t1)
            # alive = target minus injected-crash losses landed by t1 —
            # the capacity-loss signal failure-aware controllers react
            # to; floored at 0 (negative would read as "untracked")
            alive = max(0, replicas + sum(
                d for (t, d) in fdel.get(s, ()) if t <= t1))
            stages[s] = StageTelemetry(
                stage=s,
                arrived=int(cur["arrived"] - p.get("arrived", 0)),
                completed=int(cur["completed"] - p.get("completed", 0)),
                dropped=int(cur["dropped"] - p.get("dropped", 0)),
                queue_depth=int(cur["queue_depth"]),
                in_flight=int(cur["in_flight"]),
                replicas=replicas, alive=alive)
        prev.clear()
        prev.update(counters)

        # pipeline-level windowed accounting (the sim loop's semantics)
        snap = list(reqs)
        arr = np.asarray([r.t_arrival for r in snap])
        hi = int(np.searchsorted(arr, t1, side="right"))
        lo = 0 if epoch == 1 else int(np.searchsorted(arr, t0,
                                                      side="right"))
        prefix = arr[:hi]
        env.extend(arr[env.n:hi])
        completed = missed = overdue = drops = 0
        lats: List[float] = []
        for r in snap:
            finished = r.done.is_set() and not (r.shed or r.cancelled)
            comp = r.t_done if (finished and r.t_done is not None) \
                else np.inf
            ddl_in_win = t_lo < r.deadline <= t1
            if np.isfinite(comp) and t_lo < comp <= t1:
                completed += 1
                lat = comp - r.t_arrival
                lats.append(lat)
                if ddl_in_win and lat > self.slo:
                    missed += 1
            if ddl_in_win and (not np.isfinite(comp) or comp > t1):
                overdue += 1
            if r.shed and ddl_in_win:
                drops += 1
        p99 = float(np.percentile(np.asarray(lats), 99.0)) if lats \
            else float("nan")
        return EpochTelemetry(
            epoch=epoch, t_start=t0, t_end=t1, ingress=hi - lo,
            ingress_prefix=prefix, observed_envelope=env.snapshot(),
            stages=stages, completed=completed, missed=missed,
            overdue=overdue, drops=drops, p99_s=p99)

    # -- the loop ----------------------------------------------------------
    def run(self, arrivals: np.ndarray, controller, payload_fn,
            t_end: Optional[float] = None) -> LiveLoopResult:
        arr_nominal = np.asarray(arrivals, dtype=np.float64)
        if arr_nominal.size > 1 and np.any(np.diff(arr_nominal) < 0):
            raise ValueError("arrivals must be sorted ascending")
        t_stop = t_end if t_end is not None else (
            float(arr_nominal.max()) if arr_nominal.size else 0.0)
        ex = self.executor
        ex.start_run()
        # the run's replica baseline is the fleet the executor actually
        # carries NOW (it may have been scaled since deployment) — the
        # cost/replica timelines and telemetry all start from it
        base_replicas = {s: ex.replica_target(s)
                         for s in self.pipeline.stages}
        run_config = self.config.copy()
        for s, k in base_replicas.items():
            run_config[s].replicas = k
        reqs: List[_Request] = []
        stop = threading.Event()
        injector = threading.Thread(
            target=self._inject_all, args=(arr_nominal, payload_fn, reqs,
                                           stop),
            daemon=True)
        sched: Dict[str, List[Tuple[float, int]]] = {
            s: [] for s in self.pipeline.stages}
        shed: Dict[str, List[Tuple[float, float]]] = {}
        pols: Dict[str, List[Tuple[float, str]]] = {}
        telemetry: List[EpochTelemetry] = []
        events: List[ControlEvent] = []
        deferred: List[ControlEvent] = []
        prev_counters: Dict[str, Dict[str, float]] = {}
        env = IncrementalEnvelope(self.service_time_s,
                                  self.envelope_max_window_s)
        # precise interruptible timer for the epoch loop: one wakeup per
        # deadline (epoch boundary or earliest deferred event) instead of
        # 20 Hz sleep slices, and a real worker crash sets it so the run
        # fails immediately rather than at the next boundary
        wake = threading.Event()
        ex.on_worker_failure = wake.set
        injector.start()
        try:
            epoch = 0
            t0 = 0.0
            t = self.epoch_s
            while t <= t_stop + 1e-9:
                # event-timed ticks land deferred events (future-dated
                # downs/sheds/policy switches) at their t_effective;
                # scale-up activation is handled inside the executor
                while True:
                    now = ex.now()
                    deferred = [ev for ev in deferred
                                if not self._apply_if_due(ev, now)]
                    if now >= t:
                        break
                    self._check_worker_failures()
                    nxt = min([t] + [ev.t_effective for ev in deferred])
                    # epsilon past the deadline so the due-checks above
                    # see it due on the next pass
                    wake.wait(max(nxt - now, 0.0) + 1e-4)
                    wake.clear()
                epoch += 1
                # surface real worker crashes within one epoch — a dead
                # fleet must fail the run now, not at drain time
                self._check_worker_failures()
                tele = self._telemetry(epoch, t0, t, reqs, prev_counters,
                                       base_replicas, sched, env)
                telemetry.append(tele)
                for ev in controller.step(tele) or ():
                    # identical contract to the co-simulation loop
                    fold_control_event(ev, self.pipeline.stages, t, sched,
                                       shed, pols)
                    events.append(ev)
                    if not self._apply_if_due(ev, ex.now()):
                        deferred.append(ev)
                t0 = t
                t += self.epoch_s
        finally:
            stop.set()
            ex.on_worker_failure = None
        injector.join()
        for ev in deferred:                    # land stragglers
            self.executor.apply_control_event(ev)

        # drain: wait for the tail (requests stranded on a starved /
        # all-dead stage release promptly), then cancel anything stuck
        starved = ex.await_all(reqs, self.drain_timeout_s)
        released = ex.release(reqs) + starved
        self._check_worker_failures()

        lat = np.array([
            np.inf if (r.t_done is None or r.shed or r.cancelled)
            else r.t_done - r.t_arrival
            for r in reqs])
        dropped = np.array([r.shed for r in reqs], dtype=bool)
        times, costs, timeline = replica_cost_timeline(
            self.pipeline, run_config, sched, t_stop)
        return LiveLoopResult(
            arrival=np.asarray([r.t_arrival for r in reqs]),
            latency=lat, dropped=dropped, released=released, slo=self.slo,
            telemetry=telemetry, events=events,
            replica_schedules=sched, shed_schedules=shed,
            policy_schedules=pols, cost_times=times, cost_per_hr=costs,
            replica_timeline=timeline, batch_sizes=ex.batch_sizes())

    def _check_worker_failures(self) -> None:
        """Raise if any worker thread crashed (uncaught exception — an
        injected fault never registers here). Checked at every epoch-
        loop wakeup — a crash sets the wake event, so the run fails
        immediately — and again after drain."""
        self.executor.check_worker_failures("the closed-loop run")

    def _apply_if_due(self, ev: ControlEvent, now: float) -> bool:
        """Scale-ups apply immediately (the executor defers activation to
        ``t_effective`` itself); everything else waits until due."""
        if ev.kind != "up" and ev.t_effective > now + 1e-6:
            return False
        self.executor.apply_control_event(ev)
        return True
