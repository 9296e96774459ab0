"""Closed-loop Tuner x SimEngine co-simulation (epoch stepping): a copy
of the reference's ``repro.sim.control``, held bit-equal to it by
``tests/test_torch_control.py`` (with fault schedules by
``tests/test_torch_faults.py``).

The paper's high-frequency Tuner (§5) is a pure function of ingress, so
the live-cluster path (:class:`repro_torch.serving.cluster.LiveClusterSim`)
could precompute its whole scaling schedule before simulating
(``run_tuner_offline``). This module closes the loop instead:
the engine advances in fixed control epochs (default 1 s), samples
per-stage telemetry at each boundary (:class:`repro_torch.sim.result.
EpochTelemetry` — queue depth, in-flight, windowed p99/miss/drop counts,
the observed ingress envelope), and a controller turns each record into
:class:`ControlEvent` s — replica scale-ups/downs and admission-control
(slo-drop shed-margin) changes — that land after an activation delay.

Epoch stepping rides the cone-memoized :class:`~repro_torch.sim.engine.
TraceSession` rather than re-running a one-shot simulation per epoch:
each boundary replays the bound trace against the schedule accumulated
so far, which is a pure per-stage cache hit in every epoch where no new
event was issued and re-simulates only the touched stage's downstream
cone otherwise. Reading the boundary's telemetry off a full-trace replay
is *causal*: a control event decided now lands strictly later, and a
batch whose start time is at or before the boundary can never be altered
by pool/shed events after it — so the telemetry a controller saw mid-run
is bit-identical to what the final schedule's one-shot simulation shows,
and a run with no controller events IS the one-shot simulation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import (  # noqa: F401 — re-exported for compatibility
    ControlEvent,
    Controller,
    CostAccounting,
    NoOpController,
    ScheduleController,
    fold_control_event,
    integrate_cost,
    replica_cost_timeline,
)
from repro_torch.core.envelope import IncrementalEnvelope
from repro_torch.core.pipeline import Pipeline, PipelineConfig
from repro_torch.core.profiler import ProfileStore
from repro_torch.sim.engine import (
    DEFAULT_RPC_DELAY_S,
    SimEngine,
)
from repro_torch.sim.result import EpochTelemetry, SimResult, StageTelemetry

# Activation delays are the CONTROLLER's concern: a controller stamps
# each event's t_effective itself (e.g. the Tuner's REPLICA_ACTIVATION_S
# for scale-ups); the loop driver only refuses acausal ones.
DEFAULT_EPOCH_S = 1.0


@dataclasses.dataclass
class ClosedLoopResult(CostAccounting):
    """Outcome of one closed-loop run: the per-query simulation under the
    controller's final schedule, plus the control-plane artifacts."""

    sim: SimResult
    slo: float
    telemetry: List[EpochTelemetry]
    events: List[ControlEvent]
    replica_schedules: Dict[str, List[Tuple[float, int]]]
    shed_schedules: Dict[str, List[Tuple[float, float]]]
    cost_times: np.ndarray
    cost_per_hr: np.ndarray
    replica_timeline: Dict[str, List[Tuple[float, int]]]
    policy_schedules: Dict[str, List[Tuple[float, str]]] = \
        dataclasses.field(default_factory=dict)

    @property
    def miss_rate(self) -> float:
        return self.sim.slo_miss_rate(self.slo)

    @property
    def attainment(self) -> float:
        return 1.0 - self.miss_rate

    def _cost_t_end_default(self) -> float:
        return float(self.sim.arrival.max()) if self.sim.arrival.size else 0.0


class ControlLoopSession:
    """Epoch-stepped co-simulation of one pipeline + one controller.

    ``run(arrivals, controller)`` advances the engine one control epoch
    at a time; the controller's ``step(EpochTelemetry) -> [ControlEvent]``
    is invoked at every boundary and its events are folded into the
    replica/shed schedules the remaining epochs (and the final result)
    simulate under.
    """

    def __init__(
        self,
        pipeline: Pipeline,
        profiles: ProfileStore,
        config: PipelineConfig,
        slo: float,
        epoch_s: float = DEFAULT_EPOCH_S,
        rpc_delay_s: float = DEFAULT_RPC_DELAY_S,
        seed: int = 0,
        engine: Optional[SimEngine] = None,
        envelope_max_window_s: float = 60.0,
    ):
        if epoch_s <= 0:
            raise ValueError(f"epoch_s must be positive, got {epoch_s}")
        self.pipeline = pipeline
        self.profiles = profiles
        self.config = config
        self.slo = slo
        self.epoch_s = float(epoch_s)
        self.engine = engine if engine is not None else SimEngine(
            pipeline, profiles, rpc_delay_s=rpc_delay_s, seed=seed)
        self.envelope_max_window_s = envelope_max_window_s
        # per-stage single-batch service latency: the in-flight bound
        self._batch_lat = {}
        for s in pipeline.stages:
            cfg = config[s]
            lut = self.engine.latency_lut(s, cfg.hardware, cfg.batch_size)
            self._batch_lat[s] = float(lut[min(cfg.batch_size,
                                               lut.shape[0] - 1)])

    # -- one epoch's telemetry --------------------------------------------
    def _telemetry(
        self,
        epoch: int,
        t0: float,
        t1: float,
        arr: np.ndarray,
        res: SimResult,
        states,
        sched: Dict[str, List[Tuple[float, int]]],
        env: IncrementalEnvelope,
        faults=None,
    ) -> EpochTelemetry:
        # the first epoch's window is closed at BOTH ends ([0, t1], not
        # (0, t1]) so an arrival at exactly t=0 is counted somewhere —
        # the per-epoch records must partition the run exactly
        t_lo = -np.inf if epoch == 1 else t0
        hi = int(np.searchsorted(arr, t1, side="right"))
        lo = 0 if epoch == 1 else int(np.searchsorted(arr, t0,
                                                      side="right"))
        prefix = arr[:hi]
        env.extend(arr[env.n:hi])
        deadline = arr + self.slo

        stages: Dict[str, StageTelemetry] = {}
        for s in self.engine._topo:
            st = states[s]
            vis = st.visited
            comp = st.completion
            fin = np.isfinite(comp) & vis
            arrived = int((vis & (st.ready > t_lo) & (st.ready <= t1)).sum())
            completed = int((fin & (comp > t_lo) & (comp <= t1)).sum())
            if st.dropped is not None:
                dmask = st.dropped
                dropped = int((dmask & (deadline > t_lo)
                               & (deadline <= t1)).sum())
            else:
                dmask = None
                dropped = 0
            # queued or in service: input ready, outcome still pending.
            # A shed query's shed instant isn't tracked per query; treat
            # it as queued until its deadline (slo-drop sheds at dequeue,
            # which its deadline bounds).
            backlog = vis & (st.ready <= t1) & (comp > t1)
            if dmask is not None:
                backlog &= ~(dmask & (deadline <= t1))
            in_flight = int((backlog & (comp <= t1 + self._batch_lat[s]))
                            .sum())
            replicas = self.config[s].replicas + sum(
                d for (t, d) in sched.get(s, ()) if t <= t1)
            # alive mirrors the live loop's fault_deltas accounting:
            # replica target minus crash losses observed by t1, floored
            # at 0 — a schedule can ask for more kills than exist, and
            # a negative value would read as the "untracked" sentinel
            sf = faults.stage(s) if faults else None
            alive = max(0, replicas - (sum(n for (t, n) in sf.crashes()
                                           if t <= t1) if sf else 0))
            stages[s] = StageTelemetry(
                stage=s, arrived=arrived, completed=completed,
                dropped=dropped, queue_depth=int(backlog.sum()),
                in_flight=in_flight, replicas=replicas, alive=alive)

        # pipeline-level windowed accounting (causal: completions and
        # deadline passages inside this window only — each missing query
        # is counted in exactly one epoch, the one its deadline ends in)
        comp_t = arr + res.latency       # +inf for shed queries
        fin = np.isfinite(comp_t)
        in_win = fin & (comp_t > t_lo) & (comp_t <= t1)
        completed = int(in_win.sum())
        ddl_in_win = (deadline > t_lo) & (deadline <= t1)
        missed = int((in_win & ddl_in_win & (res.latency > self.slo)).sum())
        overdue = int((ddl_in_win & ((~fin) | (comp_t > t1))).sum())
        if res.dropped is not None:
            drops = int((res.dropped & ddl_in_win).sum())
        else:
            drops = 0
        p99 = (float(np.percentile(res.latency[in_win], 99.0))
               if completed else float("nan"))
        return EpochTelemetry(
            epoch=epoch, t_start=t0, t_end=t1, ingress=hi - lo,
            ingress_prefix=prefix, observed_envelope=env.snapshot(),
            stages=stages, completed=completed, missed=missed,
            overdue=overdue, drops=drops, p99_s=p99)

    # -- the loop ----------------------------------------------------------
    def run(self, arrivals: np.ndarray, controller,
            t_end: Optional[float] = None,
            faults=None) -> ClosedLoopResult:
        arr = np.asarray(arrivals, dtype=np.float64)
        if arr.size > 1 and np.any(np.diff(arr) < 0):
            # the engine tolerates unsorted traces (it sorts per stage)
            # but every telemetry window here is a searchsorted slice
            raise ValueError("arrivals must be sorted ascending")
        t_stop = t_end if t_end is not None else (
            float(arr.max()) if arr.size else 0.0)
        session = self.engine.session(arr, slo_s=self.slo)
        sched: Dict[str, List[Tuple[float, int]]] = {
            s: [] for s in self.pipeline.stages}
        shed: Dict[str, List[Tuple[float, float]]] = {}
        pols: Dict[str, List[Tuple[float, str]]] = {}
        telemetry: List[EpochTelemetry] = []
        events: List[ControlEvent] = []
        env = IncrementalEnvelope(
            self.engine.service_time(self.config),
            self.envelope_max_window_s)

        epoch = 0
        t0 = 0.0
        t = self.epoch_s
        while t <= t_stop + 1e-9:
            epoch += 1
            res = session.simulate(self.config, sched, shed or None,
                                   pols or None, faults)
            states = session.stage_states(self.config, sched, shed or None,
                                          pols or None, faults)
            tele = self._telemetry(epoch, t0, t, arr, res, states, sched,
                                   env, faults)
            telemetry.append(tele)
            for ev in controller.step(tele) or ():
                # shared validation + schedule folding (repro_torch.control):
                # the live loop driver enforces the identical contract
                fold_control_event(ev, self.pipeline.stages, t, sched,
                                   shed, pols)
                events.append(ev)
            t0 = t
            t += self.epoch_s

        res = session.simulate(self.config, sched, shed or None, pols or None,
                               faults)
        times, costs, timeline = replica_cost_timeline(
            self.pipeline, self.config, sched, t_stop)
        return ClosedLoopResult(
            sim=res, slo=self.slo, telemetry=telemetry, events=events,
            replica_schedules=sched, shed_schedules=shed,
            cost_times=times, cost_per_hr=costs,
            replica_timeline=timeline, policy_schedules=pols)
