"""Runtime-agnostic control-plane interface: a copy of the reference's
``repro.control`` (``tests/test_torch_control.py`` holds it equal).

InferLine's Tuner is a controller over an abstract serving runtime: it
consumes per-epoch telemetry (:class:`repro_torch.sim.result.EpochTelemetry`)
and emits :class:`ControlEvent` s — replica scale-ups/downs, admission
control (slo-drop shed margins), and queueing-policy switches. TWO loop
drivers speak this interface with identical semantics:

* :class:`repro_torch.sim.control.ControlLoopSession` — epoch-stepped
  co-simulation over the cone-memoized trace session;
* :class:`repro_torch.serving.loop.LiveControlLoop` — wall-clock serving on
  the thread-pool :class:`~repro_torch.serving.executor.PipelineExecutor`.

A controller written against ``step(EpochTelemetry) -> [ControlEvent]``
(the :class:`~repro_torch.core.tuner.ClosedLoopTuner`, the
:class:`~repro_torch.core.tuner.OpenLoopTunerController` adapter, or the
:class:`ScheduleController` below) therefore drives simulated queues and
real threads interchangeably — ``chip_smoke.py`` phase 4d runs the same
controller against both backends on the same trace.

This module also hosts the shared cost accounting:
:func:`replica_cost_timeline` (the $/hr step function of a run's replica
schedule) and :func:`integrate_cost` (its time integral, guarded against
degenerate empty timelines). Prices come from the port's hardware menu,
whose ``h100-1`` price is an assumption stated there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import get_hardware
from repro_torch.core.pipeline import Pipeline, PipelineConfig

# Event-stream aliases shared by both loop drivers.
ReplicaSchedules = Dict[str, List[Tuple[float, int]]]
ShedSchedules = Dict[str, List[Tuple[float, float]]]
PolicySchedules = Dict[str, List[Tuple[float, str]]]

CONTROL_EVENT_KINDS = ("up", "down", "shed", "policy")


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """One controller decision.

    ``kind``:
    * ``"up"``     — add ``int(value)`` replicas to ``stage`` (value > 0)
    * ``"down"``   — retire ``int(-value)`` replicas (value < 0); the
      runtime drains them (an in-service batch always completes)
    * ``"shed"``   — set the stage's slo-drop shed margin to ``value``
      seconds from ``t_effective`` on (see repro_torch.core.policy)
    * ``"policy"`` — switch the stage's queueing policy to ``policy``
      (fifo/edf/slo-drop) from ``t_effective`` on; ``value`` is unused
    """

    t: float                 # decision time (the epoch boundary)
    t_effective: float       # when the event lands in the runtime
    stage: str
    kind: str                # one of CONTROL_EVENT_KINDS
    value: float
    policy: Optional[str] = None   # kind == "policy" only

    def as_record(self) -> Dict[str, object]:
        rec: Dict[str, object] = {
            "t": self.t, "t_effective": self.t_effective,
            "stage": self.stage, "kind": self.kind, "value": self.value}
        if self.policy is not None:
            rec["policy"] = self.policy
        return rec


class Controller(Protocol):
    """What both loop drivers require of a controller."""

    def step(self, tele) -> List[ControlEvent]:
        """Consume one EpochTelemetry record; return the events to apply."""
        ...


class NoOpController:
    """Feedback disabled: never issues an event (the open-loop guard)."""

    def step(self, tele) -> List[ControlEvent]:
        del tele
        return []


class ScheduleController:
    """Replays a pre-planned event list through either loop driver.

    Events fire at the first epoch boundary at/after their decision time
    ``t`` (with ``t_effective`` re-clamped to stay causal), which makes
    any schedule — including mid-run fifo->edf policy switches —
    expressible as ordinary control events rather than a separate
    configuration channel. The per-epoch policy-switching follow-up from
    the co-simulation PR lands through exactly this path.
    """

    def __init__(self, events: Sequence[ControlEvent]):
        self.pending = sorted(events, key=lambda e: e.t)
        self._i = 0

    def step(self, tele) -> List[ControlEvent]:
        now = tele.t_end
        out: List[ControlEvent] = []
        while self._i < len(self.pending) and self.pending[self._i].t <= now:
            ev = self.pending[self._i]
            self._i += 1
            if ev.t_effective < now:       # keep the replay causal
                ev = dataclasses.replace(ev, t=now, t_effective=now)
            out.append(ev)
        return out


def fold_control_event(
    ev: ControlEvent,
    stages: Sequence[str],
    now: float,
    replica_schedules: ReplicaSchedules,
    shed_schedules: ShedSchedules,
    policy_schedules: PolicySchedules,
) -> None:
    """Validate one event and fold it into the per-stage schedule streams.

    Shared by the co-simulation loop and (for record-keeping) the live
    loop, so both enforce the same contract: events must target known
    stages, carry a known kind, and land causally (``t_effective`` at or
    after the deciding boundary). Each stream stays time-sorted — the
    replica pool and the piecewise schedules all assume sorted input.
    """
    if ev.stage not in stages:
        raise ValueError(f"control event for unknown stage {ev.stage!r}")
    if ev.t_effective < now - 1e-9:
        raise ValueError(f"acausal control event: decided at {now}, "
                         f"effective {ev.t_effective}")
    if ev.kind in ("up", "down"):
        sched = replica_schedules.setdefault(ev.stage, [])
        sched.append((ev.t_effective, int(ev.value)))
        # ups land at t+activation, downs at t: keep each stage's
        # stream time-sorted for the replica pool
        sched.sort(key=lambda e: e[0])
    elif ev.kind == "shed":
        sched = shed_schedules.setdefault(ev.stage, [])
        sched.append((ev.t_effective, float(ev.value)))
        sched.sort(key=lambda e: e[0])
    elif ev.kind == "policy":
        if not ev.policy:
            raise ValueError("policy control event carries no policy name")
        pol = policy_schedules.setdefault(ev.stage, [])
        pol.append((ev.t_effective, str(ev.policy)))
        pol.sort(key=lambda e: e[0])
    else:
        raise ValueError(f"unknown control event kind {ev.kind!r}")


# -- shared cost accounting -------------------------------------------------


def replica_cost_timeline(
    pipeline: Pipeline,
    config: PipelineConfig,
    schedules: Optional[Dict[str, Sequence[Tuple[float, int]]]],
    t_end: float,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, List[Tuple[float, int]]]]:
    """(times, $/hr step function, per-stage replica timeline) for a run.

    Shared by the closed-loop co-simulation and the live executor's run
    records, so every cost comparison integrates the same step function.
    """
    counts = {s: config[s].replicas for s in pipeline.stages}
    hw_cost = {
        s: get_hardware(config[s].hardware).cost_per_hr
        for s in pipeline.stages
    }
    events: List[Tuple[float, str, int]] = []
    for s, evs in (schedules or {}).items():
        for t, d in evs:
            events.append((t, s, d))
    events.sort()
    times = [0.0]
    costs = [sum(counts[s] * hw_cost[s] for s in counts)]
    timeline: Dict[str, List[Tuple[float, int]]] = {
        s: [(0.0, counts[s])] for s in counts
    }
    for t, s, d in events:
        if t > t_end:
            break
        counts[s] += d
        times.append(t)
        costs.append(sum(counts[k] * hw_cost[k] for k in counts))
        timeline[s].append((t, counts[s]))
    return np.asarray(times), np.asarray(costs), timeline


def integrate_cost(cost_times: np.ndarray, cost_per_hr: np.ndarray,
                   t_end: float) -> float:
    """$ integrated over [0, t_end] of the $/hr step function.

    A degenerate (empty) timeline integrates to 0 rather than indexing
    ``cost_per_hr[-1]`` — an empty pipeline or zero-length run is a
    valid (free) run record.
    """
    if cost_per_hr is None or len(cost_per_hr) == 0:
        return 0.0
    ts = np.append(cost_times, t_end)
    cs = np.append(cost_per_hr, cost_per_hr[-1])
    return float((cs[:-1] * np.diff(ts)).sum() / 3600.0)


def mean_cost_per_hr(cost_times: np.ndarray, cost_per_hr: np.ndarray,
                     t_end: float) -> float:
    """Run-averaged $/hr of the step function (0 for degenerate runs)."""
    return integrate_cost(cost_times, cost_per_hr, t_end) * 3600.0 \
        / max(t_end, 1e-9)


class CostAccounting:
    """Mixin for run-result records carrying a ``cost_times`` /
    ``cost_per_hr`` step function: one implementation of the
    total/mean-cost accounting for every backend's result type
    (ClosedLoopResult, LiveLoopResult), so a change to
    the cost convention cannot silently diverge between them.

    Subclasses provide :meth:`_cost_t_end_default` — the run horizon
    used when the caller passes no ``t_end`` (conventionally the last
    arrival). Deliberately carries no annotated attributes: dataclass
    subclasses must not inherit extra fields from the mixin.
    """

    def _cost_t_end_default(self) -> float:
        raise NotImplementedError

    def _t_end(self, t_end: Optional[float]) -> float:
        return t_end if t_end is not None else self._cost_t_end_default()

    def total_cost(self, t_end: Optional[float] = None) -> float:
        """$ integrated over the run (degenerate empty timelines cost 0)."""
        return integrate_cost(self.cost_times, self.cost_per_hr,
                              self._t_end(t_end))

    def mean_cost_per_hr(self, t_end: Optional[float] = None) -> float:
        return mean_cost_per_hr(self.cost_times, self.cost_per_hr,
                                self._t_end(t_end))
