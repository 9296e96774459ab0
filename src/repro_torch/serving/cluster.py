"""Live-cluster simulation: serve a trace with a high-frequency tuner in
the loop (§5, §7.1-7.3). A copy of the reference's
``repro.serving.cluster``, numpy over the port's engine.

The Tuner's decisions are a pure function of the ingress arrival process
(traffic envelopes + plan-time constants), so the full scaling schedule is
computed by streaming the trace through the tuner first; the resulting
per-stage replica schedules are then handed to the unified simulation
engine (:mod:`repro_torch.sim` — the same core behind the Estimator and the
Planner search), which simulates every queue/batch/replica interaction.
Replica activation delay (5 s) and scale-down draining are modeled inside
the engine, and per-stage queueing policies (EDF, SLO-aware shedding)
apply to live runs exactly as they do to planning simulations.

Outputs include the per-query latencies AND the cost timeline (replica
counts integrate to $-cost over the run), which is what Figs. 6/7/10-12
plot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.control import CostAccounting, replica_cost_timeline
from repro_torch.core.pipeline import Pipeline, PipelineConfig
from repro_torch.core.profiler import ProfileStore
from repro_torch.serving.frontends import FRONTENDS, Frontend
from repro_torch.sim import SimEngine, SimResult


@dataclasses.dataclass
class LiveRunResult(CostAccounting):
    sim: SimResult
    slo: float
    # cost timeline: (times, $/hr at that time); integrate for total $
    # (total_cost/mean_cost_per_hr come from the shared CostAccounting
    # mixin; degenerate empty timelines cost 0).
    cost_times: np.ndarray
    cost_per_hr: np.ndarray
    replica_timeline: Dict[str, List[Tuple[float, int]]]

    @property
    def miss_rate(self) -> float:
        return self.sim.slo_miss_rate(self.slo)

    @property
    def attainment(self) -> float:
        return 1.0 - self.miss_rate

    def _cost_t_end_default(self) -> float:
        return float(self.sim.arrival.max()) if self.sim.arrival.size else 0.0


class LiveClusterSim:
    """Simulate live serving of `arrivals` under a scaling controller."""

    def __init__(self, pipeline: Pipeline, profiles: ProfileStore,
                 config: PipelineConfig, slo: float,
                 frontend: Frontend = FRONTENDS["clipper"]):
        self.pipeline = pipeline
        self.profiles = profiles
        self.config = config
        self.slo = slo
        self.frontend = frontend
        self.engine = SimEngine(pipeline, profiles,
                                rpc_delay_s=frontend.hop_delay_s)

    def _cost_timeline(
        self,
        schedules: Dict[str, Sequence[Tuple[float, int]]],
        t_end: float,
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, List[Tuple[float, int]]]]:
        # shared with the closed-loop runner so open- and closed-loop
        # cost comparisons integrate the same step function
        return replica_cost_timeline(self.pipeline, self.config,
                                     schedules, t_end)

    def run(
        self,
        arrivals: np.ndarray,
        schedule_fn: Optional[Callable[[np.ndarray], Dict[str, List[Tuple[float, int]]]]] = None,
    ) -> LiveRunResult:
        """Serve the trace; `schedule_fn(arrivals)` produces the scaling
        schedule (e.g. `run_tuner_offline` partial). None = static config."""
        arrivals = np.asarray(arrivals, dtype=np.float64)
        schedules = schedule_fn(arrivals) if schedule_fn is not None else {}
        # slo_s feeds per-query deadlines to deadline-aware stage policies
        # (edf / slo-drop); the paper's fifo stages ignore it.
        sim = self.engine.simulate(self.config, arrivals,
                                   replica_schedules=schedules or None,
                                   slo_s=self.slo)
        t_end = float(arrivals.max()) if arrivals.size else 0.0
        times, costs, timeline = self._cost_timeline(schedules, t_end)
        return LiveRunResult(sim, self.slo, times, costs, timeline)
