"""Coarse-grained baseline (§6): pipeline-as-a-black-box provisioning.

A copy of the reference's ``repro.baselines.coarse_grained``, numpy over
the port's engine: its plans, costs and schedules are the reference's,
equal with ``==``.

State-of-practice without InferLine: every component is deployed behind a
generic serving system and the *whole pipeline* is tuned as one unit.

Planning: profile the pipeline end-to-end to find the single maximum batch
size whose service time meets the SLO; replicate the entire pipeline as a
unit to reach the required throughput, which is either the trace mean
(CG-Mean) or the trace peak over SLO-sized sliding windows (CG-Peak).

Tuning: the AutoScale [12] reactive mechanism — scale the number of whole
pipeline units against the observed request rate, with slower reaction and
the longer provisioning time of replicating a full pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.envelope import max_queries_in_window
from repro_torch.core.estimator import Estimator
from repro_torch.core.pipeline import Pipeline, PipelineConfig, StageConfig
from repro_torch.core.profiler import ProfileStore
from repro_torch.sim import SimEngine

# Replicating a whole pipeline takes much longer than one model (§7.1).
UNIT_ACTIVATION_S = 15.0


@dataclasses.dataclass
class CGPlan:
    config: Optional[PipelineConfig]
    unit_batch: int
    unit_throughput: float          # queries/s of one pipeline unit
    unit_replicas: int
    feasible: bool

    @property
    def cost_per_hr(self) -> float:
        return self.config.cost_per_hr() if self.config else math.inf


class CGPlanner:
    def __init__(self, pipeline: Pipeline, profiles: ProfileStore,
                 estimator: Optional[Estimator] = None):
        self.pipeline = pipeline
        self.profiles = profiles
        # same unified simulation core as the InferLine planner: reuse the
        # caller's engine when an estimator is handed in, else make one
        self.engine = (estimator.engine if estimator is not None
                       else SimEngine(pipeline, profiles))

    def _best_hardware(self, stage: str) -> str:
        st = self.pipeline.stages[stage]
        prof = self.profiles.get(st.model_id)
        opts = [h for h in st.hardware_options if prof.supports(h)]
        return min(opts, key=lambda h: prof.batch_latency(h, 1))

    def _unit_config(self, batch: int, replicas: int) -> PipelineConfig:
        return PipelineConfig({
            s: StageConfig(self._best_hardware(s), batch, replicas)
            for s in self.pipeline.stages
        })

    def _service_time(self, batch: int) -> float:
        cfg = self._unit_config(batch, 1)
        return self.engine.service_time(cfg)

    def _unit_throughput(self, batch: int) -> float:
        """Black-box unit throughput: the bottleneck stage's rate."""
        scale = self.pipeline.scale_factors()
        thru = []
        for s in self.pipeline.stages:
            prof = self.profiles.get(self.pipeline.stages[s].model_id)
            mu = prof.throughput(self._best_hardware(s), batch)
            thru.append(mu / max(scale[s], 1e-9))
        return min(thru)

    def plan(self, arrivals: np.ndarray, slo: float,
             strategy: str = "peak") -> CGPlan:
        arrivals = np.asarray(arrivals, dtype=np.float64)
        # 1) max batch whose end-to-end service time fits the SLO
        batch = 0
        for b in (1, 2, 4, 8, 16, 32, 64, 128):
            if self._service_time(b) <= slo:
                batch = b
        if batch == 0:
            return CGPlan(None, 0, 0.0, 0, False)
        mu_unit = self._unit_throughput(batch)
        # 2) required throughput from the sample trace
        duration = float(arrivals.max() - arrivals.min()) if arrivals.size > 1 else 1.0
        if strategy == "mean":
            rate = arrivals.size / max(duration, 1e-9)
        elif strategy == "peak":
            q = max_queries_in_window(arrivals, max(slo, 1e-3))
            rate = q / max(slo, 1e-3)
        else:
            raise ValueError(f"unknown CG strategy {strategy!r}")
        units = max(1, math.ceil(rate / max(mu_unit, 1e-9)))
        return CGPlan(self._unit_config(batch, units), batch, mu_unit,
                      units, True)


def cg_plan(pipeline: Pipeline, profiles: ProfileStore,
            arrivals: np.ndarray, slo: float, strategy: str) -> CGPlan:
    return CGPlanner(pipeline, profiles).plan(arrivals, slo, strategy)


class CGTuner:
    """AutoScale-style reactive whole-pipeline scaling.

    Reacts to the observed mean request rate (30 s window, every 10 s) by
    adding/removing whole pipeline units; scale-down is hysteresis-guarded
    as in [12]. Compare with the InferLine Tuner's multi-timescale traffic
    envelopes and per-stage scaling.
    """

    def __init__(self, plan: CGPlan, react_interval_s: float = 10.0,
                 obs_window_s: float = 30.0,
                 hysteresis_s: float = 60.0,
                 headroom: float = 1.0):
        if not plan.feasible:
            raise ValueError("cannot tune an infeasible CG plan")
        self.plan = plan
        self.react_interval_s = react_interval_s
        self.obs_window_s = obs_window_s
        self.hysteresis_s = hysteresis_s
        self.headroom = headroom
        self.units = plan.unit_replicas
        self.last_change_t = -math.inf

    def step(self, now: float, arrivals_so_far: np.ndarray) -> int:
        obs = arrivals_so_far[arrivals_so_far > now - self.obs_window_s]
        rate = obs.size / self.obs_window_s
        needed = max(1, math.ceil(
            rate * self.headroom / max(self.plan.unit_throughput, 1e-9)))
        if needed > self.units:
            self.units = needed
            self.last_change_t = now
        elif needed < self.units and (
                now - self.last_change_t >= self.hysteresis_s):
            self.units = needed
            self.last_change_t = now
        return self.units


def run_cg_tuner_offline(
    tuner: CGTuner,
    pipeline: Pipeline,
    arrivals: np.ndarray,
    t_end: Optional[float] = None,
    activation_delay_s: float = UNIT_ACTIVATION_S,
) -> Dict[str, List[Tuple[float, int]]]:
    """Whole-unit scaling schedule -> per-stage replica events."""
    arrivals = np.asarray(arrivals, dtype=np.float64)
    t_end = t_end if t_end is not None else (
        float(arrivals.max()) if arrivals.size else 0.0)
    schedules: Dict[str, List[Tuple[float, int]]] = {
        s: [] for s in pipeline.stages
    }
    before = tuner.units
    t = tuner.react_interval_s
    while t <= t_end + 1e-9:
        after = tuner.step(t, arrivals[arrivals <= t])
        delta = after - before
        if delta > 0:
            for s in pipeline.stages:
                schedules[s].append((t + activation_delay_s, delta))
        elif delta < 0:
            for s in pipeline.stages:
                schedules[s].append((t, delta))
        before = after
        t += tuner.react_interval_s
    return schedules
