"""DS2-style autoscaler baseline (§8, Fig. 14).

A copy of the reference's ``repro.baselines.ds2``, numpy over the
port's engine: its decisions are the reference's, equal with ``==``.

DS2 [17] estimates each operator's true processing rate and jumps directly
to the optimal parallelism for all operators at once. Two properties drive
its weakness under bursty, latency-SLO-constrained serving:

1. It provisions for the *average* ingest rate — no burst slack, so
   transient spikes overload the pipeline until queues drain.
2. Re-configuration requires the streaming runtime (Flink) to halt
   processing, checkpoint, and restore: every scaling action stalls the
   pipeline, which itself causes SLO misses. We model the stall by
   retiring all replicas of every stage for ``stall_s`` around the action.

Deployed with batch size 1 as in the paper's Fig. 14 setup.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import Pipeline, PipelineConfig, StageConfig
from repro_torch.core.profiler import ProfileStore


class DS2Tuner:
    def __init__(self, pipeline: Pipeline, profiles: ProfileStore,
                 hardware: Dict[str, str],
                 react_interval_s: float = 5.0,
                 obs_window_s: float = 10.0,
                 stall_s: float = 2.0,
                 utilization_target: float = 0.8):
        self.pipeline = pipeline
        self.profiles = profiles
        self.hardware = hardware
        self.react_interval_s = react_interval_s
        self.obs_window_s = obs_window_s
        self.stall_s = stall_s
        self.utilization_target = utilization_target
        self.scale = pipeline.scale_factors()
        # single-query processing rate per operator (batch=1 streaming)
        self.mu = {
            s: profiles.get(pipeline.stages[s].model_id)
                       .throughput(hardware[s], 1)
            for s in pipeline.stages
        }
        self.replicas: Dict[str, int] = {}

    def initial_config(self, arrivals: np.ndarray) -> PipelineConfig:
        """Provision for the sample trace's average rate (no slack)."""
        arr = np.asarray(arrivals, dtype=np.float64)
        duration = float(arr.max() - arr.min()) if arr.size > 1 else 1.0
        lam = arr.size / max(duration, 1e-9)
        cfg = {}
        for s in self.pipeline.stages:
            k = max(1, math.ceil(lam * self.scale[s]
                                 / (self.mu[s] * self.utilization_target)))
            cfg[s] = StageConfig(self.hardware[s], 1, k)
            self.replicas[s] = k
        return PipelineConfig(cfg)

    def _targets(self, rate: float) -> Dict[str, int]:
        return {
            s: max(1, math.ceil(rate * self.scale[s]
                                / (self.mu[s] * self.utilization_target)))
            for s in self.pipeline.stages
        }

    def run_offline(self, arrivals: np.ndarray,
                    t_end: Optional[float] = None
                    ) -> Dict[str, List[Tuple[float, int]]]:
        """Scaling schedule incl. halt/restore stalls at each action."""
        arrivals = np.asarray(arrivals, dtype=np.float64)
        t_end = t_end if t_end is not None else (
            float(arrivals.max()) if arrivals.size else 0.0)
        if not self.replicas:
            self.initial_config(arrivals)
        sched: Dict[str, List[Tuple[float, int]]] = {
            s: [] for s in self.pipeline.stages
        }
        # first decision only after one full observation window
        t = max(self.react_interval_s, self.obs_window_s)
        while t <= t_end + 1e-9:
            obs = arrivals[(arrivals > t - self.obs_window_s) & (arrivals <= t)]
            rate = obs.size / self.obs_window_s
            targets = self._targets(rate)
            under = any(targets[s] > self.replicas[s]
                        for s in self.pipeline.stages)
            # DS2 jumps straight to the computed optimum but (like the
            # real system) does not thrash on noise: reconfigure when any
            # stage is under-provisioned, or when the total target drops
            # far enough to be worth a halt-restore cycle.
            shrink = sum(targets.values()) <= 0.75 * sum(
                self.replicas.values())
            if under or shrink:
                # halt-checkpoint-restore: all stages offline for stall_s
                for s in self.pipeline.stages:
                    k_old, k_new = self.replicas[s], targets[s]
                    sched[s].append((t, -k_old))
                    sched[s].append((t + self.stall_s, k_new))
                self.replicas = dict(targets)
            t += self.react_interval_s
        return sched


def run_ds2(tuner: DS2Tuner, profiles: ProfileStore, arrivals: np.ndarray,
            slo: float):
    """Provision for the trace average, then serve it with DS2 scaling.

    Returns a LiveRunResult (same contract as the InferLine live runs so
    Fig. 14 can compare directly); the serve itself runs on the unified
    simulation engine via LiveClusterSim, so queue/batch/stall dynamics
    are modeled identically for DS2 and InferLine.
    """
    from repro_torch.serving.cluster import LiveClusterSim

    arrivals = np.asarray(arrivals, dtype=np.float64)
    config = tuner.initial_config(arrivals)
    sim = LiveClusterSim(tuner.pipeline, profiles, config, slo)
    return sim.run(arrivals, schedule_fn=tuner.run_offline)
