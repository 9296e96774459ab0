"""The Estimator (§4.2): thin façade over the unified simulation engine.

Given a pipeline configuration, per-model profiles, and an arrival trace,
returns an accurate latency estimate for *each query* in the trace.

The actual discrete-event core lives in :mod:`repro_torch.sim` (engine
design notes in that module); this module keeps the paper-facing API —
``Estimator.simulate`` and the planner helpers — and re-exports
:class:`repro_torch.sim.SimResult`. Consumers that evaluate many
configurations against one trace (the Planner) should open
``Estimator.session(arrivals)`` to get incremental re-simulation.

Dynamic replica schedules (what the tuner's scaling decisions become)
are supported via per-stage ``(time, +1/-1)`` replica events.

A copy of the reference's ``repro.core.estimator`` on the port's
engine; ``tests/test_torch_plan.py`` holds its latencies bit-identical
to the reference's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.pipeline import Pipeline, PipelineConfig
from repro_torch.core.profiler import ProfileStore
from repro_torch.sim import (
    DEFAULT_RPC_DELAY_S,
    SimEngine,
    SimResult,
    TraceSession,
)

__all__ = ["DEFAULT_RPC_DELAY_S", "Estimator", "SimResult"]


class Estimator:
    """Simulates a pipeline configuration over an arrival trace."""

    def __init__(
        self,
        pipeline: Pipeline,
        profiles: ProfileStore,
        rpc_delay_s: float = DEFAULT_RPC_DELAY_S,
        seed: int = 0,
    ):
        self.pipeline = pipeline
        self.profiles = profiles
        self.rpc_delay_s = rpc_delay_s
        self.seed = seed
        self.engine = SimEngine(pipeline, profiles, rpc_delay_s=rpc_delay_s,
                                seed=seed)

    def session(self, arrivals: np.ndarray,
                slo_s: Optional[Union[float, np.ndarray]] = None,
                class_ids: Optional[np.ndarray] = None,
                class_names: Optional[Sequence[str]] = None,
                backend: str = "numpy",
                device=None) -> TraceSession:
        """Bind to one trace for incremental re-simulation across configs.

        ``backend="torch"`` routes eligible candidate grids through the
        CUDA fill kernel on ``device`` (:mod:`repro_torch.sim
        .torch_backend`; None means CUDA and raises without a GPU, "cpu"
        runs the kernel's plain torch version); bit-identical to the
        default numpy path. Another name raises ``ValueError``."""
        return self.engine.session(arrivals, slo_s=slo_s,
                                   class_ids=class_ids,
                                   class_names=class_names,
                                   backend=backend, device=device)

    def simulate(
        self,
        config: PipelineConfig,
        arrivals: np.ndarray,
        replica_schedules: Optional[Dict[str, Sequence[Tuple[float, int]]]] = None,
        slo_s: Optional[Union[float, np.ndarray]] = None,
        class_ids: Optional[np.ndarray] = None,
        class_names: Optional[Sequence[str]] = None,
    ) -> SimResult:
        """Run the trace through the configured pipeline.

        Args:
          config: per-stage (hardware, batch, replicas[, policy]).
          arrivals: (n,) sorted arrival times in seconds.
          replica_schedules: optional dynamic scaling events per stage
            (see module docstring).
          slo_s: optional per-query deadline horizon (arrival + slo_s),
            consumed by deadline-aware policies (``edf``, ``slo-drop``).
            Scalar = uniform SLO; an (n,) vector carries mixed per-query
            SLO classes (:mod:`repro_torch.workload.slo_classes`).
          class_ids / class_names: optional per-query SLO-class tags for
            ``SimResult.per_class`` breakdowns.
        """
        return self.engine.simulate(config, arrivals,
                                    replica_schedules=replica_schedules,
                                    slo_s=slo_s, class_ids=class_ids,
                                    class_names=class_names)

    def simulate_many(
        self,
        configs: Sequence[PipelineConfig],
        arrivals: np.ndarray,
        replica_schedules: Optional[Dict[str, Sequence[Tuple[float, int]]]] = None,
    ) -> Sequence[SimResult]:
        """Batched candidate evaluation over one trace: every distinct
        stage entry is simulated exactly once and result assembly is
        shared across candidates with common configuration prefixes
        (see :meth:`repro_torch.sim.TraceSession.simulate_many`). Element-wise
        equal to ``[self.simulate(c, arrivals) for c in configs]``."""
        return self.session(arrivals).simulate_many(
            configs, replica_schedules=replica_schedules)

    # -- planner-facing helpers ----------------------------------------------
    def estimate_p99(self, config: PipelineConfig, arrivals: np.ndarray) -> float:
        return self.simulate(config, arrivals).p99

    def is_feasible(self, config: PipelineConfig, arrivals: np.ndarray,
                    slo: float, percentile: float = 99.0) -> bool:
        res = self.simulate(config, arrivals)
        return res.percentile(percentile) <= slo

    def service_time(self, config: PipelineConfig) -> float:
        """Sum of batch-size-configured latencies along the longest path
        (queueing excluded) — Alg. 1's `ServiceTime`."""
        return self.engine.service_time(config)
