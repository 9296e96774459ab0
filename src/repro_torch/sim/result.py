"""Per-query simulation outcomes shared by every engine consumer.

``SimResult`` is the single result type produced by the unified engine
(:mod:`repro_torch.sim.engine`) and consumed by the Estimator façade and
the Planner. A copy of the reference's ``repro.sim.result``; the epoch
telemetry records are what the tuner reads.

Beyond the seed estimator's result it carries an optional per-query
``dropped`` mask for SLO-aware load-shedding policies
(:mod:`repro_torch.sim.queueing`): shed queries have ``latency = +inf`` and
``dropped[q] = True``, and count as SLO misses.

For mixed per-query SLO workloads (:mod:`repro_torch.workload.slo_classes`)
it additionally carries per-query ``class_ids`` / ``slo_s`` tags, and
:meth:`per_class` reports the latency/miss/drop breakdown each class
sees — the multi-class planner objective and the SLO-class benchmark
both consume it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.envelope import TrafficEnvelope


@dataclasses.dataclass
class SimResult:
    """Per-query outcome of one simulation run."""

    arrival: np.ndarray            # (n,) arrival time of each query
    latency: np.ndarray            # (n,) end-to-end latency (s); +inf if shed
    per_stage_batches: Dict[str, np.ndarray]  # stage -> batch sizes formed
    dropped: Optional[np.ndarray] = None      # (n,) bool; None = no shedding
    class_ids: Optional[np.ndarray] = None    # (n,) int SLO-class tags
    class_names: Optional[Tuple[str, ...]] = None  # id -> display name
    slo_s: Optional[np.ndarray] = None        # (n,) per-query SLO (s)

    @property
    def num_queries(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def num_dropped(self) -> int:
        return int(self.dropped.sum()) if self.dropped is not None else 0

    @property
    def drop_rate(self) -> float:
        n = self.num_queries
        return self.num_dropped / n if n else 0.0

    def _miss_mask(self, slo: float) -> np.ndarray:
        miss = self.latency > slo
        if self.dropped is not None:
            miss = miss | self.dropped
        return miss

    def percentile(self, p: float) -> float:
        """Latency percentile over ALL queries (shed queries are +inf, so
        tail percentiles correctly blow up under shedding)."""
        return float(np.percentile(self.latency, p)) if self.latency.size else 0.0

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean(self) -> float:
        """Mean latency over served (non-shed) queries."""
        if not self.latency.size:
            return 0.0
        if self.dropped is not None and self.dropped.any():
            served = self.latency[~self.dropped]
            return float(served.mean()) if served.size else 0.0
        return float(self.latency.mean())

    def slo_miss_rate(self, slo: float) -> float:
        if not self.latency.size:
            return 0.0
        return float(self._miss_mask(slo).mean())

    def slo_attainment(self, slo: float) -> float:
        return 1.0 - self.slo_miss_rate(slo)

    # -- per-query / per-class SLO accounting -----------------------------
    def per_query_miss_mask(self) -> np.ndarray:
        """Miss mask against each query's OWN SLO (requires ``slo_s``)."""
        if self.slo_s is None:
            raise ValueError("result carries no per-query slo_s")
        miss = self.latency > self.slo_s
        if self.dropped is not None:
            miss = miss | self.dropped
        return miss

    def per_query_miss_rate(self) -> float:
        if not self.latency.size:
            return 0.0
        return float(self.per_query_miss_mask().mean())

    def class_mask(self, cls) -> np.ndarray:
        """Bool mask for one class, by id or (if names were set) name."""
        if self.class_ids is None:
            raise ValueError("result carries no class_ids")
        if isinstance(cls, str):
            if self.class_names is None:
                raise ValueError("result carries no class_names")
            cls = self.class_names.index(cls)
        return self.class_ids == int(cls)

    def per_class(self) -> Dict[str, Dict[str, float]]:
        """Latency/miss/drop breakdown per SLO class.

        Returns ``{class_name: {n, slo_s, p50, p99, p99_served,
        mean_served, miss_rate, drop_rate}}``; miss rate is against the
        class's own SLO (misses include drops). When ``class_names`` is
        set, every named class gets an entry — a class with no queries
        in the trace reports ``n=0`` and zero latencies rather than
        vanishing from the breakdown.
        """
        if self.class_ids is None:
            raise ValueError("result carries no class_ids")
        ids = (range(len(self.class_names)) if self.class_names
               else np.unique(self.class_ids))
        out: Dict[str, Dict[str, float]] = {}
        for cid in ids:
            sel = self.class_ids == cid
            name = (self.class_names[int(cid)] if self.class_names
                    else str(int(cid)))
            if not sel.any():
                out[name] = {"n": 0, "p50": 0.0, "p99": 0.0,
                             "p99_served": 0.0, "mean_served": 0.0,
                             "drop_rate": 0.0}
                if self.slo_s is not None:
                    out[name]["slo_s"] = float("nan")
                    out[name]["miss_rate"] = 0.0
                continue
            lat = self.latency[sel]
            dropped = self.dropped[sel] if self.dropped is not None else \
                np.zeros(lat.shape[0], dtype=bool)
            served = lat[~dropped]
            # under heavy shedding the all-queries percentiles interpolate
            # between +infs (nan); that is meaningful ("tail is shed"),
            # p99_served carries the finite tail — just mute the warning
            with np.errstate(invalid="ignore"):
                p50 = float(np.percentile(lat, 50.0))
                p99 = float(np.percentile(lat, 99.0))
            stats = {
                "n": int(lat.shape[0]),
                "p50": p50,
                "p99": p99,
                "p99_served": (float(np.percentile(served, 99.0))
                               if served.size else 0.0),
                "mean_served": float(served.mean()) if served.size else 0.0,
                "drop_rate": float(dropped.mean()) if lat.size else 0.0,
            }
            if self.slo_s is not None:
                slo = self.slo_s[sel]
                stats["slo_s"] = float(slo[0]) if slo.size else float("nan")
                stats["miss_rate"] = float(
                    ((lat > slo) | dropped).mean()) if lat.size else 0.0
            out[name] = stats
        return out

    def telemetry_summary(self) -> Dict[str, float]:
        """Scalar roll-up used by closed-loop benchmark records."""
        out = {"n": float(self.num_queries), "p99": self.p99,
               "mean": self.mean, "drop_rate": self.drop_rate}
        if self.slo_s is not None:
            out["miss_rate"] = self.per_query_miss_rate()
        return out

    def windowed_miss_rate(self, slo: float, window_s: float = 5.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """(window_start_times, miss_rate per window) for time-series plots.

        Vectorized: one ``np.bincount`` pass over the trace instead of the
        seed's O(windows x n) Python loop — fig6/fig7 call this per window
        configuration over hour-long traces.
        """
        if not self.latency.size:
            return np.zeros(0), np.zeros(0)
        t_end = float(self.arrival.max())
        edges = np.arange(0.0, t_end + window_s, window_s)
        idx = np.clip(np.digitize(self.arrival, edges) - 1, 0, len(edges) - 1)
        miss = self._miss_mask(slo).astype(np.float64)
        counts = np.bincount(idx, minlength=len(edges)).astype(np.float64)
        missed = np.bincount(idx, weights=miss, minlength=len(edges))
        rates = np.full(len(edges), np.nan)
        nz = counts > 0
        rates[nz] = missed[nz] / counts[nz]
        return edges, rates


# -- closed-loop co-simulation telemetry (the tuner's epoch records) -------
#
# One EpochTelemetry per control epoch: the engine advances to the epoch
# boundary, samples each stage's queue, and the Tuner consumes the record
# to decide scale / admission-control events. Everything here is CAUSAL —
# computed only from batches whose start time is at or before the epoch
# boundary, which future control events (landing strictly later) can
# never alter, so the record a controller sees mid-run is exactly the
# record a full-trace re-simulation with the final schedule reproduces.


@dataclasses.dataclass
class StageTelemetry:
    """One stage's queue view over one control epoch (t_start, t_end]."""

    stage: str
    arrived: int          # queries whose input became ready in the window
    completed: int        # finite completions in the window
    dropped: int          # shed queries whose deadline fell in the window
    queue_depth: int      # ready <= t_end, neither completed nor shed yet
    in_flight: int        # queue_depth subset completing within one batch
    #                       service time of t_end (= currently in service,
    #                       up to the batch-latency bound)
    replicas: int         # configured replica target effective at t_end
    alive: int = -1       # replicas minus observed crash losses at t_end;
    #                       -1 = no fault tracking (legacy constructors),
    #                       which controllers treat as "assume healthy"


@dataclasses.dataclass
class EpochTelemetry:
    """Everything the engine tells the Tuner at one epoch boundary."""

    epoch: int
    t_start: float
    t_end: float
    ingress: int                      # ingress arrivals in the window
    ingress_prefix: np.ndarray        # all ingress arrivals <= t_end
    observed_envelope: TrafficEnvelope  # incremental envelope over prefix
    stages: Dict[str, StageTelemetry]
    completed: int                    # pipeline completions in the window
    missed: int                       # window completions over their SLO
    overdue: int                      # uncompleted queries whose deadline
    #                                   newly passed in the window (a miss
    #                                   observable before completion)
    drops: int                        # shed, deadline in the window
    p99_s: float                      # window-completion p99 (nan if none)

    @property
    def misses(self) -> int:
        """SLO misses observed this epoch (late completions + newly
        overdue in-flight/shed queries)."""
        return self.missed + self.overdue

    @property
    def queue_depth_total(self) -> int:
        return sum(s.queue_depth for s in self.stages.values())

    @property
    def miss_fraction(self) -> float:
        """Misses over queries resolved or newly overdue this epoch."""
        return self.misses / max(self.completed + self.overdue, 1)
