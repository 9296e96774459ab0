"""Class-tagged arrival traces for mixed per-query SLO workloads.

Production pipelines serve interactive and batch traffic side by side:
an interactive class with a tight end-to-end deadline and a bulk class
that tolerates seconds of latency, sharing one replica fleet. A
:class:`SLOClass` names one such traffic class (its own arrival rate,
burstiness, and latency SLO); :func:`classed_trace` samples each class's
Gamma arrival process independently and interleaves them into a single
sorted arrival stream with an aligned per-query class-id array.

The resulting :class:`ClassedTrace` is what flows end-to-end through the
stack: ``slo_per_query``/``deadline`` feed the engine's deadline-aware
queueing policies (:mod:`repro_torch.sim.queueing`), ``class_ids`` lets
:class:`repro_torch.sim.SimResult` report per-class latency/miss/drop
breakdowns, and ``Planner.plan_classed`` provisions against the
multi-class feasibility objective (every class meets its own percentile
deadline).

Determinism contract: class ``i`` is sampled with ``seed + i``, so a
single-class trace is *bit-identical* to ``gamma_trace(..., seed=seed)``
— the reference's golden-equivalence guard pins the
whole classed path to the seed engine through this property.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.workload.generator import gamma_trace


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One traffic class: its arrival process and latency objective."""

    name: str
    lam: float                     # mean arrival rate (queries/s)
    cv: float                      # inter-arrival coefficient of variation
    slo_s: float                   # end-to-end latency SLO (seconds)

    def __post_init__(self):
        if self.lam < 0 or self.cv <= 0 or self.slo_s <= 0:
            raise ValueError(f"bad SLOClass {self}")


@dataclasses.dataclass
class ClassedTrace:
    """A merged arrival stream with per-query class tags.

    ``arrivals`` is sorted ascending; ``class_ids[q]`` indexes into
    ``classes`` for query ``q``.
    """

    arrivals: np.ndarray           # (n,) merged sorted arrival times
    class_ids: np.ndarray          # (n,) int index into `classes`
    classes: Tuple[SLOClass, ...]

    @property
    def n(self) -> int:
        return int(self.arrivals.shape[0])

    @property
    def class_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    @property
    def slo_per_query(self) -> np.ndarray:
        """(n,) per-query SLO in seconds — the engine's `slo_s` vector."""
        slos = np.asarray([c.slo_s for c in self.classes], dtype=np.float64)
        return slos[self.class_ids]

    @property
    def deadline(self) -> np.ndarray:
        """(n,) absolute completion deadlines (arrival + class SLO)."""
        return self.arrivals + self.slo_per_query

    @property
    def min_slo_s(self) -> float:
        return min(c.slo_s for c in self.classes)

    def mask(self, name: str) -> np.ndarray:
        """(n,) bool mask selecting queries of the named class."""
        return self.class_ids == self.class_names.index(name)

    def counts(self) -> Dict[str, int]:
        return {c.name: int((self.class_ids == i).sum())
                for i, c in enumerate(self.classes)}


def classed_trace(classes: Sequence[SLOClass], duration_s: float,
                  seed: int = 0, t0: float = 0.0) -> ClassedTrace:
    """Interleave independent Gamma streams, one per class.

    Class ``i`` uses ``seed + i``, so a one-class trace reproduces
    ``gamma_trace(lam, cv, duration_s, seed)`` exactly (see module
    docstring). Ties between classes break by class order (stable merge),
    which keeps repeat calls deterministic.
    """
    if not classes:
        raise ValueError("need at least one SLOClass")
    names = [c.name for c in classes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate class names: {names}")
    parts, ids = [], []
    for i, c in enumerate(classes):
        t = gamma_trace(c.lam, c.cv, duration_s, seed=seed + i, t0=t0)
        parts.append(t)
        ids.append(np.full(t.shape[0], i, dtype=np.int64))
    arrivals = np.concatenate(parts) if parts else np.zeros(0)
    class_ids = np.concatenate(ids) if ids else np.zeros(0, dtype=np.int64)
    order = np.argsort(arrivals, kind="stable")
    return ClassedTrace(arrivals[order], class_ids[order], tuple(classes))
