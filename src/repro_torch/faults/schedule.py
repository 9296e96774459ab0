"""Fault schedules + recovery policy (the shared fault vocabulary): a
copy of the reference's ``repro.faults.schedule``.

A :class:`FaultSchedule` is a deterministic, seedable description of
capacity disruptions, normalized to per-stage sorted event streams of
uniform ``(kind, t0, t1, value)`` tuples:

* ``crash``    — ``value`` replicas of the stage die at ``t0`` (point
  event, ``t1 == t0``). A crashed replica's in-flight batch is lost;
  the recovery policy decides whether its requests requeue or fail.
* ``straggle`` — service on the stage runs ``value``x slower for every
  batch dispatched inside ``[t0, t1)``.
* ``error``    — a batch dispatched inside ``[t0, t1)`` fails with
  probability ``value`` (drawn from the stage's seeded substream);
  failed work is retried under the recovery policy.

The per-stage tuple streams are what both backends consume and what the
engine folds into its cone cache keys (see ``_fault_key`` in
:mod:`repro_torch.sim.engine` and the KEY01 analysis rule) — a schedule
component that never reaches the key would let two different fault
scenarios collide on one cached stage outcome.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

FAULT_KINDS: Tuple[str, ...] = ("crash", "straggle", "error")


class InjectedFault(Exception):
    """A deliberately injected transient stage error (distinguishable
    from a real model failure in logs and tests)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault event; use :func:`crash` / :func:`straggle` /
    :func:`transient` rather than constructing directly."""

    kind: str
    stage: str
    t0: float
    t1: float
    value: float

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}")
        if self.t0 < 0.0 or self.t1 < self.t0:
            raise ValueError(
                f"fault window [{self.t0}, {self.t1}] is not a valid "
                f"non-negative interval")
        if self.kind == "crash":
            if self.t1 != self.t0:
                raise ValueError("crash is a point event (t1 must equal t0)")
            if int(self.value) < 1:
                raise ValueError("crash must kill >= 1 replica")
        elif self.kind == "straggle":
            if self.value < 1.0:
                raise ValueError(
                    f"straggle factor must be >= 1 (got {self.value})")
        elif not (0.0 <= self.value <= 1.0):
            raise ValueError(
                f"error probability must be in [0, 1] (got {self.value})")


def crash(stage: str, t: float, n: int = 1) -> Fault:
    """`n` replicas of `stage` die at time `t`."""
    return Fault("crash", stage, float(t), float(t), float(int(n)))


def straggle(stage: str, t0: float, t1: float, factor: float) -> Fault:
    """Service on `stage` runs `factor`x slower over ``[t0, t1)``."""
    return Fault("straggle", stage, float(t0), float(t1), float(factor))


def transient(stage: str, t0: float, t1: float, p: float) -> Fault:
    """Batches on `stage` dispatched in ``[t0, t1)`` fail w.p. `p`."""
    return Fault("error", stage, float(t0), float(t1), float(p))


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How failed deliveries are retried (both backends honor this).

    A request's first delivery attempt is attempt 1; a failure triggers
    retry attempts up to ``max_attempts`` total, the i-th retry delayed
    by ``backoff(i) = backoff_s * backoff_mult**(i-1)`` (monotone
    non-decreasing — property-tested). With ``hedge_slack_s > 0`` a
    retry whose remaining deadline budget is below the slack enqueues a
    duplicate copy; delivery stays exactly-once via resolve-once dedup
    on request identity. ``enabled=False`` turns every failure into a
    permanent drop (the recovery-off baseline)."""

    enabled: bool = True
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    hedge_slack_s: float = 0.0

    def __post_init__(self):
        if int(self.max_attempts) < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0.0:
            raise ValueError("backoff_s must be non-negative")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1 (monotone backoff)")
        if self.hedge_slack_s < 0.0:
            raise ValueError("hedge_slack_s must be non-negative")

    def backoff(self, retry_index: int) -> float:
        """Delay before the `retry_index`-th retry (1-based)."""
        if retry_index < 1:
            raise ValueError("retry_index is 1-based")
        return self.backoff_s * self.backoff_mult ** (retry_index - 1)

    def key(self) -> Tuple:
        return (bool(self.enabled), int(self.max_attempts),
                float(self.backoff_s), float(self.backoff_mult),
                float(self.hedge_slack_s))


@dataclasses.dataclass(frozen=True)
class StageFaults:
    """One stage's view of a schedule: its sorted ``(kind, t0, t1,
    value)`` events plus the shared seed and recovery policy."""

    stage: str
    events: Tuple[Tuple[str, float, float, float], ...]
    seed: int
    recovery: RecoveryPolicy

    def crashes(self) -> List[Tuple[float, int]]:
        """Sorted ``(t, n_replicas)`` crash points."""
        return [(t0, int(v)) for kind, t0, t1, v in self.events
                if kind == "crash"]

    def slowdown_at(self, t: float) -> float:
        """Service-time multiplier for a batch dispatched at `t` (max
        over covering straggle windows; 1.0 outside any window)."""
        factor = 1.0
        for kind, t0, t1, v in self.events:
            if kind == "straggle" and t0 <= t < t1 and v > factor:
                factor = v
        return factor

    def error_p(self, t: float) -> float:
        """Per-batch failure probability at dispatch instant `t`."""
        p = 0.0
        for kind, t0, t1, v in self.events:
            if kind == "error" and t0 <= t < t1 and v > p:
                p = v
        return p

    def rng(self) -> np.random.Generator:
        """The stage's seeded substream (shared seeding convention with
        the live executor: ``[seed, crc32(stage)]``)."""
        return np.random.default_rng(
            [int(self.seed), zlib.crc32(self.stage.encode())])


class FaultSchedule:
    """A full fault scenario: events over any stages + seed + recovery.

    Normalizes the event list into per-stage sorted streams of uniform
    4-tuples (``(kind, t0, t1, value)``) — the representation both the
    engine's cone keys and the live fault driver consume. Falsy when it
    carries no events, so ``faults or None`` composes like the other
    schedule kinds.
    """

    def __init__(self, faults: Iterable[Fault] = (), seed: int = 0,
                 recovery: Optional[RecoveryPolicy] = None):
        self.seed = int(seed)
        self.recovery = recovery if recovery is not None else RecoveryPolicy()
        per: Dict[str, List[Fault]] = {}
        for f in faults:
            if not isinstance(f, Fault):
                raise TypeError(f"expected Fault, got {type(f).__name__}")
            per.setdefault(f.stage, []).append(f)
        self._by_stage: Dict[str, StageFaults] = {}
        for s, fs in per.items():
            raw = [(f.kind, f.t0, f.t1, f.value) for f in fs]
            evs = tuple(sorted(
                (str(k), float(a), float(b), float(v))
                for k, a, b, v in raw))
            self._by_stage[s] = StageFaults(s, evs, self.seed, self.recovery)

    def stage(self, name: str) -> Optional[StageFaults]:
        return self._by_stage.get(name)

    def stages(self) -> Tuple[str, ...]:
        return tuple(sorted(self._by_stage))

    def __bool__(self) -> bool:
        return bool(self._by_stage)

    def key(self) -> Tuple:
        """Hashable scenario identity (seed, recovery, per-stage events)."""
        return (self.seed, self.recovery.key(), tuple(
            (s, self._by_stage[s].events) for s in self.stages()))
