"""Network-calculus traffic envelopes (§5, Fig. 4).

A traffic envelope maps window sizes ``dT_i`` to the maximum number of
queries observed in ANY window of that width over a trace — a multi-scale
characterization that simultaneously captures burstiness (small windows)
and sustained rate (large windows).

Window sizes follow the paper: the smallest is the pipeline service time
``T_s``, doubling up to 60 seconds.

A copy of the reference's ``repro.core.envelope``
(``tests/test_torch_plan.py`` holds its outputs equal to the reference's).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def envelope_windows(service_time_s: float, max_window_s: float = 60.0
                     ) -> np.ndarray:
    """dT_i = T_s * 2^i, i = 0.. until >= max_window_s (inclusive cap)."""
    ts = max(service_time_s, 1e-3)
    ws = [ts]
    while ws[-1] < max_window_s:
        ws.append(min(ws[-1] * 2.0, max_window_s))
    # dedupe the cap if T_s*2^k lands exactly on 60
    out = np.asarray(sorted(set(ws)))
    return out


def max_queries_in_window(arrivals: np.ndarray, window_s: float) -> int:
    """Max #arrivals in any half-open interval of width `window_s`.

    Two-pointer sweep anchored at each arrival: the maximizing window can
    always be shifted to start at an arrival instant.
    """
    n = arrivals.shape[0]
    if n == 0:
        return 0
    j = 0
    best = 1
    for i in range(n):
        if arrivals[i] < arrivals[j]:
            raise ValueError("arrivals must be sorted")
        while arrivals[i] - arrivals[j] >= window_s:
            j += 1
        best = max(best, i - j + 1)
    return best


def _max_counts_vectorized(arrivals: np.ndarray, windows: np.ndarray
                           ) -> np.ndarray:
    """Vectorized two-pointer via searchsorted, one pass per window."""
    n = arrivals.shape[0]
    out = np.zeros(windows.shape[0], dtype=np.int64)
    if n == 0:
        return out
    for wi, w in enumerate(windows):
        # count of arrivals in [t_j, t_j + w) for every anchor j
        hi = np.searchsorted(arrivals, arrivals + w, side="left")
        out[wi] = int((hi - np.arange(n)).max())
    return out


@dataclasses.dataclass(frozen=True)
class TrafficEnvelope:
    """Envelope: windows (s) -> max query counts -> implied max rates."""

    windows: np.ndarray          # (W,) seconds
    max_counts: np.ndarray       # (W,) queries

    @property
    def rates(self) -> np.ndarray:
        """r_i = q_i / dT_i (queries/s)."""
        return self.max_counts / self.windows

    @staticmethod
    def from_trace(arrivals: np.ndarray, service_time_s: float,
                   max_window_s: float = 60.0) -> "TrafficEnvelope":
        arrivals = np.asarray(arrivals, dtype=np.float64)
        windows = envelope_windows(service_time_s, max_window_s)
        counts = _max_counts_vectorized(arrivals, windows)
        return TrafficEnvelope(windows, counts)

    def exceeded_by(self, other: "TrafficEnvelope",
                    tolerance: float = 1.05,
                    abs_slack: int = 2) -> Tuple[bool, float]:
        """Does `other` (current workload) exceed this (planned) envelope?

        Returns (exceeded, r_max) where r_max is the largest violating rate
        (§5: "In the case that multiple rates have exceeded their sample
        trace counterpart, we take the max rate.").

        A small tolerance (rel x abs) filters sampling noise: a fresh
        same-law trace exceeds SOME window's exact max count ~half the
        time, and a handful of extra queries in a 100 ms window converts
        into a large sustained-rate requirement (observed: 2.5x
        over-scaling on a flat trace). Genuine burstiness/rate changes
        move counts well past 5%+2.
        """
        if not np.allclose(self.windows, other.windows):
            raise ValueError("envelopes must share window sizes")
        limit = np.maximum(self.max_counts * tolerance,
                           self.max_counts + abs_slack)
        over = other.max_counts > limit
        if not over.any():
            return False, 0.0
        return True, float(other.rates[over].max())

    def describe(self) -> str:
        rows = [
            f"  dT={w:8.3f}s  q_max={int(q):7d}  rate={r:9.2f} qps"
            for w, q, r in zip(self.windows, self.max_counts, self.rates)
        ]
        return "\n".join(rows)


class IncrementalEnvelope:
    """Streaming traffic envelope over a growing arrival prefix.

    The closed-loop co-simulation (the tuner's epoch stepping) observes
    ingress one epoch at a time; recomputing ``TrafficEnvelope.from_trace``
    on the whole prefix every epoch is O(n * W) per step. This maintains
    the same per-window max counts incrementally: each ``extend`` only
    scans the NEW arrivals, using the end-anchored formulation — the max
    over windows whose *last* contained arrival is index ``i`` is
    ``i - first index j with t_j > t_i - w + 1`` — which equals the
    start-anchored max of :func:`_max_counts_vectorized` (every maximal
    window can be shifted so an arrival is last in it).

    ``snapshot()`` equals ``from_trace`` on the prefix.
    """

    def __init__(self, service_time_s: float, max_window_s: float = 60.0):
        self.windows = envelope_windows(service_time_s, max_window_s)
        self.max_counts = np.zeros(self.windows.shape[0], dtype=np.int64)
        self._arr = np.zeros(0, dtype=np.float64)

    @property
    def n(self) -> int:
        return int(self._arr.shape[0])

    def extend(self, new_arrivals: np.ndarray) -> "IncrementalEnvelope":
        """Fold in arrivals at/after everything seen so far (sorted)."""
        new = np.asarray(new_arrivals, dtype=np.float64)
        if new.size == 0:
            return self
        if new.size > 1 and np.any(np.diff(new) < 0):
            raise ValueError("new arrivals must be sorted")
        if self._arr.size and new[0] < self._arr[-1]:
            raise ValueError("arrivals must extend the observed prefix")
        n_old = self._arr.shape[0]
        arr = np.concatenate([self._arr, new])
        idx_new = np.arange(n_old, arr.shape[0])
        for wi, w in enumerate(self.windows):
            # window ending at each new arrival: count of t_j > t_new - w
            lo = np.searchsorted(arr, new - w, side="right")
            best = int((idx_new - lo + 1).max())
            if best > self.max_counts[wi]:
                self.max_counts[wi] = best
        self._arr = arr
        return self

    def snapshot(self) -> TrafficEnvelope:
        return TrafficEnvelope(self.windows, self.max_counts.copy())
