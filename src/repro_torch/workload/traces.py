"""Real-workload-derived traces (§6, Fig. 6).

A copy of the reference's ``repro.workload.traces``: the same arrivals,
equal with ``==``, for the same shape, rate and seed.

The AutoScale paper's workloads report only per-minute average request
rates over an hour. Following the paper, we re-scale the peak to a target
max throughput and synthesize inter-arrivals by sampling a Gamma(CV=1)
process for each constant-rate segment.

Two canonical shapes are bundled, mirroring Fig. 6:
  * "big_spike"  — a diurnal-ish baseline with one large sustained spike.
  * "dual_phase" — slow rise, instantaneous spike, then rapid fall-off.
"""

from __future__ import annotations

import numpy as np

# Per-minute mean rates, unit-normalized (max = 1.0). 60 entries = 1 hour.
_BIG_SPIKE = np.array(
    [0.28, 0.27, 0.29, 0.30, 0.28, 0.30, 0.31, 0.30, 0.32, 0.33,
     0.32, 0.34, 0.35, 0.34, 0.36, 0.38, 0.37, 0.39, 0.40, 0.42,
     0.45, 0.55, 0.75, 0.92, 1.00, 0.97, 0.90, 0.78, 0.62, 0.50,
     0.44, 0.41, 0.40, 0.39, 0.38, 0.37, 0.38, 0.36, 0.35, 0.36,
     0.35, 0.34, 0.35, 0.33, 0.34, 0.33, 0.32, 0.33, 0.32, 0.31,
     0.32, 0.31, 0.30, 0.31, 0.30, 0.29, 0.30, 0.29, 0.28, 0.29])

_DUAL_PHASE = np.array(
    [0.20, 0.21, 0.22, 0.24, 0.26, 0.28, 0.30, 0.33, 0.36, 0.39,
     0.42, 0.46, 0.50, 0.54, 0.58, 0.62, 0.66, 0.94, 1.00, 0.96,
     0.90, 0.82, 0.74, 0.66, 0.58, 0.50, 0.43, 0.37, 0.31, 0.26,
     0.22, 0.19, 0.16, 0.14, 0.12, 0.11, 0.10, 0.09, 0.09, 0.08,
     0.08, 0.07, 0.07, 0.07, 0.06, 0.06, 0.06, 0.06, 0.05, 0.05,
     0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05])

_SHAPES = {"big_spike": _BIG_SPIKE, "dual_phase": _DUAL_PHASE}


def autoscale_derived_trace(
    shape: str = "big_spike",
    max_qps: float = 300.0,
    segment_s: float = 30.0,
    cv: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize a full inter-arrival trace from a per-minute rate shape.

    Follows §6: iterate through the mean rates, re-scaled so the max is
    ``max_qps``, sampling Gamma(cv) inter-arrivals for ``segment_s``
    seconds per entry.
    """
    try:
        rates = _SHAPES[shape] * max_qps
    except KeyError:
        raise KeyError(f"unknown trace shape {shape!r}; have {sorted(_SHAPES)}")
    rng = np.random.default_rng(seed)
    k = 1.0 / cv
    out = []
    t0 = 0.0
    for lam in rates:
        if lam > 1e-9:
            theta = cv / lam
            n_est = int(lam * segment_s * 1.6) + 32
            gaps = rng.gamma(k, theta, size=n_est)
            t = np.cumsum(gaps)
            while t[-1] < segment_s:
                t = np.concatenate(
                    [t, t[-1] + np.cumsum(rng.gamma(k, theta, size=n_est))])
            out.append(t0 + t[t < segment_s])
        t0 += segment_s
    return np.concatenate(out) if out else np.zeros(0)


def split_plan_serve(arrivals: np.ndarray, plan_frac: float = 0.25
                     ) -> tuple[np.ndarray, np.ndarray]:
    """First `plan_frac` of the trace for the Planner, rest for live serving
    (§6: "first 25% ... as the sample for the Planner")."""
    if arrivals.size == 0:
        return arrivals, arrivals
    t_cut = float(arrivals.max()) * plan_frac
    head = arrivals[arrivals < t_cut]
    tail = arrivals[arrivals >= t_cut] - t_cut
    return head, tail
