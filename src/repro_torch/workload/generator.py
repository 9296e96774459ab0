"""Synthetic arrival-trace generation (§6, "Workload Setup").

Inter-arrival times are sampled from a Gamma distribution parameterized by
mean rate ``lam`` (queries/s) and coefficient of variation ``cv``; the
paper defines CV = sigma^2 / mu^2 over inter-arrival times, so:

  Gamma(shape k, scale theta):  mean = k*theta, var = k*theta^2
  CV = var/mean^2 = 1/k  =>  k = 1/CV, theta = 1/(lam*k)

CV=1 is Poisson; CV=4 is heavily bursty. Time-varying workloads evolve the
generating distribution between two parameter sets over a transition
window, reproducing the Tuner experiments (Fig. 10/11).

A copy of the reference's ``repro.workload.generator``: the same
arrivals, equal with ``==``, for the same parameters and seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def gamma_trace(lam: float, cv: float, duration_s: float,
                seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Arrival times on [t0, t0+duration) with rate `lam` and burstiness `cv`."""
    if lam <= 0:
        return np.zeros(0)
    rng = np.random.default_rng(seed)
    k = 1.0 / cv
    theta = cv / lam            # mean inter-arrival = k*theta = 1/lam
    n_est = int(lam * duration_s * 1.5) + 64
    gaps = rng.gamma(k, theta, size=n_est)
    t = np.cumsum(gaps)
    while t[-1] < duration_s:
        extra = rng.gamma(k, theta, size=n_est)
        t = np.concatenate([t, t[-1] + np.cumsum(extra)])
    return t0 + t[t < duration_s]


def time_varying_trace(
    lam0: float, cv0: float,
    lam1: float, cv1: float,
    pre_s: float, transition_s: float, post_s: float,
    seed: int = 0,
) -> np.ndarray:
    """Evolve Gamma(lam0,cv0) -> Gamma(lam1,cv1) over `transition_s` seconds.

    Generated by sequential inter-arrival sampling with parameters
    interpolated at the current simulation time.
    """
    rng = np.random.default_rng(seed)
    total = pre_s + transition_s + post_s
    times = []
    t = 0.0
    while t < total:
        if t < pre_s:
            frac = 0.0
        elif t < pre_s + transition_s:
            frac = (t - pre_s) / transition_s
        else:
            frac = 1.0
        lam = lam0 + frac * (lam1 - lam0)
        cv = cv0 + frac * (cv1 - cv0)
        k = 1.0 / cv
        theta = cv / lam
        t += float(rng.gamma(k, theta))
        if t < total:
            times.append(t)
    return np.asarray(times)


def rate_ramp_trace(lam0: float, lam1: float, cv: float,
                    pre_s: float, ramp_s: float, post_s: float,
                    seed: int = 0) -> np.ndarray:
    """Fig. 7 / Fig. 10: arrival-rate ramp at constant burstiness."""
    return time_varying_trace(lam0, cv, lam1, cv, pre_s, ramp_s, post_s, seed)


def cv_ramp_trace(lam: float, cv0: float, cv1: float,
                  pre_s: float, ramp_s: float, post_s: float,
                  seed: int = 0) -> np.ndarray:
    """Fig. 11: burstiness change at constant mean rate."""
    return time_varying_trace(lam, cv0, lam, cv1, pre_s, ramp_s, post_s, seed)


def empirical_rate(arrivals: np.ndarray, window_s: float = 1.0,
                   t_end: Optional[float] = None) -> np.ndarray:
    """Windowed arrival rate (for plotting / assertions)."""
    if arrivals.size == 0:
        return np.zeros(0)
    t_end = t_end if t_end is not None else float(arrivals.max())
    edges = np.arange(0.0, t_end + window_s, window_s)
    counts, _ = np.histogram(arrivals, bins=edges)
    return counts / window_s
