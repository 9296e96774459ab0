"""Synthetic arrival-trace generation (§6, "Workload Setup").

Inter-arrival times are sampled from a Gamma distribution parameterized by
mean rate ``lam`` (queries/s) and coefficient of variation ``cv``; the
paper defines CV = sigma^2 / mu^2 over inter-arrival times, so:

  Gamma(shape k, scale theta):  mean = k*theta, var = k*theta^2
  CV = var/mean^2 = 1/k  =>  k = 1/CV, theta = 1/(lam*k)

CV=1 is Poisson; CV=4 is heavily bursty. A copy of the reference's
``gamma_trace``; the time-varying traces arrive with the tuner slice.
"""

from __future__ import annotations

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
