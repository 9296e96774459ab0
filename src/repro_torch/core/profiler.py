"""Per-model performance profiles (§4.1), measured backend.

A profile captures ``batch latency = f(hardware type, max batch size)`` for
one model. A copy of the reference's ``ModelProfile``, ``ProfileStore``
and ``profile_model_measured``: the port profiles its stages by timing
them on the card. The analytic (roofline) backend arrives with the
planner slice.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

DEFAULT_BATCH_SIZES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclasses.dataclass
class ModelProfile:
    """Measured/derived latency table for one model.

    ``table[(hardware_name, batch)] = seconds to process that batch``.
    """

    model_id: str
    table: Dict[Tuple[str, int], float]
    batch_sizes: Tuple[int, ...] = DEFAULT_BATCH_SIZES

    def hardware_types(self) -> List[str]:
        return sorted({hw for hw, _ in self.table})

    def supports(self, hardware: str) -> bool:
        return any(hw == hardware for hw, _ in self.table)

    def batch_latency(self, hardware: str, batch: int) -> float:
        """Latency for an arbitrary batch size (linear interpolation).

        The queueing system forms batches of any size up to the configured
        maximum, so the simulator needs off-grid points.
        """
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        pts = sorted(b for hw, b in self.table if hw == hardware)
        if not pts:
            raise KeyError(f"{self.model_id}: no profile for {hardware}")
        if batch in pts:
            return self.table[(hardware, batch)]
        if batch < pts[0]:
            return self.table[(hardware, pts[0])] * batch / pts[0]
        if batch > pts[-1]:
            # extrapolate linearly from the last segment
            if len(pts) == 1:
                return self.table[(hardware, pts[0])] * batch / pts[0]
            b0, b1 = pts[-2], pts[-1]
            l0, l1 = self.table[(hardware, b0)], self.table[(hardware, b1)]
            slope = (l1 - l0) / (b1 - b0)
            return l1 + slope * (batch - b1)
        i = bisect.bisect_left(pts, batch)
        b0, b1 = pts[i - 1], pts[i]
        l0, l1 = self.table[(hardware, b0)], self.table[(hardware, b1)]
        frac = (batch - b0) / (b1 - b0)
        return l0 + frac * (l1 - l0)

    def latency_lut(self, hardware: str, max_batch: int) -> np.ndarray:
        """``lut[b]`` = latency of batch b, for b in [0, max_batch]."""
        lut = np.zeros(max_batch + 1, dtype=np.float64)
        for b in range(1, max_batch + 1):
            lut[b] = self.batch_latency(hardware, b)
        return lut

    def throughput(self, hardware: str, batch: int) -> float:
        """Steady-state queries/s of ONE replica at this (hw, max batch)."""
        return batch / self.batch_latency(hardware, batch)

    def max_throughput(self, hardware: str) -> float:
        return max(self.throughput(hardware, b) for b in self.batch_sizes)

    def best_batch(self, hardware: str) -> int:
        return max(self.batch_sizes, key=lambda b: self.throughput(hardware, b))


def profile_model_measured(
    model_id: str,
    run_batch: Callable[[int], None],
    hardware_name: str = "cpu-1",
    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
    repeats: int = 3,
    warmup: int = 1,
) -> ModelProfile:
    """Wall-clock profile of a real callable.

    ``run_batch(b)`` must execute one batch of size ``b`` synchronously:
    a stage on the GPU ends it with ``torch.cuda.synchronize()``, since
    PyTorch returns before the device finishes.
    """
    table: Dict[Tuple[str, int], float] = {}
    for b in batch_sizes:
        for _ in range(warmup):
            run_batch(b)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_batch(b)
            best = min(best, time.perf_counter() - t0)
        table[(hardware_name, b)] = best
    return ModelProfile(model_id, table, batch_sizes)


class ProfileStore:
    """Registry mapping model_id -> ModelProfile (saved & reused, §4.1)."""

    def __init__(self, profiles: Optional[Dict[str, ModelProfile]] = None):
        self._profiles: Dict[str, ModelProfile] = dict(profiles or {})

    def add(self, profile: ModelProfile) -> None:
        self._profiles[profile.model_id] = profile

    def get(self, model_id: str) -> ModelProfile:
        try:
            return self._profiles[model_id]
        except KeyError:
            raise KeyError(
                f"no profile for {model_id!r}; have {sorted(self._profiles)}"
            ) from None

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._profiles

    def model_ids(self) -> List[str]:
        return sorted(self._profiles)
