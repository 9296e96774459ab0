"""Per-model performance profiles (§4.1).

A profile captures ``batch latency = f(hardware type, max batch size)`` for
one model. A copy of the reference's ``ModelProfile``, ``ProfileStore``
and its two backends:

* **measured** — ``profile_model_measured`` times a real callable; the
  port profiles its served stages this way on the card.
* **analytic** — ``analytic_batch_latency`` / ``profile_model_analytic``,
  the reference's roofline model over a :class:`ModelSpec` (FLOPs,
  weight and activation bytes per query), evaluated on the reference's
  TPU/CPU menu (``hardware.ANALYTIC_MENU``). It prices the pipeline
  motifs of :mod:`repro_torch.configs.pipelines` exactly as the
  reference does. Asked to price ``h100-1`` it raises: the card is
  priced only by measurement.

Profiles are plain tables; the Estimator interpolates them to arbitrary
batch sizes <= the configured maximum.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.hardware import ANALYTIC_MENU, HardwareType, get_hardware

# Sustained MXU efficiency assumed by the analytic backend (fraction of
# peak for dense matmul-dominated inference at moderate batch; the
# reference's TPU assumption).
MXU_EFFICIENCY = 0.55
CPU_EFFICIENCY = 0.30

DEFAULT_BATCH_SIZES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static workload description of one model, per single query.

    A "query" is one inference request at this stage's native input size
    (e.g. one image / one `seq_len`-token text fragment).
    """

    name: str
    flops_per_query: float          # forward-pass FLOPs for batch=1
    weight_bytes: float             # parameter bytes read per batch
    act_bytes_per_query: float      # activation traffic per query
    # Bytes crossing ICI per query on a multi-chip slice (tensor-parallel
    # all-reduces); scaled by (chips-1)/chips at evaluation time.
    collective_bytes_per_query: float = 0.0
    # False for stages with no internal parallelism (paper Fig. 3
    # "preprocess"): they see no batching benefit and cannot use an
    # accelerator's parallel units.
    parallelizable: bool = True


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


# --------------------------------------------------------------------------
# Analytic backend
# --------------------------------------------------------------------------


def analytic_batch_latency(spec: ModelSpec, hw: HardwareType,
                           batch: int) -> float:
    """Roofline latency for one batch on one of the reference's hardware
    types (the reference's formula, operation for operation).

    latency = overhead + max(compute, memory) + collective

    * compute  = batch * flops / (peak * efficiency)
    * memory   = (weights + batch * activations) / bandwidth — weight reads
      amortize across the batch, which is exactly why batching raises
      throughput on accelerators (paper Fig. 3).
    * collective = tensor-parallel ICI traffic on multi-chip slices.

    Non-parallelizable stages run serially: latency scales linearly with
    batch and accelerators confer no benefit. ``h100-1`` raises
    ``ValueError``: the card is priced only by measurement.
    """
    if hw.name not in ANALYTIC_MENU:
        raise ValueError(
            f"the analytic backend prices {ANALYTIC_MENU}, not {hw.name!r}: "
            f"profile it by measurement (profile_model_measured)")
    if not spec.parallelizable:
        # Runs on a single host core whatever the slice; an accelerator
        # confers no benefit and batching only serializes (Fig. 3,
        # "preprocess").
        serial = spec.flops_per_query / (
            get_hardware("cpu-1").peak_flops * CPU_EFFICIENCY
        )
        return hw.overhead_s + batch * serial

    eff = MXU_EFFICIENCY if hw.is_accelerator() else CPU_EFFICIENCY
    compute = batch * spec.flops_per_query / (hw.peak_flops * eff)
    memory = (spec.weight_bytes + batch * spec.act_bytes_per_query) / hw.mem_bw
    lat = hw.overhead_s + max(compute, memory)
    if hw.chips > 1 and hw.ici_bw > 0:
        frac = (hw.chips - 1) / hw.chips
        lat += batch * spec.collective_bytes_per_query * frac / hw.ici_bw
    return lat


def profile_model_analytic(
    spec: ModelSpec,
    hardware_options: Optional[Iterable[str]] = None,
    batch_sizes: Tuple[int, ...] = DEFAULT_BATCH_SIZES,
) -> ModelProfile:
    """The analytic profile of ``spec`` on ``hardware_options`` (default:
    the reference's whole menu, ``ANALYTIC_MENU``)."""
    names = list(hardware_options) if hardware_options is not None else \
        list(ANALYTIC_MENU)
    table: Dict[Tuple[str, int], float] = {}
    for name in names:
        hw = get_hardware(name)
        for b in batch_sizes:
            table[(name, b)] = analytic_batch_latency(spec, hw, b)
    return ModelProfile(spec.name, table, batch_sizes)


# --------------------------------------------------------------------------
# Measured backend
# --------------------------------------------------------------------------


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
