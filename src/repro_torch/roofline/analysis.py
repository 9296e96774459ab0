"""Roofline terms of a dry-run: the reference's
``repro/roofline/analysis.py`` against one H100's constants.

Three terms per (arch x shape x mesh), in seconds, per device:

  compute    = max(FLOPs, model FLOPs / chips) / peak bf16 FLOP/s
  memory     = max(bytes accessed, analytic floor) / HBM bytes/s
  collective = collective bytes / NVLink bytes/s

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
the collective bytes from the compiled HLO text. The port has no
compiled program: its dry-run counts FLOPs with ``FlopCounterMode``
plus the kernels' own count (:mod:`repro_torch.kernels.meta`), bytes as
the sum of each operation's inputs and outputs, and collective bytes
from the counter :mod:`repro_torch.models.parallel` keeps for every
collective it issues (kind, group size, bytes of the output). All are
one rank's, as the reference's are one device's.

Constants (``repro_torch.core.hardware``): 989 TFLOP/s bf16, 3.35 TB/s
HBM, 450 GB/s NVLink 4 each way within an 8-card node. The reference's
``model`` axis of 16 spans two such nodes, so its collective term over
NVLink is a lower bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.hardware import (
    H100_HBM_BW,
    H100_NVLINK_BW,
    H100_PEAK_FLOPS_BF16,
)

PEAK_FLOPS = H100_PEAK_FLOPS_BF16
HBM_BW = H100_HBM_BW
LINK_BW = H100_NVLINK_BW
HBM_BYTES = 80e9              # one H100 SXM's device memory


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # PER-DEVICE values (one rank's program), as the reference's
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives_by_kind: Dict[str, int]
    model_flops: float                    # TOTAL 6*N*D (train) / 2*N*D (serve)
    peak_mem_per_device: Optional[float] = None
    analytic_bytes: Optional[float] = None

    @property
    def t_compute(self) -> float:
        floor = self.model_flops / self.chips
        return max(self.hlo_flops, floor) / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        floor = self.analytic_bytes or 0.0
        return max(self.hlo_bytes, floor) / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def total_hlo_flops(self) -> float:
        return self.hlo_flops * self.chips

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total FLOPs counted: below 1 with remat's
        recompute and the attention FLOPs the 6 N D model leaves out."""
        total = self.total_hlo_flops
        return self.model_flops / total if total else 0.0

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_json(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "total_hlo_flops": self.total_hlo_flops,
            "collective_bytes": self.collective_bytes,
            "collectives_by_kind": self.collectives_by_kind,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_mem_per_device": self.peak_mem_per_device,
            "analytic_bytes": self.analytic_bytes,
        }


def model_flops_estimate(n_active: float, tokens: float,
                         kind: str) -> float:
    """6*N*D for training, 2*N*D for inference."""
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def roofline_terms(arch: str, shape: str, mesh: str, chips: int,
                   flops: float, bytes_accessed: float,
                   collectives_by_kind: Dict[str, int],
                   model_flops: float,
                   peak_mem: Optional[float] = None,
                   analytic_bytes: Optional[float] = None
                   ) -> RooflineReport:
    """The report from one rank's counts (the reference takes
    ``cost_analysis()`` and the HLO text in their place)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=float(flops), hlo_bytes=float(bytes_accessed),
        collective_bytes=float(sum(collectives_by_kind.values())),
        collectives_by_kind=dict(collectives_by_kind),
        model_flops=model_flops, peak_mem_per_device=peak_mem,
        analytic_bytes=analytic_bytes)
