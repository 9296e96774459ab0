"""Hardware menu of the port: the reference's TPU/CPU entries plus one
NVIDIA H100.

A copy of the reference's ``HardwareType``, menu and ``get_hardware``;
the planner's ``cheaper_hardware`` arrives with the planner slice. The
TPU figures are the reference's own and describe TPU hardware, not the
port's card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# --- TPU v5e chip constants (the reference's) ----------------------------
PEAK_FLOPS_BF16 = 197e12      # FLOP/s per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_BW = 50e9                 # bytes/s per link

# --- NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet ---------------------
# Dense rates without sparsity, at the full 700 W power limit. The PCIe
# part is slower (756 TFLOP/s bf16, 2.0 TB/s); `nvidia-smi`'s name tells
# the two apart ("H100 80GB HBM3" is the SXM part).
H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_FLOPS_F32 = 67e12   # outside the tensor cores
H100_HBM_BW = 3.35e12

# CPU host core (measured-profile fallback / non-acceleratable stages)
CPU_PEAK_FLOPS = 0.15e12      # effective fp32 FLOP/s for one host core
CPU_MEM_BW = 25e9             # bytes/s effective


@dataclasses.dataclass(frozen=True)
class HardwareType:
    """One entry in the provisioning menu."""

    name: str
    chips: int                 # accelerator chips (0 => CPU)
    peak_flops: float          # FLOP/s aggregate
    mem_bw: float              # bytes/s aggregate (HBM or host DRAM)
    ici_bw: float              # bytes/s per link between chips (0 if n/a)
    cost_per_hr: float         # $/hr, marginal-cost accounting as in §6
    # Fixed per-batch overhead (dispatch + RPC + PCIe/ICI latency floor).
    overhead_s: float

    @property
    def cost_per_s(self) -> float:
        return self.cost_per_hr / 3600.0

    def is_accelerator(self) -> bool:
        return self.chips > 0


# Menu ordered by descending capability; BestHardware == first entry.
HARDWARE_MENU: Tuple[HardwareType, ...] = (
    HardwareType("tpu-v5e-16", 16, 16 * PEAK_FLOPS_BF16, 16 * HBM_BW,
                 ICI_BW, cost_per_hr=16 * 1.20, overhead_s=0.0022),
    HardwareType("tpu-v5e-8", 8, 8 * PEAK_FLOPS_BF16, 8 * HBM_BW, ICI_BW,
                 cost_per_hr=8 * 1.20, overhead_s=0.0018),
    # cost_per_hr and overhead_s have no source in the repo: NaN and 0
    # are placeholders that the planner slice replaces (it is the only
    # reader of either; the served path profiles the card by measurement)
    HardwareType("h100-1", 1, H100_PEAK_FLOPS_BF16, H100_HBM_BW, 0.0,
                 cost_per_hr=float("nan"), overhead_s=0.0),
    HardwareType("tpu-v5e-4", 4, 4 * PEAK_FLOPS_BF16, 4 * HBM_BW, ICI_BW,
                 cost_per_hr=4 * 1.20, overhead_s=0.0015),
    HardwareType("tpu-v5e-1", 1, PEAK_FLOPS_BF16, HBM_BW, 0.0,
                 cost_per_hr=1.20, overhead_s=0.0012),
    HardwareType("cpu-1", 0, CPU_PEAK_FLOPS, CPU_MEM_BW, 0.0,
                 cost_per_hr=0.05, overhead_s=0.0005),
)

HARDWARE_BY_NAME: Dict[str, HardwareType] = {h.name: h for h in HARDWARE_MENU}


def get_hardware(name: str) -> HardwareType:
    try:
        return HARDWARE_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; menu: {sorted(HARDWARE_BY_NAME)}"
        ) from None
