"""Hardware menu of the port: the reference's TPU/CPU entries plus one
NVIDIA H100.

A copy of the reference's ``HardwareType``, menu, ``get_hardware`` and
``cheaper_hardware`` (the Planner's DowngradeHW options). The TPU
figures are the reference's own and describe TPU hardware, not the
port's card. ``ANALYTIC_MENU`` names the reference's entries, the ones
the analytic profile backend prices; the card is priced by measurement
only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# --- TPU v5e chip constants (the reference's) ----------------------------
PEAK_FLOPS_BF16 = 197e12      # FLOP/s per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_BW = 50e9                 # bytes/s per link
VMEM_BYTES = 128 * 1024**2    # ~128 MiB VMEM per TPU v5e chip
HBM_BYTES = 16 * 1024**3      # 16 GiB of HBM per TPU v5e chip

# --- NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet ---------------------
# Dense rates without sparsity, at the full 700 W power limit. The PCIe
# part is slower (756 TFLOP/s bf16, 2.0 TB/s); `nvidia-smi`'s name tells
# the two apart ("H100 80GB HBM3" is the SXM part).
H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_FLOPS_F32 = 67e12   # outside the tensor cores
H100_PEAK_FLOPS_TF32 = 495e12  # tensor cores, TF32 inputs, f32 accumulate
H100_PEAK_FLOPS_F64 = 34e12   # outside the tensor cores
H100_HBM_BW = 3.35e12
# NVLink 4 within one 8-card HGX node (through NVSwitch): 900 GB/s a card
# in both directions together, NVIDIA's H100 data sheet; 450 GB/s each
# way, the rate one collective's bytes leave a card at. The reference's
# model axis of 16 spans two such nodes, whose link between them
# (InfiniBand, ~50 GB/s a card) is slower: a term over this constant is
# a lower bound there.
H100_NVLINK_BW = 450e9

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
# TPU and CPU prices are the reference's (public v5e on-demand pricing
# shape, $1.20/chip-hr; $0.05/core-hr host CPU).
HARDWARE_MENU: Tuple[HardwareType, ...] = (
    HardwareType("tpu-v5e-16", 16, 16 * PEAK_FLOPS_BF16, 16 * HBM_BW,
                 ICI_BW, cost_per_hr=16 * 1.20, overhead_s=0.0022),
    HardwareType("tpu-v5e-8", 8, 8 * PEAK_FLOPS_BF16, 8 * HBM_BW, ICI_BW,
                 cost_per_hr=8 * 1.20, overhead_s=0.0018),
    # cost_per_hr is an ASSUMPTION, one eighth of an 8-GPU instance's
    # on-demand price: AWS's EC2 on-demand price list gives p5.48xlarge
    # (8 x H100 SXM 80 GB) at $98.32/hr in us-east-1, so $12.29 a card
    # hour. Marginal-cost accounting as for the TPU entries (§6); the
    # Planner compares configurations by it. overhead_s is read only by
    # the analytic profile backend, which refuses to price this card (it
    # is profiled by measurement), so it stays 0.
    HardwareType("h100-1", 1, H100_PEAK_FLOPS_BF16, H100_HBM_BW, 0.0,
                 cost_per_hr=98.32 / 8, overhead_s=0.0),
    HardwareType("tpu-v5e-4", 4, 4 * PEAK_FLOPS_BF16, 4 * HBM_BW, ICI_BW,
                 cost_per_hr=4 * 1.20, overhead_s=0.0015),
    HardwareType("tpu-v5e-1", 1, PEAK_FLOPS_BF16, HBM_BW, 0.0,
                 cost_per_hr=1.20, overhead_s=0.0012),
    HardwareType("cpu-1", 0, CPU_PEAK_FLOPS, CPU_MEM_BW, 0.0,
                 cost_per_hr=0.05, overhead_s=0.0005),
)

HARDWARE_BY_NAME: Dict[str, HardwareType] = {h.name: h for h in HARDWARE_MENU}

# the reference's menu, in its order: what the analytic profile backend
# prices and what the reference's pipeline motifs may list
ANALYTIC_MENU: Tuple[str, ...] = tuple(
    h.name for h in HARDWARE_MENU if h.name != "h100-1")


def get_hardware(name: str) -> HardwareType:
    try:
        return HARDWARE_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; menu: {sorted(HARDWARE_BY_NAME)}"
        ) from None


def cheaper_hardware(name: str) -> Tuple[str, ...]:
    """Hardware strictly cheaper than `name`, most capable first.

    Used by the Planner's DowngradeHW action.
    """
    cur = get_hardware(name)
    return tuple(
        h.name for h in HARDWARE_MENU if h.cost_per_hr < cur.cost_per_hr
    )
