"""Prediction-serving frontend adapters (§3, §7.4, Fig. 13): a copy of
the reference's ``repro.serving.frontends``.

InferLine composes with any serving framework that supports (1) runtime
replica scaling, (2) configurable max batch size, (3) a centralized
batched queue. We model two adapters with deliberately different
per-hop overhead constants, mirroring the paper's finding that TFS
carries extra RPC serialization overhead relative to Clipper.

The real (wall-clock, thread-pool) executor in ``repro_torch.serving.executor``
consumes the same Frontend descriptors: its inter-stage hand-offs delay
a request's queue-ready instant by ``hop_delay_s`` (and the reply hop
adds one more), exactly where the simulation engine charges
``rpc_delay_s`` — so a sim<->real fidelity comparison models the same
network on both backends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Frontend:
    name: str
    rpc_delay_s: float          # per-hop transport + dispatch
    serialization_s: float      # per-query (de)serialization at each hop

    @property
    def hop_delay_s(self) -> float:
        return self.rpc_delay_s + self.serialization_s


FRONTENDS: Dict[str, Frontend] = {
    # Clipper-like: compact binary RPC, low serialization cost.
    "clipper": Frontend("clipper", rpc_delay_s=0.0005, serialization_s=0.0001),
    # TFS-like: protobuf round-trips add measurable serialization (§7.4).
    "tfs": Frontend("tfs", rpc_delay_s=0.0005, serialization_s=0.0009),
}
