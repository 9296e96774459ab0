"""PyTorch/CUDA port of the InferLine serving path.

A self-contained package beside the JAX reference (``repro``): it
imports torch, numpy and the standard library only. Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels live in :mod:`repro_torch.kernels`.
"""

from repro_torch.device import resolve_device, torch_dtype  # noqa: F401
from repro_torch.faults import FaultSchedule, RecoveryPolicy  # noqa: F401
from repro_torch.serving.cluster import LiveClusterSim, LiveRunResult  # noqa: F401
from repro_torch.serving.executor import PipelineExecutor  # noqa: F401
from repro_torch.serving.frontends import FRONTENDS, Frontend  # noqa: F401
from repro_torch.serving.ingress import AsyncIngress, PayloadRing  # noqa: F401
from repro_torch.serving.loop import LiveControlLoop, LiveLoopResult  # noqa: F401
from repro_torch.serving.stage import (  # noqa: F401
    SEQ,
    ProcessStage,
    ServedStage,
    make_stage,
)
