"""PyTorch/CUDA port of the InferLine serving path.

A self-contained package beside the JAX reference (``repro``): it
imports torch, numpy and the standard library only. Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels live in :mod:`repro_torch.kernels`.
"""

from repro_torch.device import resolve_device, torch_dtype  # noqa: F401
