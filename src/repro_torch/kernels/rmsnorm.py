"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``. A tensor on
the CPU takes the plain version (:func:`ref.rmsnorm_ref`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

KERNEL_DTYPES = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
MAX_D = 4096                  # 32 lanes x 32 vectors of 4 per lane

counter = _build.LaunchCounter()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,). ``x * rsqrt(mean(x^2) + eps)`` cast to
    ``x.dtype``, times ``scale`` cast to ``x.dtype``."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    return _launch(x, scale, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    fn = KERNEL_DTYPES.get(x.dtype)
    d = x.shape[-1]
    if fn is None:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not match x (..., {d}) on "
                         f"{x.device}")
    if d % 4 or d > MAX_D:
        raise ValueError(f"rmsnorm kernel needs D a multiple of 4 and at "
                         f"most {MAX_D}, got {d}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")
    scale = scale.to(x.dtype).contiguous()
    # 16-byte (f32) / 8-byte (bf16) vector loads
    if (x.data_ptr() | scale.data_ptr()) % (4 * x.element_size()):
        raise ValueError("rmsnorm kernel needs 4-element-aligned tensors")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    lib = _build.load()
    rc = getattr(lib, fn)(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          rows, d, float(eps),
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    counter.add()
    return out
