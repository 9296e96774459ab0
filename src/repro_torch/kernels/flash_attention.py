"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu``
and its wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``. A tensor on the CPU takes the plain version
(:func:`ref.flash_attention_ref`); a CUDA tensor launches the kernel or
raises. Unlike the TPU kernel there is no block-divisibility rule: the
kernel masks ragged edges itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

counter = _build.LaunchCounter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Sk,KV,D); v: (B,Sk,KV,Dv) -> (B,Sq,H,Dv) in
    q's dtype. The causal diagonal is offset by ``Sk - Sq``; ``window``
    applies with ``causal`` only."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int,
            scale: Optional[float]) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D q, k, v")
    b, sq, h, d = q.shape
    _, sk, kvh, dv = v.shape
    if k.shape != (b, sk, kvh, d) or v.shape[0] != b:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if h % kvh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kvh}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got D={d} Dv={dv}")
    dtype = KERNEL_DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lib = _build.load()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dtype,
        b, sq, sk, h, kvh, d, dv, int(causal), int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    counter.add()
    return out
