"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu``
and its wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``. A tensor on the CPU takes the plain version
(:func:`ref.flash_attention_ref`); a CUDA tensor launches the kernel or
raises. Unlike the TPU kernel there is no block-divisibility rule: the
kernel masks ragged edges itself. Head dims are multiples of 8 (the
kernel copies 16-byte vectors and feeds tensor-core tiles of 8), q/k's
up to 192 and v's up to 128, as MLA's prefill needs (D 192, Dv 128).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QK_HEAD_DIM = 192
MAX_V_HEAD_DIM = 128

counter = _build.LaunchCounter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Sk,KV,D); v: (B,Sk,KV,Dv) -> (B,Sq,H,Dv) in
    q's dtype. The causal diagonal is offset by ``Sk - Sq``; ``window``
    applies with ``causal`` only."""
    if q.is_cuda:
        return _launch(q, k, v, causal, window, scale)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


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
    if d > MAX_QK_HEAD_DIM or dv > MAX_V_HEAD_DIM or d % 8 or dv % 8:
        raise ValueError(f"flash_attention kernel takes head dims that are "
                         f"multiples of 8, D up to {MAX_QK_HEAD_DIM} and Dv "
                         f"up to {MAX_V_HEAD_DIM}, got D={d} Dv={dv}")
    dtype = KERNEL_DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    dev = q.get_device()
    if not (dev == k.get_device() == v.get_device()):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("flash_attention kernel needs 16-byte-aligned "
                         "q, k and v (16-byte copies)")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # empty_like is the cheapest allocation on the host (PERF.md §6)
    out = torch.empty_like(q) if dv == d else q.new_empty((b, sq, h, dv))
    rc = _build.entry("flash_attention_fwd")(
        qp, kp, vp, out.data_ptr(), dtype, b, sq, sk, h, kvh, d, dv,
        int(causal), int(window), float(scale), _build.stream(dev))
    if rc:
        _build.check(rc, "flash_attention")
    counter.add()
    return out
