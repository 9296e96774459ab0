"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
wrapper.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention``. A tensor on the CPU takes the plain version
(:func:`ref.decode_attention_ref`); a CUDA tensor launches the kernel or
raises. The kernel reads the cache in its own ``(B, Smax, KV, D)``
layout, takes ``valid_len`` as a host int (no device-to-host copy) and
splits the valid keys across CTAs (:func:`split_plan`); unlike the TPU
kernel, ``Smax`` need not be a multiple of a block.
"""

from __future__ import annotations

import math
import operator
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16                # q heads per kv head: 4 warps x 4 heads
TILE = 64                     # keys per shared-memory tile of one CTA
CTAS_PER_SM = 2

counter = _build.LaunchCounter()


def split_plan(b: int, kvh: int, n_keys: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): each (batch, kv head) cuts its ``n_keys`` valid
    keys into ``splits`` chunks of ``chunk`` keys (whole tiles), enough
    for about ``CTAS_PER_SM`` CTAs per SM and no empty chunk."""
    tiles = max(1, -(-n_keys // TILE))
    splits = min(tiles, max(1, -(-CTAS_PER_SM * sms // (b * kvh))))
    chunk = -(-tiles // splits) * TILE
    return max(1, -(-n_keys // chunk)), chunk


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,D); k: (B,Smax,KV,D); v: (B,Smax,KV,Dv) -> (B,1,H,Dv) in
    q's dtype. Slots ``[0, valid_len)`` count, and with ``window > 0``
    only the last ``window`` of them. The kernel takes ``valid_len`` as a
    host int; the plain version also takes a ``(B,)`` tensor."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len, window=window,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch(q, k, v, valid_len, window, scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len,
            window: int, scale: Optional[float]) -> torch.Tensor:
    if isinstance(valid_len, torch.Tensor):
        raise TypeError("decode_attention kernel takes valid_len as a host "
                        "int, not a tensor")
    vl = operator.index(valid_len)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention takes 4-D q, k, v")
    b, sq, h, d = q.shape
    _, smax, kvh, dv = v.shape
    if sq != 1 or k.shape != (b, smax, kvh, d) or v.shape[0] != b:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if not 0 <= vl <= smax:
        raise ValueError(f"valid_len {vl} outside [0, {smax}]")
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes up to {MAX_GROUP} "
                         f"q heads per kv head, got {h} over {kvh}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM or d % 8 or dv % 8:
        raise ValueError(f"decode_attention kernel takes head dims that are "
                         f"multiples of 8 up to {MAX_HEAD_DIM}, got D={d} "
                         f"Dv={dv}")
    dtype = KERNEL_DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous q, k, v")
    if (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("decode_attention kernel needs 16-byte-aligned "
                         "k and v (16-byte loads)")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lo = max(0, vl - window) if window > 0 else 0
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, chunk = split_plan(b, kvh, vl - lo, sms)
    g = h // kvh
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=q.device)
    ml = torch.empty((b * kvh * splits * g * 2,), dtype=torch.float32,
                     device=q.device)
    acc = torch.empty((b * kvh * splits * g * dv,), dtype=torch.float32,
                      device=q.device)
    rc = _build.entry("decode_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ml.data_ptr(), acc.data_ptr(), dtype, b, smax, h, kvh, d, dv, lo, vl,
        splits, chunk, float(scale), _build.stream(q.get_device()))
    if rc:
        _build.check(rc, "decode_attention")
    counter.add()
    return out
