"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its
wrapper.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention``. A tensor on the CPU takes the plain version
(:func:`ref.decode_attention_ref`); a CUDA tensor launches the kernel or
raises; under grad it refuses (a decode step is not trained). The
kernel reads the cache in its own ``(B, Smax, KV, D)``
layout, takes ``valid_len`` as a host int (no device-to-host copy),
takes any GQA group, and splits the valid keys across the CTAs of one
thread-block cluster, which combine their partials in distributed
shared memory (:func:`split_plan`): a call is one allocation, the
output, and one launch. Unlike the TPU kernel, ``Smax`` need not be a
multiple of a block.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, meta, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
TILE = 32                     # keys: the chunks are whole 32-key tiles
MAX_SPLITS = 8                # CTAs per cluster: the portable cluster size
HEADS_PER_CTA = 4             # q heads one CTA takes at most
CTAS_PER_SM = 2.5             # the CTAs the plan aims for, per SM

counter = _build.LaunchCounter()
_sms: Dict[int, int] = {}     # SM count, by device index


def split_plan(b: int, kvh: int, n_keys: int, sms: int,
               group: int = 1) -> Tuple[int, int, int]:
    """(splits, chunk, head_groups): the ``group`` q heads of a kv head
    go to ``head_groups`` CTAs of at most HEADS_PER_CTA heads each, and
    each (batch, kv head, head group) cuts its ``n_keys`` valid keys into
    ``splits`` <= MAX_SPLITS chunks of ``chunk`` keys (whole tiles), one
    cluster of ``splits`` CTAs: about ``CTAS_PER_SM`` CTAs per SM,
    rounded down (on the H100 fewer, longer CTAs beat more, shorter ones;
    chip_smoke.py sweeps every cluster size), and no empty chunk."""
    groups = -(-group // HEADS_PER_CTA)
    tiles = max(1, -(-n_keys // TILE))
    want = int(CTAS_PER_SM * sms) // (b * kvh * groups)
    splits = min(MAX_SPLITS, tiles, max(1, want))
    chunk = -(-tiles // splits) * TILE
    return max(1, -(-n_keys // chunk)), chunk, groups


def _sm_count(index: int) -> int:
    n = _sms.get(index)
    if n is None:
        n = _sms.setdefault(index, torch.cuda.get_device_properties(
            index).multi_processor_count)
    return n


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,D); k: (B,Smax,KV,D); v: (B,Smax,KV,Dv) -> (B,1,H,Dv) in
    q's dtype. Slots ``[0, valid_len)`` count, and with ``window > 0``
    only the last ``window`` of them. The kernel takes ``valid_len`` as a
    host int; the plain version also takes a ``(B,)`` tensor. Inside
    :func:`meta.shapes_only`, ``meta`` tensors take the meta branch."""
    if meta.takes(q):
        b, _, h, d = q.shape
        vl = operator.index(valid_len)
        n = min(vl, window) if window > 0 else vl
        out = q.new_empty((b, 1, h, v.shape[3]))
        # the n slots that count are read, once
        meta.add(2 * b * h * n * (d + v.shape[3]), q, out, k[:, :n],
                 v[:, :n])
        return out
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid_len, window=window,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "decode_attention has no backward kernel (nor has the "
            "reference's): a decode step is not trained; training attends "
            "through flash_attention (ROADMAP A8). Call it under "
            "torch.no_grad()")
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
    if h % kvh:
        raise ValueError(f"decode_attention: {h} q heads over {kvh} kv "
                         f"heads")
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
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("decode_attention kernel needs 16-byte-aligned "
                         "q, k and v (16-byte loads)")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lo = max(0, vl - window) if window > 0 else 0
    dev = q.get_device()
    splits, chunk, groups = split_plan(b, kvh, vl - lo, _sm_count(dev),
                                       h // kvh)
    out = torch.empty_like(q) if dv == d else \
        torch.empty((b, 1, h, dv), dtype=q.dtype, device=q.device)
    rc = _build.entry("decode_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dtype, b,
        smax, h, kvh, d, dv, lo, vl, splits, chunk, groups, float(scale),
        _build.stream(dev))
    if rc:
        _build.check(rc, "decode_attention")
    counter.add()
    return out


def max_active_clusters(dtype: torch.dtype, h: int, kvh: int, d: int,
                        dv: int, splits: int, groups: int) -> int:
    """How many clusters of ``splits`` CTAs of this configuration the
    current device holds at once (``cudaOccupancyMaxActiveClusters``);
    raises where the runtime refuses the configuration."""
    n = ctypes.c_int(0)
    rc = _build.entry("decode_attention_max_clusters")(
        KERNEL_DTYPES[dtype], h, kvh, d, dv, splits, groups, ctypes.byref(n))
    _build.check(rc, "decode_attention occupancy query")
    return n.value
