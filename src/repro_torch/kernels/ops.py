"""Kernel entry points the models call.

A CUDA tensor goes to the hand-written kernel, or the call raises; a CPU
tensor goes to the plain version. There is no switch and no fallback.
The TPU's block-divisibility gate on attention has no counterpart: the
CUDA kernel masks ragged edges itself.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], compute_dtype: torch.dtype,
              kind: Optional[str] = None, window: int = 0) -> torch.Tensor:
    """General attention entry point, q: (B,Sq,H,D), k/v: (B,Sk,KV,D[v]).

    ``kind`` describes the mask structurally: ``"causal"`` or ``"full"``
    go to the flash kernel. An explicit irregular ``mask`` (kind None) is
    served by the plain version on the CPU only.
    """
    if kind == "decode":
        raise NotImplementedError(
            "decode attention (KV cache) arrives with the decode slice")
    q = q.to(compute_dtype).contiguous()
    k = k.to(compute_dtype).contiguous()
    v = v.to(compute_dtype).contiguous()
    if kind in ("causal", "full") and mask is None:
        return flash_attention(q, k, v, causal=(kind == "causal"),
                               window=window)
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"attention with an explicit mask (kind={kind!r}) has no CUDA "
            f"kernel in the port yet")
    return ref.attention_ref(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]))


def mamba_chunk(dt, x, b, c, a, h0):
    raise NotImplementedError(
        "the mamba selective scan arrives with the SSM/hybrid slice")
