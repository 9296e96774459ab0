"""Kernel entry points the models call.

A CUDA tensor goes to the hand-written kernel, or the call raises; a CPU
tensor goes to the plain version. There is no switch and no fallback.
The TPU's block-divisibility gates on attention have no counterpart: the
CUDA kernels mask ragged edges themselves.

Gradients: ``rmsnorm`` and flash attention (``kind`` "causal" or
"full") are differentiable on both devices, through the same routes
with or without grad: the flash backward is a CUDA kernel, the norm's a
closed form in torch. Decode attention and the scan are differentiable
on the CPU only; on CUDA under grad they raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], compute_dtype: torch.dtype,
              kind: Optional[str] = None, window: int = 0,
              valid_len=None) -> torch.Tensor:
    """General attention entry point, q: (B,Sq,H,D), k/v: (B,Sk,KV,D[v]).

    ``kind`` describes the mask structurally: ``"causal"`` or ``"full"``
    go to the flash kernel; ``"decode"`` (one query token against a
    cache whose first ``valid_len`` slots count) goes to the decode
    kernel. An explicit irregular ``mask`` (kind None) is served by the
    plain version on the CPU only.
    """
    q = q.to(compute_dtype).contiguous()
    k = k.to(compute_dtype).contiguous()
    v = v.to(compute_dtype).contiguous()
    if kind == "decode":
        if valid_len is None:
            raise ValueError("decode attention needs valid_len")
        return decode_attention(q, k, v, valid_len, window=window)
    if kind in ("causal", "full") and mask is None:
        return flash_attention(q, k, v, causal=(kind == "causal"),
                               window=window)
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"attention with an explicit mask (kind={kind!r}) has no CUDA "
            f"kernel in the port yet")
    return ref.attention_ref(q, k, v, mask, 1.0 / math.sqrt(q.shape[-1]))


def mamba_chunk(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """One chunk of the Mamba selective scan, one kernel launch on CUDA.

    dt, x: (B,L,D); b, c: (B,L,N); a: (D,N); h0: (B,D,N).
    Returns (y (B,L,D) f32, h_last (B,D,N) f32). The kernel takes
    contiguous inputs: ``b`` and ``c`` are usually the halves of one
    ``(B,L,2N)`` projection, so they are copied here.
    """
    y, h = mamba_scan(dt.contiguous(), x.contiguous(), b.contiguous(),
                      c.contiguous(), a, h0.float().contiguous())
    return y.float(), h
