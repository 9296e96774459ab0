"""Plain PyTorch versions of the ported kernels (the CPU path, and what
the kernels are held against on the card).

Counterparts of the reference's jnp oracles, in the same layouts:
q ``(B, Sq, H, D)``, k/v ``(B, Sk, KV, D[v])``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` in f32, cast to ``x.dtype`` BEFORE
    the multiply by ``scale`` (the order the TPU kernel uses)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,KV,D[v]); mask broadcastable to
    (B,H,Sq,Sk) with a unit or absent head dim. Returns (B,Sq,H,Dv).

    f32 softmax in the grouped-GQA layout: q is viewed as (B,Sq,KV,G,D)
    so shared KV heads are never expanded. Rows whose keys are all
    masked give 0.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"q heads {h} not divisible by kv heads {kv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if mask is not None:
        m = mask
        while m.dim() < 4:
            m = m[None]
        if m.shape[1] == h:         # head h = kv_head * g + group index
            m = m.reshape(m.shape[0], kv, g, m.shape[2], m.shape[3])
        elif m.shape[1] == 1:
            m = m[:, :, None]
        else:
            raise ValueError(f"mask head dim {m.shape[1]} is not 1 or {h}")
        s = s.masked_fill(~m, float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)           # fully-masked rows
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def causal_mask_ref(sq: int, sk: int, window: int = 0, offset: int = 0,
                    device=None) -> torch.Tensor:
    """(sq, sk) bool: query i sees key j iff j <= i+offset and, with a
    window, i+offset-j < window."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= (qi - kj) < window
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash kernel: the causal diagonal is offset
    by ``sk - sq``; the window applies only with ``causal``."""
    sq, sk = q.shape[1], k.shape[1]
    mask = (causal_mask_ref(sq, sk, window, offset=sk - sq, device=q.device)
            if causal else None)
    return attention_ref(q, k, v, mask, scale)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the decode kernel. q: (B,1,H,D); k,v:
    (B,Smax,KV,D[v]); valid_len: scalar or (B,), the populated cache
    slots (the new token is at index valid_len-1)."""
    smax = k.shape[1]
    vl = torch.as_tensor(valid_len, device=q.device)
    if vl.dim() == 0:
        vl = vl.expand(q.shape[0])
    kj = torch.arange(smax, device=q.device)[None, :]
    mask = kj < vl[:, None]
    if window > 0:
        mask &= (vl[:, None] - 1 - kj) < window
    return attention_ref(q, k, v, mask[:, None, None, :], scale)


def mamba_scan_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the selective-scan kernel. dt, x: (B,L,D); b, c:
    (B,L,N); a: (D,N); h0: (B,D,N). The sequential f32 recurrence

      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
      y_t = <h_t, C_t>

    Returns (y (B,L,D) in x's dtype, h_last (B,D,N) in h0's dtype)."""
    dtf, xf, bf, cf = dt.float(), x.float(), b.float(), c.float()
    af = a.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dtf[:, t]                                    # (B,D)
        a_bar = torch.exp(dt_t[..., None] * af)             # (B,D,N)
        h = a_bar * h + (dt_t * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1))          # (B,D)
    return torch.stack(ys, dim=1).to(x.dtype), h.to(h0.dtype)
