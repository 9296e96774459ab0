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
    return _attention(q, k, v, mask, scale)[0]


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], scale: Optional[float],
               want_lse: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`attention_ref`, and with ``want_lse`` the f32 logsumexp of
    each row's scaled scores, (B,Sq,H); +inf for a row that sees no key,
    so that ``exp(s - lse)`` is 0 there."""
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
    out = out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if not want_lse:
        return out, None
    lse = torch.logsumexp(s, dim=-1)                        # (B,KV,G,Sq)
    lse = lse.masked_fill(lse == float("-inf"), float("inf"))
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


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
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Plain version of the flash kernel: the causal diagonal is offset
    by ``sk - sq``; the window applies only with ``causal``. With
    ``return_lse`` it returns ``(out, lse)``: lse (B,Sq,H) f32 is each
    row's logsumexp ``m + log(l)`` of the scaled scores (the reference's
    ``xla_flash.py:147-152``), +inf where a row sees no key."""
    sq, sk = q.shape[1], k.shape[1]
    mask = (causal_mask_ref(sq, sk, window, offset=sk - sq, device=q.device)
            if causal else None)
    out, lse = _attention(q, k, v, mask, scale, want_lse=return_lse)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True, window: int = 0,
                            scale: Optional[float] = None,
                            block: int = 256
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the flash backward kernel: the reference's
    ``xla_flash.py:_flash_bwd`` block by block, in f32 and the grouped
    GQA layout. From the forward's ``out`` (in its stored dtype) and lse
    (B,Sq,H), ``P = exp(S - lse)``, ``delta = rowsum(dO * O)``,
    ``dS = P (dP - delta)``; ``dQ = dS K scale``, ``dK = dS^T Q scale``
    and ``dV = P^T dO`` fold a GQA group onto its kv head. Blocks that
    the mask hides from every row are skipped; a row whose lse is +inf
    (it sees no key) adds nothing. Returns (dq, dk, dv) in q's, k's and
    v's dtypes."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    offset = sk - sq
    qf = q.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, sq, kvh, g, dv)
    # (B, KV, G, Sq): the layout of the block scores' rows
    lsef = lse.float().reshape(b, sq, kvh, g).permute(0, 2, 3, 1)
    delta = (dof * out.float().reshape(b, sq, kvh, g, dv)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dvv = torch.zeros_like(vf)
    for q0 in range(0, sq, block):
        q1 = min(sq, q0 + block)
        for k0 in range(0, sk, block):
            k1 = min(sk, k0 + block)
            if causal and (k0 > q1 - 1 + offset or
                           (window > 0 and q0 + offset - (k1 - 1) >= window)):
                continue
            s = torch.einsum("bqkgd,bskd->bkgqs", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            p = torch.exp(s - lsef[..., q0:q1, None])
            if causal:      # the block's mask: its diagonal moves by q0 - k0
                keep = causal_mask_ref(q1 - q0, k1 - k0, window,
                                       offset=offset + q0 - k0,
                                       device=q.device)
                p = torch.where(keep, p, 0.0)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dof[:, q0:q1],
                              vf[:, k0:k1])
            ds = p * (dp - delta[..., q0:q1, None])
            dq[:, q0:q1] += torch.einsum("bkgqs,bskd->bqkgd", ds,
                                         kf[:, k0:k1]) * scale
            dk[:, k0:k1] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                         qf[:, q0:q1]) * scale
            dvv[:, k0:k1] += torch.einsum("bkgqs,bqkgd->bskd", p,
                                          dof[:, q0:q1])
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


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


def mamba_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                       dy: torch.Tensor, dh_last: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the selective scan's backward kernel: the reverse
    recurrence of :func:`mamba_scan_ref`, not autodiff of its loop. The
    states h_0..h_L are rebuilt forwards from ``h0``; then, from
    ``r = dh_last``, each step t from the last down takes the total
    cotangent of its state ``g_t = dy_t C_t + r`` and

      dC_t = sum_d dy_t h_t             dB_t = sum_d g_t (dt_t x_t)
      d(dt_t x_t) = sum_n g_t B_t       dA  += g_t h_{t-1} a_t dt_t
      ddt_t = d(dt_t x_t) x_t + sum_n g_t h_{t-1} a_t A
      dx_t = d(dt_t x_t) dt_t           r = a_t g_t

    with ``a_t = exp(dt_t A)``; ``dh0`` is the last ``r``. dy: (B,L,D),
    dh_last: (B,D,N). Returns (ddt, dx, db, dc, da, dh0), each in its
    input's dtype."""
    dtf, xf, bf, cf = dt.float(), x.float(), b.float(), c.float()
    af, dyf = a.float(), dy.float()
    hs = [h0.float()]
    for t in range(dt.shape[1]):
        a_bar = torch.exp(dtf[:, t, :, None] * af)
        hs.append(a_bar * hs[-1]
                  + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
    ddt, dx = torch.empty_like(dtf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    r = dh_last.float()
    for t in reversed(range(dt.shape[1])):
        a_bar = torch.exp(dtf[:, t, :, None] * af)             # (B,D,N)
        g = dyf[:, t, :, None] * cf[:, t, None, :] + r
        dc[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        db[:, t] = (g * (dtf[:, t] * xf[:, t])[..., None]).sum(1)
        dbx = (g * bf[:, t, None, :]).sum(-1)                  # (B,D)
        ga = g * hs[t] * a_bar
        ddt[:, t] = dbx * xf[:, t] + (ga * af).sum(-1)
        dx[:, t] = dbx * dtf[:, t]
        da += (ga * dtf[:, t, :, None]).sum(0)
        r = a_bar * g
    return (ddt.to(dt.dtype), dx.to(x.dtype), db.to(b.dtype),
            dc.to(c.dtype), da.to(a.dtype), r.to(h0.dtype))
