"""Building blocks of the served models, as ``init_<layer>`` /
``<layer>(params, cfg, x, ...)`` pairs over plain parameter dicts.

The parts of the reference's ``repro/models/layers.py`` that the served
cascade runs: RMSNorm, RoPE, cache-free GQA self-attention (with
``qkv_bias`` and the structural sliding window), the SwiGLU / GELU MLP,
and the xLSTM mLSTM (chunkwise) and sLSTM (sequential) cells. Parameter
names, shapes and layouts are the reference's, so a JAX parameter tree
converts one to one (:mod:`repro_torch.convert`). Norms and attention go
through :mod:`repro_torch.kernels.ops`; the cells are plain torch (the
reference has no Pallas kernel for them either).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
                device: torch.device,
                scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(cfg: ArchConfig, device: torch.device,
                 d: Optional[int] = None) -> Params:
    return {"scale": torch.ones(d or cfg.d_model, dtype=cfg.pdtype,
                                device=device)}


def rmsnorm(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    ang = positions[..., :, None].float() * inv              # (..., s, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention (no KV cache: the decode slice adds it)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   device: torch.device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {
        "wq": _dense_init(gen, (d, h, hd), cfg.pdtype, device),
        "wk": _dense_init(gen, (d, kv, hd), cfg.pdtype, device),
        "wv": _dense_init(gen, (d, kv, hd), cfg.pdtype, device),
        "wo": _dense_init(gen, (h, hd, d), cfg.pdtype, device,
                          scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=cfg.pdtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=cfg.pdtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=cfg.pdtype, device=device)
    return p


def attention(params: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, kind: str = "causal") -> torch.Tensor:
    """Self-attention over x (B,S,d). ``kind`` describes the mask
    structurally ("causal" | "full") so no S^2 mask is materialized; the
    config's sliding window applies to the causal kind."""
    cd = cfg.cdtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cd))
    if "bq" in params:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, None, cd, kind=kind,
                        window=cfg.sliding_window)          # (B,S,H,hd)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             device: torch.device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "wu": _dense_init(gen, (d, f), cfg.pdtype, device),
        "wd": _dense_init(gen, (f, d), cfg.pdtype, device),
    }
    if cfg.act == "swiglu":
        p["wg"] = _dense_init(gen, (d, f), cfg.pdtype, device)
    return p


def mlp(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.cdtype
    u = torch.einsum("bsd,df->bsf", x, params["wu"].to(cd))
    if "wg" in params:  # swiglu
        g = torch.einsum("bsd,df->bsf", x, params["wg"].to(cd))
        h = F.silu(g) * u
    else:               # non-gated gelu (jax.nn.gelu's tanh form)
        h = F.gelu(u, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["wd"].to(cd))


# ---------------------------------------------------------------------------
# xLSTM cells
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Params:
    d = cfg.d_model
    d_in = d * cfg.xlstm_expand
    h = cfg.num_heads
    return {
        "up": _dense_init(gen, (d, 2 * d_in), cfg.pdtype, device),
        "mq": _dense_init(gen, (d_in, d_in), cfg.pdtype, device),
        "mk": _dense_init(gen, (d_in, d_in), cfg.pdtype, device),
        "mv": _dense_init(gen, (d_in, d_in), cfg.pdtype, device),
        "w_i": _dense_init(gen, (d_in, h), cfg.pdtype, device),
        "w_f": _dense_init(gen, (d_in, h), cfg.pdtype, device),
        "b_i": torch.zeros(h, dtype=cfg.pdtype, device=device),
        "b_f": torch.full((h,), 3.0, dtype=cfg.pdtype, device=device),
        # per-head group norm on the cell output
        "out_norm": torch.ones(d_in, dtype=cfg.pdtype, device=device),
        "down": _dense_init(gen, (d_in, d), cfg.pdtype, device),
    }


def mlstm_block(params: Params, cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """mLSTM matrix-memory cell, chunkwise parallel, with the reference's
    log-space stabilizer (see ``repro/models/layers.py:mlstm_block``):
    weights exp(F_t - F_s + i~_s) are divided by exp(m_t) with
    m_t = F_t + G_t, G_t = max(m_prev, cummax_{s<=t}(i~_s - F_s)); the
    carried (C, n, m) triple makes the recursion exact across chunks.
    """
    b, s, d = x.shape
    h = cfg.num_heads
    d_in = d * cfg.xlstm_expand
    dh = d_in // h
    cd = cfg.cdtype

    xu, z = torch.einsum("bsd,de->bse", x,
                         params["up"].to(cd)).chunk(2, dim=-1)
    q = torch.einsum("bse,ef->bsf", xu, params["mq"].to(cd))
    k = torch.einsum("bse,ef->bsf", xu, params["mk"].to(cd))
    v = torch.einsum("bse,ef->bsf", xu, params["mv"].to(cd))
    q = q.reshape(b, s, h, dh).float() / math.sqrt(dh)
    k = k.reshape(b, s, h, dh).float()
    v = v.reshape(b, s, h, dh).float()
    logit_i = (torch.einsum("bse,eh->bsh", xu, params["w_i"].to(cd))
               + params["b_i"].to(cd)).float()
    logit_f = (torch.einsum("bse,eh->bsh", xu, params["w_f"].to(cd))
               + params["b_f"].to(cd)).float()
    log_f = F.logsigmoid(logit_f)                      # (B,S,H), <= 0

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk != 0:
        chunk = s
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))

    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    m_prev = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        qq, kk, vv = q[:, c0:c0 + chunk], k[:, c0:c0 + chunk], \
            v[:, c0:c0 + chunk]
        lf, li = log_f[:, c0:c0 + chunk], logit_i[:, c0:c0 + chunk]
        Fc = torch.cumsum(lf, dim=1)                       # (B,L,H)
        ss = li - Fc                                       # i~_s - F_s
        G = torch.maximum(m_prev[:, None, :],
                          torch.cummax(ss, dim=1).values)  # (B,L,H)
        m_t = Fc + G
        w_carry = torch.exp(m_prev[:, None, :] - G)        # (B,L,H) <= 1
        y_inter = torch.einsum("blh,bhde,blhe->blhd", w_carry, C, qq)
        n_inter = torch.einsum("blh,bhd,blhd->blh", w_carry, n, qq)
        # mask the EXPONENT (not the exp): for s > t it is unbounded
        # positive and exp would overflow
        expo = (ss[:, None, :, :] - G[:, :, None, :]).masked_fill(
            ~causal[None, :, :, None], -1e30)
        w_rel = torch.exp(torch.clamp(expo, max=0.0))       # (B,L,L,H)
        scores = torch.einsum("blhd,bmhd->blmh", qq, kk) * w_rel
        y_intra = torch.einsum("blmh,bmhd->blhd", scores, vv)
        n_intra = torch.einsum("blmh,bmhd,blhd->blh", w_rel, kk, qq)
        y = y_inter + y_intra
        # clip the exponent so extreme log-forget sums cannot overflow
        floor = torch.exp(torch.clamp(-m_t, -40.0, 40.0))
        denom = torch.maximum((n_inter + n_intra).abs(), floor)
        ys.append(y / denom[..., None])
        # carry to the chunk end (t = L): stabilized weights at G_L
        G_L = G[:, -1]                                     # (B,H)
        w_end = torch.exp(ss - G_L[:, None, :])            # (B,L,H)
        cf = torch.exp(m_prev - G_L)                       # (B,H)
        C = C * cf[:, :, None, None] + torch.einsum(
            "blh,blhd,blhe->bhde", w_end, vv, kk)
        n = n * cf[:, :, None] + torch.einsum("blh,blhd->bhd", w_end, kk)
        m_prev = Fc[:, -1] + G_L
    y = torch.cat(ys, dim=1)                               # (B,S,H,dh)
    # per-head group norm
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6)
    y = y.reshape(b, s, d_in).to(cd) * params["out_norm"].to(cd)
    y = y * F.silu(z)
    return torch.einsum("bse,ed->bsd", y, params["down"].to(cd))


def init_slstm(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Params:
    d = cfg.d_model
    return {
        "w_x": _dense_init(gen, (d, 4 * d), cfg.pdtype, device),  # z,i,f,o
        "r_h": _dense_init(gen, (d, 4 * d), cfg.pdtype, device,
                           scale=0.5 / math.sqrt(d)),           # recurrent
        "bias": torch.cat([
            torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)
        ]).to(device=device, dtype=cfg.pdtype),
        "proj": _dense_init(gen, (d, d), cfg.pdtype, device),
    }


def slstm_block(params: Params, cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """sLSTM scalar-memory cell with exponential gating and the
    stabilizer state m; a true recurrence through h, stepped in order."""
    b, s, d = x.shape
    cd = cfg.cdtype
    pre = torch.einsum("bsd,de->bse", x, params["w_x"].to(cd)) + \
        params["bias"].to(cd)
    r_h = params["r_h"].to(cd).float()   # h is f32: the product is f32
    h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    n = torch.zeros_like(h)
    m = torch.full((b, d), -1e9, dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        gates = pre[:, t].float() + h @ r_h
        z_t, i_t, f_t, o_t = gates.chunk(4, dim=-1)
        z_t = torch.tanh(z_t)
        o_t = torch.sigmoid(o_t)
        m_new = torch.maximum(f_t + m, i_t)          # log-space stabilizer
        i_s = torch.exp(i_t - m_new)
        f_s = torch.exp(f_t + m - m_new)
        c = f_s * c + i_s * z_t
        n = f_s * n + i_s
        h = o_t * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(cd)
    return torch.einsum("bsd,de->bse", y, params["proj"].to(cd))
