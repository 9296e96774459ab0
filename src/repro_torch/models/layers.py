"""Building blocks of the model zoo, as ``init_<layer>`` /
``<layer>(params, cfg, x, ...)`` pairs over plain parameter dicts.

The counterpart of the reference's ``repro/models/layers.py``: RMSNorm,
RoPE and the encoder's sinusoidal positions, GQA attention (self- or
cross-attention, with ``qkv_bias``, the structural sliding window and
the KV cache of prefill and decode), DeepSeek's MLA (the expanded form
for scoring and prefill, the absorbed form over the latent cache for
decode), the SwiGLU / GELU MLP, the top-k MoE with static capacity and
its switch-style aux loss, the Mamba block (chunked selective scan with
carried state), and the xLSTM mLSTM (chunkwise) and sLSTM (sequential)
cells with their carried state. Parameter
names, shapes and layouts are the reference's, so a JAX parameter tree
converts one to one (:mod:`repro_torch.convert`). Norms, attention and
the selective scan go through :mod:`repro_torch.kernels.ops`; the MoE's
expert products, MLA's absorbed decode and the xLSTM cells are plain
torch (the reference has no Pallas kernel for them either).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]
KV_WEIGHTS = ("wk", "wv", "bk", "bv")


def _dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
                device: torch.device,
                scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: an expert stack of DeepSeek-V3 is 15 GB in f32
    return torch.randn(shape, generator=gen, device=device).mul_(
        scale).to(dtype)


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


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32: sin of each position times the d/2 frequencies,
    then cos (the encoder's absolute positions)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    ang = pos * (1.0 / (10000.0 ** exps))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# One rank's collectives
# ---------------------------------------------------------------------------

class Local:
    """The collectives of a single rank, every one the identity.

    :func:`attention`, :func:`mlp`, :func:`moe` and the model's layer
    loop take one as ``par``; under a mesh it is a
    :class:`repro_torch.models.parallel.Parallel`, whose methods issue
    the collectives over the mesh's groups. A layer reads from its
    weights' local shapes which dimension is split over ``model`` (fewer
    query heads than ``cfg.num_heads``, a narrower FFN hidden, fewer
    experts), and only then asks ``par`` for the all-reduce that makes
    a partial output whole."""

    model_rank = 0

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: identity forward, all-reduce backward."""
        return x

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: all-reduce forward, identity backward."""
        return x

    def layer(self, p: Params, spec) -> Params:
        """One layer's weights for use (FSDP's all-gather)."""
        return p

    def cache_slots(self, slots: int) -> Tuple[int, int, int]:
        """(first slot, slots, slots in all) of this rank's slice of a
        cache's sequence."""
        return 0, slots, slots

    def moe_rows(self, x: torch.Tensor, groups: int
                 ) -> Tuple[torch.Tensor, int]:
        """The rows a MoE routes, and its routing groups among them."""
        return x, groups

    def moe_own(self, out: torch.Tensor, aux: torch.Tensor, b: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``b`` rows of a MoE's output, and its aux."""
        return out, aux


LOCAL = Local()


# ---------------------------------------------------------------------------
# GQA self-attention
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


def init_cross_attention(gen: torch.Generator, cfg: ArchConfig,
                         device: torch.device) -> Params:
    return init_attention(gen, cfg, device)


def _kv_heads(cfg: ArchConfig, hl: int, rank: int) -> slice:
    """The KV heads that the ``hl`` query heads of model rank ``rank``
    attend with, when every rank computes all KV heads."""
    g = cfg.num_heads // cfg.num_kv_heads
    h0 = rank * hl
    if hl % g == 0:
        return slice(h0 // g, h0 // g + hl // g)
    if g % hl == 0:
        return slice(h0 // g, h0 // g + 1)
    raise NotImplementedError(
        f"{cfg.name}: {hl} query heads a rank in groups of {g}")


def _write_prompt(cfg: ArchConfig, ck: torch.Tensor, cv: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, lo: int,
                  smax: int) -> None:
    """A prompt's k/v into the cache's slots from ``lo`` on, of ``smax``
    in all: token t at slot t, or, for a sliding-window ring shorter
    than the prompt, the last ``smax`` tokens at slot ``t % smax``."""
    n, s = ck.shape[1], k.shape[1]
    if smax >= s:
        cnt = max(0, min(lo + n, s) - lo)
        ck[:, :cnt] = k[:, lo:lo + cnt].to(ck.dtype)
        cv[:, :cnt] = v[:, lo:lo + cnt].to(cv.dtype)
        return
    if cfg.sliding_window <= 0:
        raise ValueError(
            f"full-attention cache too small: smax={smax} < prompt length "
            f"{s} (did you forget the modality prefix when sizing the "
            f"cache?)")
    slot = torch.arange(lo, lo + n, device=ck.device)
    tok = s - 1 - (s - 1 - slot) % smax          # the last token at a slot
    ck[:, :n] = k[:, tok].to(ck.dtype)
    cv[:, :n] = v[:, tok].to(cv.dtype)


def attention(params: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, kind: str = "causal",
              cache: Optional[Params] = None,
              cache_pos: Optional[int] = None, par: Local = LOCAL,
              kv_x: Optional[torch.Tensor] = None, use_rope: bool = True
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention over x (B,S,d), or cross-attention from x over
    ``kv_x`` (B,Sk,d): no RoPE and no window on cross-attention; without
    ``use_rope`` self-attention takes no RoPE either. Returns (output,
    cache or None).

    ``kind`` describes the mask structurally ("causal" | "full") so no
    S^2 mask is materialized; the config's sliding window applies to
    self-attention. With ``cache`` (dict k, v of (B,Smax,KV,hd)):

    * ``cache_pos`` None (prefill): the fresh k/v are written at slot 0,
      or, for a sliding-window cache shorter than the prompt, the last
      Smax of them into ring slots ``arange(s - Smax, s) % Smax``;
      attention runs over the fresh k/v.
    * ``cache_pos`` an int (decode one token at that position): the new
      k/v go to slot ``cache_pos % Smax`` of a sliding-window ring, else
      to ``cache_pos`` clamped to ``Smax - 1`` (the reference's
      ``dynamic_update_slice`` clamps so); the token attends over the
      first ``min(cache_pos + 1, Smax)`` slots with no structural
      window, since the ring already holds only the window.

    The cache is written in place: ``cache``'s tensors are views into the
    segment's stacked ``(repeat, B, Smax, KV, hd)`` tensors, so no step
    copies the cache (the reference's functional update returns a new
    one). The returned cache is ``cache`` itself.

    Under a mesh the query heads are this rank's when ``wq`` holds fewer
    than ``cfg.num_heads``, and ``wo``'s partial output is all-reduced.
    KV heads that do not divide ``model`` stay whole: every rank computes
    all of them and attends with its own query heads' ones, and the
    cache holds this rank's slice of the sequence (``par.cache_slots``);
    a decode step over a split sequence combines the slices' partial
    softmaxes (``par.split_decode``).
    """
    cd = cfg.cdtype
    hl = params["wq"].shape[1]
    heads_tp = hl < cfg.num_heads
    kv_whole = heads_tp and params["wk"].shape[1] == cfg.num_kv_heads
    if heads_tp:
        x = par.to_model(x)

    def w(name: str) -> torch.Tensor:
        t = params[name].to(cd)
        # a replicated KV weight that this rank uses in part
        return par.to_model(t) if kv_whole and name in KV_WEIGHTS else t

    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, w("wq"))
    k = torch.einsum("bsd,dhk->bshk", src, w("wk"))
    v = torch.einsum("bsd,dhk->bshk", src, w("wv"))
    if "bq" in params:
        q, k, v = q + w("bq"), k + w("bk"), v + w("bv")
    if use_rope and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    heads = _kv_heads(cfg, hl, par.model_rank) if kv_whole else slice(None)

    window = cfg.sliding_window if kv_x is None else 0
    valid_len = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        lo, n, smax = par.cache_slots(ck.shape[1])
        if cache_pos is None:
            _write_prompt(cfg, ck, cv, k, v, lo, smax)
        else:
            slot = cache_pos % smax if cfg.sliding_window > 0 \
                else min(cache_pos, smax - 1)
            if lo <= slot < lo + n:
                ck[:, slot - lo] = k[:, 0].to(ck.dtype)
                cv[:, slot - lo] = v[:, 0].to(cv.dtype)
            k, v = ck, cv
            valid_len = min(cache_pos + 1, smax)
            kind, window = "decode", 0
            if n != smax:                       # the sequence is split
                out = par.split_decode(q, ck, cv, lo, valid_len, heads,
                                       heads_tp, cd)
                out = torch.einsum("bshk,hkd->bsd", out, w("wo"))
                return (par.from_model(out) if heads_tp else out), cache
    out = ops.attention(q, k[:, :, heads], v[:, :, heads], None, cd,
                        kind=kind, window=window,
                        valid_len=valid_len)                # (B,S,H,hd)
    out = torch.einsum("bshk,hkd->bsd", out, w("wo"))
    return (par.from_model(out) if heads_tp else out), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed-latent KV attention
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig,
             device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    pd = cfg.pdtype
    return {
        "wq_a": _dense_init(gen, (d, qr), pd, device),
        "q_norm": torch.ones(qr, dtype=pd, device=device),
        "wq_b": _dense_init(gen, (qr, h, nope + rope_d), pd, device),
        "wkv_a": _dense_init(gen, (d, kr + rope_d), pd, device),
        "kv_norm": torch.ones(kr, dtype=pd, device=device),
        "wkv_b_k": _dense_init(gen, (kr, h, nope), pd, device),
        "wkv_b_v": _dense_init(gen, (kr, h, vd), pd, device),
        "wo": _dense_init(gen, (h, vd, d), pd, device,
                          scale=1.0 / math.sqrt(h * vd)),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The latent norms of MLA, plain as in the reference: f32 statistics,
    cast back before the scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _mla_qc(params: Params, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor, par: Local = LOCAL):
    """MLA's shared projections: per-head q (no-RoPE part, RoPE'd part)
    and the latent kv (c_kv, and the one RoPE'd key all heads share).
    ``par.to_model`` goes on the three latents, which every model rank
    computes whole and uses for its own heads."""
    cd = cfg.cdtype
    nope, kr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_lat = torch.einsum("bsd,dr->bsr", x, params["wq_a"].to(cd))
    q_lat = par.to_model(_rms(q_lat, params["q_norm"].to(cd), cfg.norm_eps))
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"].to(cd))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"].to(cd))
    c_kv, k_rope = kv[..., :kr], kv[..., kr:]
    c_kv = par.to_model(_rms(c_kv, params["kv_norm"].to(cd), cfg.norm_eps))
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, par.to_model(k_rope[..., 0, :])


def mla_attention(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, kind: str = "causal",
                  cache: Optional[Params] = None,
                  cache_pos: Optional[int] = None, par: Local = LOCAL
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head latent attention over x (B,S,d). Returns (output,
    cache or None).

    Scoring and prefill take the expanded form: the latent becomes
    per-head K (the no-RoPE part, then the RoPE'd key all heads share)
    of ``qk_nope + qk_rope`` dims and V of ``v_head_dim``, and attention
    runs through :func:`ops.attention` (on CUDA the flash kernel, at
    D 192 and Dv 128 for DeepSeek-V3). With ``cache`` (dict c_kv
    (B,Smax,kv_lora), k_rope (B,Smax,qk_rope)) and ``cache_pos`` None,
    the prompt's latents are written at slot 0.

    With ``cache_pos`` an int, a decode step in the absorbed form: the
    new latents go to slot ``cache_pos`` clamped to ``Smax - S`` (the
    reference's ``dynamic_update_slice`` clamps so), ``W_UK`` is folded
    into q, and scores, softmax and ``W_UV`` run over the latent cache's
    slots ``<= cache_pos``, never expanding per-head K/V. Plain torch,
    as the reference's is plain jnp. The cache is written in place, as
    :func:`attention`'s is, and returned.

    Under a mesh the heads are this rank's when ``wq_b`` holds fewer
    than ``cfg.num_heads`` (``wq_b``, ``wkv_b_k``, ``wkv_b_v`` over
    heads); ``wq_a`` and ``wkv_a`` are replicated, so every rank
    computes the whole latents and, in decode, attends with its heads
    over its whole copy of the latent cache; ``wo``'s partial output is
    all-reduced."""
    cd = cfg.cdtype
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    heads_tp = params["wq_b"].shape[1] < cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qc(params, cfg, x, positions,
                                           par if heads_tp else LOCAL)

    def proj_out(out: torch.Tensor) -> torch.Tensor:
        out = torch.einsum("bshv,hvd->bsd", out, params["wo"].to(cd))
        return par.from_model(out) if heads_tp else out

    if cache is not None and cache_pos is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        smax, s = cc.shape[1], x.shape[1]
        slot = max(0, min(cache_pos, smax - s))
        cc[:, slot:slot + s] = c_kv.to(cc.dtype)
        cr[:, slot:slot + s] = k_rope.to(cr.dtype)
        ccf, crf = cc.to(cd), cr.to(cd)
        # absorb W_UK into q: (B,S,H,nope) x (kr,H,nope) -> (B,S,H,kr)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope,
                             params["wkv_b_k"].to(cd))
        scores = (torch.einsum("bshr,btr->bhst", q_abs, ccf)
                  + torch.einsum("bshr,btr->bhst", q_rope, crf)) * scale
        valid = torch.arange(smax, device=x.device) <= cache_pos
        scores = scores.masked_fill(~valid, float("-inf"))
        w = torch.softmax(scores.float(), dim=-1).to(cd)
        out_lat = torch.einsum("bhst,btr->bshr", w, ccf)
        return proj_out(torch.einsum("bshr,rhv->bshv", out_lat,
                                     params["wkv_b_v"].to(cd))), cache

    k_nope = torch.einsum("btr,rhn->bthn", c_kv, params["wkv_b_k"].to(cd))
    v = torch.einsum("btr,rhv->bthv", c_kv, params["wkv_b_v"].to(cd))
    k_rope_b = k_rope[:, :, None, :].expand(*k_nope.shape[:3],
                                            k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    out = ops.attention(q, k, v, None, cd, kind=kind)
    if cache is not None:
        s, smax = c_kv.shape[1], cache["c_kv"].shape[1]
        if s > smax:
            raise ValueError(f"MLA cache too small: smax={smax} < prompt "
                             f"length {s}")
        cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :s] = k_rope.to(cache["k_rope"].dtype)
    return proj_out(out), cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig, device: torch.device,
             d_ff: Optional[int] = None,
             gated: Optional[bool] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = (cfg.act == "swiglu") if gated is None else gated
    p = {
        "wu": _dense_init(gen, (d, f), cfg.pdtype, device),
        "wd": _dense_init(gen, (f, d), cfg.pdtype, device),
    }
    if gated:
        p["wg"] = _dense_init(gen, (d, f), cfg.pdtype, device)
    return p


def mlp(params: Params, cfg: ArchConfig, x: torch.Tensor,
        par: Local = LOCAL, d_ff: Optional[int] = None) -> torch.Tensor:
    """The SwiGLU or GELU MLP of hidden ``d_ff`` (default
    ``cfg.d_ff``). Under a mesh, ``wg``/``wu`` narrower than it are
    column-parallel, ``wd`` row-parallel and its output all-reduced."""
    cd = cfg.cdtype
    tp = params["wu"].shape[-1] < (d_ff or cfg.d_ff)
    if tp:
        x = par.to_model(x)
    u = torch.einsum("bsd,df->bsf", x, params["wu"].to(cd))
    if "wg" in params:  # swiglu
        g = torch.einsum("bsd,df->bsf", x, params["wg"].to(cd))
        h = F.silu(g) * u
    else:               # non-gated gelu (jax.nn.gelu's tanh form)
        h = F.gelu(u, approximate="tanh")
    out = torch.einsum("bsf,fd->bsd", h, params["wd"].to(cd))
    return par.from_model(out) if tp else out


# ---------------------------------------------------------------------------
# MoE: top-k routed experts with static capacity
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ArchConfig,
             device: torch.device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": _dense_init(gen, (d, e), torch.float32, device),  # f32
        "wg": _dense_init(gen, (e, d, f), cfg.pdtype, device),
        "wu": _dense_init(gen, (e, d, f), cfg.pdtype, device),
        "wd": _dense_init(gen, (e, f, d), cfg.pdtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device, gated=True,
                               d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Slots an expert holds for a group of ``t`` tokens:
    ``ceil(t k / E * capacity_factor)``, and at least ``t`` when
    ``t <= 64`` (an expert takes a token at most once, so that floor
    makes small groups, decode steps among them, drop-free). A host int
    from shapes alone: routing reads no device value, so a forward
    stays one CUDA graph."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    capacity = max(1, int(math.ceil(t * k / e * cfg.capacity_factor)))
    return max(capacity, t) if t <= 64 else capacity


def _moe_tokens(params: Params, cfg: ArchConfig, xt: torch.Tensor,
                par: Local = LOCAL) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one token group (t, d) through the experts; returns (out
    (t, d), aux). The reference's sort-based dispatch: f32 router,
    softmax top-k renormalised, each assignment's slot in its expert from
    a stable argsort of the expert ids, the assignments past an expert's
    capacity dropped, the kept ones gathered into an ``(E, C, D)``
    buffer, the experts' SwiGLU as batched products, and the outputs
    combined with the routing weights. Under a mesh whose ``model`` axis
    splits the experts, this rank's ``E / model`` run: the assignments
    to other ranks' experts are masked out, and ``out`` is this rank's
    partial sum."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cd, dev = cfg.cdtype, xt.device

    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)                  # (t,k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(-1)                                   # (t*k,)
    # the switch-style load-balance loss; counts by index_add, which
    # (unlike bincount) reads no device value
    counts = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(t * k, dtype=torch.float32, device=dev))
    aux = e * torch.sum(probs.mean(dim=0) * (counts / (t * k))) \
        * cfg.router_aux_weight

    capacity = moe_capacity(cfg, t)
    # slot of each assignment within its expert (stable sort)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos < capacity
    el = params["wg"].shape[0]                   # this rank's experts
    e0 = 0
    if el < e:
        e0 = par.model_rank * el
        keep = keep & (flat_e >= e0) & (flat_e < e0 + el)
        # the router's inputs and outputs, used here in part
        xt, top_w = par.to_model(xt), par.to_model(top_w)

    # the kept assignments into (E, C, D); a dropped one adds zeros to
    # the last slot, as the reference's scatter does, so every slot's
    # sum is exact in any order
    tok_idx = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    src = torch.where(keep[:, None], xt[tok_idx].to(cd), 0.0)
    slot = torch.where(keep, (flat_e - e0) * capacity + pos,
                       el * capacity - 1)
    buf = torch.zeros((el * capacity, d), dtype=cd, device=dev).index_add_(
        0, slot, src).view(el, capacity, d)

    g = torch.einsum("ecd,edf->ecf", buf, params["wg"].to(cd))
    u = torch.einsum("ecd,edf->ecf", buf, params["wu"].to(cd))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, params["wd"].to(cd))

    # gather back; the k outputs of a token sit side by side
    out_tk = torch.where(keep[:, None], y.reshape(el * capacity, d)[slot],
                         0.0)
    w = top_w.reshape(-1).to(cd)
    out = (out_tk * w[:, None]).view(t, k, d).sum(dim=1)
    return out, aux.float()


def moe(params: Params, cfg: ArchConfig, x: torch.Tensor,
        par: Local = LOCAL) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with static capacity, plus the shared
    expert; returns (out, aux).

    With ``cfg.moe_groups > 1`` and the tokens dividing into that many
    groups, each group routes on its own (group-limited capacity) and
    the aux is the mean over groups. The reference vmaps or maps the
    groups by the size of the expert hidden; both compute this, so the
    groups go in a loop, which keeps one group's buffers live. Under a
    mesh, ``par.moe_rows`` says which rows route in which groups (a
    data rank's own, or every data rank's gathered), the experts'
    partial sums are all-reduced over ``model``, and ``par.moe_own``
    keeps this rank's rows."""
    b, s, d = x.shape
    x, g = par.moe_rows(x, cfg.moe_groups)
    t = x.shape[0] * s
    xt = x.reshape(t, d)
    if g > 1 and t % g == 0:
        outs, auxes = zip(*(_moe_tokens(params, cfg, xg, par)
                            for xg in xt.view(g, t // g, d)))
        out, aux = torch.cat(outs), torch.stack(auxes).mean()
    else:
        out, aux = _moe_tokens(params, cfg, xt, par)
    if params["wg"].shape[0] < cfg.num_experts:
        out = par.from_model(out)
    if "shared" in params:
        out = out + mlp(params["shared"], cfg, xt[None], par,
                        cfg.moe_d_ff * cfg.num_shared_experts).reshape(t, d)
    return par.moe_own(out.view(-1, s, d), aux, b)


# ---------------------------------------------------------------------------
# Mamba selective SSM block (chunked scan)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> Params:
    d = cfg.d_model
    d_in = d * cfg.mamba_expand
    st, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    a_log = torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                   device=device)).expand(d_in, st)
    return {
        "in_proj": _dense_init(gen, (d, 2 * d_in), cfg.pdtype, device),
        "conv_w": _dense_init(gen, (dc, d_in), cfg.pdtype, device,
                              scale=0.5),
        "w_bc": _dense_init(gen, (d_in, 2 * st), cfg.pdtype, device),
        "w_dt": torch.full((d_in,), 0.1, dtype=cfg.pdtype, device=device),
        "b_dt": torch.full((d_in,), -2.0, dtype=cfg.pdtype,
                           device=device),     # softplus(-2) ~ 0.12
        "a_log": a_log.to(cfg.pdtype).contiguous(),
        "d_skip": torch.ones(d_in, dtype=cfg.pdtype, device=device),
        "out_proj": _dense_init(gen, (d_in, d), cfg.pdtype, device),
    }


def mamba_block(params: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Params] = None,
                par: Local = LOCAL) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D). Chunk-streamed as the reference's
    ``mamba_block``: per chunk of ``min(cfg.ssm_chunk, S)`` tokens (one
    chunk when S is not a multiple), the in-projection, the depthwise
    causal conv over the carried tail, softplus dt, the selective scan
    (:func:`ops.mamba_chunk`, one kernel launch on CUDA), the skip,
    the gate and the out-projection; the SSM state and the conv tail
    carry from chunk to chunk.

    With ``state`` (dict h: (B,D_in,N) f32, conv: (B,dc-1,D_in)) the
    block continues from it (decode uses S == 1) and writes the final
    state into it in place: ``state``'s tensors are the layer's views of
    the segment's stacked ``(repeat, ...)`` cache, as with
    :func:`attention`. The reference returns a new state instead.

    Under a mesh the channels are this rank's when ``in_proj`` holds
    fewer than ``D_in`` of them (as ``(D, 2, D_in / model)``: the same
    channels of x and of the gate z): ``in_proj`` is column-parallel,
    the conv, dt, A, the skip and the carried state are the rank's
    channels, ``w_bc`` is row-parallel and B, C made whole by an
    all-reduce (every rank scans its channels with all of them), and
    ``out_proj`` is row-parallel, its output all-reduced.
    """
    b, s, d = x.shape
    w_in = params["in_proj"].reshape(d, -1)      # [x | z] of the channels
    d_in = w_in.shape[1] // 2
    tp = d_in < d * cfg.mamba_expand
    st, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    cd = cfg.cdtype
    if tp:
        x = par.to_model(x)

    if state is not None:
        tail = state["conv"].to(cd)
        h = state["h"].float()
    else:
        tail = torch.zeros((b, dc - 1, d_in), dtype=cd, device=x.device)
        h = torch.zeros((b, d_in, st), dtype=torch.float32, device=x.device)

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk != 0:
        chunk = s        # one chunk for ragged lengths, as the reference

    w_in = w_in.to(cd)
    conv_w = params["conv_w"].to(cd)
    w_bc = params["w_bc"].to(cd)
    w_dt = params["w_dt"].to(cd)
    b_dt = params["b_dt"].to(cd)
    d_skip = params["d_skip"].float()
    w_out = params["out_proj"].to(cd)
    a = -torch.exp(params["a_log"].float())                  # (D_in,N)

    outs = []
    for c0 in range(0, s, chunk):
        xz = torch.einsum("bld,de->ble", x[:, c0:c0 + chunk], w_in)
        xs, z = xz.chunk(2, dim=-1)
        xpad = torch.cat([tail, xs], dim=1)
        if dc > 1:
            tail = xpad[:, -(dc - 1):]
        xc = sum(xpad[:, i:i + chunk] * conv_w[i] for i in range(dc))
        xc = F.silu(xc)
        bc = torch.einsum("ble,en->bln", xc, w_bc)
        if tp:
            bc = par.to_model(par.from_model(bc))
        b_c, c_c = bc.float().chunk(2, dim=-1)
        dt = F.softplus(xc * w_dt + b_dt).float()
        xcf = xc.float()
        y_c, h = ops.mamba_chunk(dt, xcf, b_c, c_c, a, h)
        y_c = (y_c + d_skip * xcf).to(cd)
        y_c = y_c * F.silu(z)
        outs.append(torch.einsum("ble,ed->bld", y_c, w_out))
    if state is not None:
        state["h"].copy_(h)
        state["conv"].copy_(tail)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return par.from_model(out) if tp else out


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


def mlstm_block(params: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Params] = None) -> torch.Tensor:
    """mLSTM matrix-memory cell, chunkwise parallel, with the reference's
    log-space stabilizer (see ``repro/models/layers.py:mlstm_block``):
    weights exp(F_t - F_s + i~_s) are divided by exp(m_t) with
    m_t = F_t + G_t, G_t = max(m_prev, cummax_{s<=t}(i~_s - F_s)); the
    carried (C, n, m) triple makes the recursion exact across chunks and
    decode steps (a step is one chunk of length 1).

    With ``state`` (dict C: (B,H,dh,dh), n: (B,H,dh), m: (B,H), f32) the
    cell continues from it and writes the final triple into it in place,
    as :func:`mamba_block` does; without, it starts from zeros and m =
    -1e30, the initial state of ``kvcache.init_cache``.
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

    if state is not None:
        C, n, m_prev = (state[k].float() for k in ("C", "n", "m"))
    else:
        C = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                        device=x.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        m_prev = torch.full((b, h), -1e30, dtype=torch.float32,
                            device=x.device)
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
    if state is not None:
        for key, t in (("C", C), ("n", n), ("m", m_prev)):
            state[key].copy_(t)
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


def slstm_block(params: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Params] = None) -> torch.Tensor:
    """sLSTM scalar-memory cell with exponential gating and the
    stabilizer state m; a true recurrence through h, stepped in order.

    With ``state`` (dict h, c, n, m: (B,D) f32) the cell continues from
    it and writes the final four into it in place; without, it starts
    from zeros and m = -1e9, as ``kvcache.init_cache``'s state."""
    b, s, d = x.shape
    cd = cfg.cdtype
    pre = torch.einsum("bsd,de->bse", x, params["w_x"].to(cd)) + \
        params["bias"].to(cd)
    r_h = params["r_h"].to(cd).float()   # h is f32: the product is f32
    if state is not None:
        h, c, n, m = (state[k].float() for k in ("h", "c", "n", "m"))
    else:
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
    if state is not None:
        for key, t in (("h", h), ("c", c), ("n", n), ("m", m)):
            state[key].copy_(t)
    y = torch.stack(hs, dim=1).to(cd)
    return torch.einsum("bsd,de->bse", y, params["proj"].to(cd))
