"""Serving-state (KV cache / recurrent state) construction.

The counterpart of the reference's ``repro/models/kvcache.py``, with the
same tree, shapes and dtypes. The cache mirrors the model's segment
structure: for each segment, a dict per block position whose leaves
carry a leading ``repeat`` axis, beside the stacked parameters.

Cache kinds per block:
  attn  (dense KV) : k,v            (repeat, B, Smax, KV, hd)
  attn  (MLA)      : c_kv, k_rope   (repeat, B, Smax, kr|rope)
  mamba            : h (repeat,B,D_in,N), conv (repeat,B,dc-1,D_in)
  mlstm            : C (repeat,B,H,dh,dh), n (repeat,B,H,dh), m (repeat,B,H)
  slstm            : h,c,n,m        (repeat, B, D)
  cross-attn (enc-dec): k,v over encoder states, built at prefill.

Attention caches and the Mamba and xLSTM states are written in place by
prefill and decode; the prefill of an encoder-decoder model replaces the
cross K/V with the encoder's at the frames it was given (see
``Model.prefill``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig, Block

Device = Union[str, torch.device, None]


def _attn_cache(cfg: ArchConfig, repeat: int, batch: int, smax: int,
                dtype: torch.dtype, device: Device) -> Dict[str, Any]:
    if cfg.use_mla:
        return {
            "c_kv": torch.zeros((repeat, batch, smax, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((repeat, batch, smax,
                                   cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
        }
    hd = cfg.resolved_head_dim
    shape = (repeat, batch, smax, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _block_cache(cfg: ArchConfig, block: Block, repeat: int, batch: int,
                 smax: int, dtype: torch.dtype,
                 device: Device) -> Dict[str, Any]:
    f32 = torch.float32
    if block.kind == "attn":
        return _attn_cache(cfg, repeat, batch, smax, dtype, device)
    if block.kind == "mamba":
        d_in = cfg.d_model * cfg.mamba_expand
        return {
            "h": torch.zeros((repeat, batch, d_in, cfg.mamba_d_state),
                             dtype=f32, device=device),
            "conv": torch.zeros((repeat, batch, cfg.mamba_d_conv - 1, d_in),
                                dtype=dtype, device=device),
        }
    if block.kind == "mlstm":
        d_in = cfg.d_model * cfg.xlstm_expand
        dh = d_in // cfg.num_heads
        return {
            "C": torch.zeros((repeat, batch, cfg.num_heads, dh, dh),
                             dtype=f32, device=device),
            "n": torch.zeros((repeat, batch, cfg.num_heads, dh), dtype=f32,
                             device=device),
            # log-space stabilizer carried across decode steps
            "m": torch.full((repeat, batch, cfg.num_heads), -1e30,
                            dtype=f32, device=device),
        }
    if block.kind == "slstm":
        shape = (repeat, batch, cfg.d_model)
        return {"h": torch.zeros(shape, dtype=f32, device=device),
                "c": torch.zeros(shape, dtype=f32, device=device),
                "n": torch.zeros(shape, dtype=f32, device=device),
                "m": torch.full(shape, -1e9, dtype=f32, device=device)}
    raise ValueError(block.kind)


def init_cache(cfg: ArchConfig, batch: int, smax: int,
               dtype: Optional[torch.dtype] = None,
               device: Device = None) -> Tuple[Any, Any]:
    """Decode cache for the decoder stack, ``(cache, cross)``; ``cross``
    is None for decoder-only configs. Window-capped for sliding-window
    attention, which never needs more than ``window`` slots.

    ``device=None`` means the card, as at every entry point of the port,
    and raises without a GPU; ``"meta"`` builds the tree of shapes alone.
    """
    if device is None or torch.device(device).type != "meta":
        device = resolve_device(device)
    dtype = dtype or cfg.cdtype
    cache = []
    for seg in cfg.segments:
        seg_cache = []
        for b in seg.blocks:
            s_eff = smax
            if b.kind == "attn" and cfg.sliding_window > 0:
                s_eff = min(smax, cfg.sliding_window)
            seg_cache.append(_block_cache(cfg, b, seg.repeat, batch, s_eff,
                                          dtype, device))
        cache.append(tuple(seg_cache))
    out = tuple(cache)
    if cfg.is_encoder_decoder:
        # cross-attention K/V over encoder outputs, filled at prefill;
        # one slot per repeat (enc-dec patterns carry one attn block each)
        hd = cfg.resolved_head_dim
        cross = []
        for seg in cfg.segments:
            shape = (seg.repeat, batch, cfg.encoder_max_frames,
                     cfg.num_kv_heads, hd)
            cross.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype,
                                           device=device)})
        return out, tuple(cross)
    return out, None


def cache_bytes(cfg: ArchConfig, batch: int, smax: int) -> int:
    """Analytic cache footprint (profiler/roofline helper), the
    reference's count, all at the compute dtype's size: K/V (or MLA's
    latent and rope key) and the Mamba conv window at 1 x their
    elements; the Mamba ``h``, the mLSTM ``C`` and ``n``, and the four
    sLSTM states at 2 x their elements, as f32 state under bf16 compute
    would take; the mLSTM ``m`` is left out. Those states are f32 in the
    ``init_cache`` tree whatever the compute dtype, so for an f32 config
    the recurrent part is counted at twice the tree's bytes (xlstm-125m
    at B 8, smax 1024: 341,213,184 counted against 170,607,744); the
    attention part is exact."""
    total = 0
    itemsize = cfg.cdtype.itemsize
    for seg in cfg.segments:
        for b in seg.blocks:
            if b.kind == "attn":
                s_eff = min(smax, cfg.sliding_window) if cfg.sliding_window \
                    else smax
                if cfg.use_mla:
                    per = s_eff * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                else:
                    per = 2 * s_eff * cfg.num_kv_heads * cfg.resolved_head_dim
            elif b.kind == "mamba":
                d_in = cfg.d_model * cfg.mamba_expand
                per = d_in * cfg.mamba_d_state * 2 + \
                    (cfg.mamba_d_conv - 1) * d_in
            elif b.kind == "mlstm":
                d_in = cfg.d_model * cfg.xlstm_expand
                dh = d_in // cfg.num_heads
                per = cfg.num_heads * (dh * dh + dh) * 2
            else:  # slstm
                per = 4 * cfg.d_model * 2
            total += seg.repeat * per * batch * itemsize
    return int(total)
