"""Model assembly for the served families: init and the scoring forward,
driven by ``ArchConfig``.

The counterpart of the reference's ``repro/models/model.py`` for the
dense-attention and xLSTM families. Parameters keep the reference's tree:
``segments`` is a tuple over segments of a tuple over the pattern's
blocks, each a dict whose tensors carry a leading ``repeat`` axis; the
forward walks that axis with a Python loop where the reference scans.

Entry points:
  build_model(cfg, device)                    -> Model
  Model.init(generator)                       -> params
  Model.forward(params, batch)                -> (logits (B,S,V) f32, aux)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig, Block, Segment

Params = Dict[str, Any]


def _check_supported(cfg: ArchConfig) -> None:
    """The port serves dense attention and xLSTM stacks; other families
    arrive with their slices."""
    if cfg.use_mla or cfg.is_encoder_decoder or cfg.num_image_tokens \
            or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: MLA, encoder-decoder, image and MTP models "
            f"arrive with their family slices")
    for seg in cfg.segments:
        for blk in seg.blocks:
            if blk.kind == "mamba" or blk.ffn == "moe":
                raise NotImplementedError(
                    f"{cfg.name}: {blk.kind}/{blk.ffn} blocks arrive with "
                    f"the SSM/hybrid and MoE slices")


def _index(tree, i: int):
    """The i-th layer of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, block: Block,
                device: torch.device) -> Params:
    p: Params = {"norm1": L.init_rmsnorm(cfg, device)}
    if block.kind == "attn":
        p["core"] = L.init_attention(gen, cfg, device)
    elif block.kind == "mlstm":
        p["core"] = L.init_mlstm(gen, cfg, device)
    elif block.kind == "slstm":
        p["core"] = L.init_slstm(gen, cfg, device)
    if block.ffn == "dense":
        p["norm2"] = L.init_rmsnorm(cfg, device)
        p["ffn"] = L.init_mlp(gen, cfg, device)
    return p


def _apply_block(p: Params, cfg: ArchConfig, block: Block, x: torch.Tensor,
                 positions: torch.Tensor,
                 mask_kind: Optional[str]) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], cfg, x)
    if block.kind == "attn":
        out = L.attention(p["core"], cfg, h, positions, kind=mask_kind)
    elif block.kind == "mlstm":
        out = L.mlstm_block(p["core"], cfg, h)
    else:
        out = L.slstm_block(p["core"], cfg, h)
    x = x + out
    if block.ffn == "dense":
        h = L.rmsnorm(p["norm2"], cfg, x)
        x = x + L.mlp(p["ffn"], cfg, h)
    return x


def _init_segment(gen: torch.Generator, cfg: ArchConfig, seg: Segment,
                  device: torch.device) -> Tuple[Params, ...]:
    out = []
    for block in seg.blocks:
        layers = [_init_block(gen, cfg, block, device)
                  for _ in range(seg.repeat)]
        out.append(_stack(layers))
    return tuple(out)


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return torch.stack(layers)


def _run_segment(params_stack, cfg: ArchConfig, seg: Segment,
                 x: torch.Tensor, positions: torch.Tensor,
                 mask_kind: Optional[str]) -> torch.Tensor:
    """Python loop over the repeat axis (the reference scans it)."""
    for r in range(seg.repeat):
        for bi, block in enumerate(seg.blocks):
            x = _apply_block(_index(params_stack[bi], r), cfg, block, x,
                             positions, mask_kind)
    return x


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    def __post_init__(self):
        _check_supported(self.cfg)

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters in the reference's shapes and dtypes, drawn
        on the model's device from ``generator`` (which must live there).
        JAX's PRNG streams cannot be reproduced, so the values differ
        from the reference's ``init``; load those through
        :func:`repro_torch.convert.params_from_numpy` instead."""
        cfg, dev = self.cfg, self.device
        p: Params = {
            "embed": (torch.randn((cfg.vocab_size, cfg.d_model),
                                  generator=generator, device=dev)
                      * 0.02).to(cfg.pdtype),
            "final_norm": L.init_rmsnorm(cfg, dev),
            "segments": tuple(_init_segment(generator, cfg, seg, dev)
                              for seg in cfg.segments),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                        generator=generator, device=dev)
                            * 0.02).to(cfg.pdtype)
        return p

    def _embed_inputs(self, params: Params,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return params["embed"].to(self.cfg.cdtype)[batch["tokens"]]

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rmsnorm(params["final_norm"], cfg, x)
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return torch.einsum("bsd,dv->bsv", x, w.to(cfg.cdtype)).float()

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scoring forward over ``batch["tokens"]`` (B,S) int. Returns
        (logits (B,S,V) f32, aux); aux is 0 for the served families (no
        MoE router loss)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for seg, ps in zip(cfg.segments, params["segments"]):
            x = _run_segment(ps, cfg, seg, x, positions, "causal")
        logits = self._head(params, x)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def build_model(cfg: ArchConfig,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """A model on ``device`` (default ``cuda``; raises without a GPU)."""
    return Model(cfg, resolve_device(device))
