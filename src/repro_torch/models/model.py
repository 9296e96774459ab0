"""Model assembly for all six families: init, the scoring forward and
the decode path, driven by ``ArchConfig``.

The counterpart of the reference's ``repro/models/model.py`` for the
dense-attention, MoE, MLA (with DeepSeek's multi-token prediction),
hybrid (Mamba + attention), xLSTM, encoder-decoder (whisper: an encoder
over stub frame features, cross-attention in every decoder layer) and
image (pixtral: stub patch embeddings projected and prepended to the
text) families. Parameters keep the reference's tree:
``segments`` is a tuple over segments of a tuple over the pattern's
blocks, each a dict whose tensors carry a leading ``repeat`` axis; the
forward walks that axis with a Python loop where the reference scans.
The cache (:mod:`repro_torch.models.kvcache`) has the same structure and
is updated in place.

Entry points:
  build_model(cfg, device)                    -> Model
  Model.init(generator)                       -> params
  Model.forward(params, batch)                -> (logits (B,S,V) f32, aux)
                                                 aux: the MoE routers' loss
                                                 plus the MTP loss; S the
                                                 text positions
  Model.loss(params, batch)                   -> scalar: next-token CE + aux
  Model.grad_sq_norm(grads)                   -> the clip's squared norm
  Model.prefill(params, batch, smax)          -> (last logits (B,1,V), cache)
  Model.decode_step(params, token, pos, cache) -> (logits (B,1,V), cache)

A batch holds ``tokens`` (B,S), and ``frames`` (B,F,128) for an
encoder-decoder config or ``image_feats`` (B,N,1024) for an image
config. Every family decodes: attention blocks through their KV cache,
Mamba and xLSTM blocks through their carried state, whisper's decoder
through the cross cache its prefill fills with the encoder's K/V at the
F frames given, pixtral's with positions that count the image prefix
(a step's ``pos`` is ``N`` plus the text position). With ``cfg.remat`` each
layer of a training forward is a ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body): only the layer
boundaries are kept, and the backward runs each layer's forward again.

The same code runs sharded: :class:`repro_torch.models.parallel.
ShardedModel` is a ``Model`` whose ``par`` issues the mesh's collectives
and whose ``seg_specs`` place each layer's weights.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig, Block, Segment
from repro_torch.models.kvcache import init_cache
from repro_torch.train.tree import sq_norm

Params = Dict[str, Any]
MTP_BLOCK = Block("attn", "dense")   # DeepSeek's MTP module is one layer
AUDIO_FEAT_DIM = 128     # stub mel/conv frontend feature width
IMAGE_FEAT_DIM = 1024    # stub ViT patch-embedding width


def _cross_entropy(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in f32, the reference's ``lse - logit``
    with the max subtracted (held out of the gradient, as the
    reference's ``stop_gradient``)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return lse - tgt


def _index(tree, i: int):
    """The i-th layer of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, block: Block,
                device: torch.device, cross_attn: bool = False) -> Params:
    p: Params = {"norm1": L.init_rmsnorm(cfg, device)}
    if block.kind == "attn":
        p["core"] = L.init_mla(gen, cfg, device) if cfg.use_mla \
            else L.init_attention(gen, cfg, device)
    elif block.kind == "mamba":
        p["core"] = L.init_mamba(gen, cfg, device)
    elif block.kind == "mlstm":
        p["core"] = L.init_mlstm(gen, cfg, device)
    elif block.kind == "slstm":
        p["core"] = L.init_slstm(gen, cfg, device)
    if cross_attn and block.kind == "attn":
        p["norm_cross"] = L.init_rmsnorm(cfg, device)
        p["cross"] = L.init_cross_attention(gen, cfg, device)
    if block.ffn == "dense":
        p["norm2"] = L.init_rmsnorm(cfg, device)
        p["ffn"] = L.init_mlp(gen, cfg, device)
    elif block.ffn == "moe":
        p["norm2"] = L.init_rmsnorm(cfg, device)
        p["ffn"] = L.init_moe(gen, cfg, device)
    return p


def _apply_block(p: Params, cfg: ArchConfig, block: Block, x: torch.Tensor,
                 positions: torch.Tensor, mask_kind: Optional[str],
                 cache: Optional[Params] = None,
                 cache_pos: Optional[int] = None, par: L.Local = L.LOCAL,
                 enc_out: Optional[torch.Tensor] = None,
                 cross: Optional[Params] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block; returns (x, the MoE router's aux loss or None). A block
    with ``cache`` writes it in place; a decoder block of an
    encoder-decoder model adds its cross-attention (:func:`_cross`)."""
    aux = None
    h = L.rmsnorm(p["norm1"], cfg, x)
    if block.kind == "attn" and cfg.use_mla:
        out, _ = L.mla_attention(p["core"], cfg, h, positions,
                                 kind=mask_kind, cache=cache,
                                 cache_pos=cache_pos, par=par)
    elif block.kind == "attn":
        out, _ = L.attention(p["core"], cfg, h, positions, kind=mask_kind,
                             cache=cache, cache_pos=cache_pos, par=par)
    elif block.kind == "mamba":
        out = L.mamba_block(p["core"], cfg, h, cache, par)
    elif block.kind == "mlstm":
        out = L.mlstm_block(p["core"], cfg, h, cache, par)
    else:       # replicated weights: every rank runs the whole cell
        out = L.slstm_block(p["core"], cfg, h, cache)
    x = x + out
    if "cross" in p:
        x = x + _cross(p, cfg, x, positions, enc_out, cross, par)
    if block.ffn == "dense":
        h = L.rmsnorm(p["norm2"], cfg, x)
        x = x + L.mlp(p["ffn"], cfg, h, par)
    elif block.ffn == "moe":
        h = L.rmsnorm(p["norm2"], cfg, x)
        out, aux = L.moe(p["ffn"], cfg, h, par)
        x = x + out
    return x, aux


def _cross(p: Params, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor, enc_out: Optional[torch.Tensor],
           cross: Optional[Params], par: L.Local = L.LOCAL) -> torch.Tensor:
    """The cross-attention branch of a decoder block (before the residual
    add). With ``enc_out`` (B,F,d), a forward or prefill: attention over
    the encoder's states, no RoPE, no mask; a prefill's ``cross`` (this
    layer's views of the cross cache, F frames) takes the encoder's K/V,
    with no bias, as the reference's. Without it, a decode step: the
    query (no bias, no RoPE) attends over every frame of ``cross``
    through the flash kernel ("full"), the reference's route.

    Under a mesh the heads are this rank's as in :func:`L.attention`, and
    so are the cross cache's; a decode step attends with them and
    all-reduces ``wo``'s partial output."""
    cd = cfg.cdtype
    w = p["cross"]
    h = L.rmsnorm(p["norm_cross"], cfg, x)
    if enc_out is not None:
        out, _ = L.attention(w, cfg, h, positions, kind="full", kv_x=enc_out,
                             use_rope=False, par=par)
        if cross is not None:
            for key in ("k", "v"):
                cross[key].copy_(torch.einsum(
                    "bsd,dhk->bshk", enc_out, w["w" + key].to(cd)))
        return out
    heads_tp = w["wq"].shape[1] < cfg.num_heads
    if heads_tp:
        h = par.to_model(h)
    q = torch.einsum("bsd,dhk->bshk", h, w["wq"].to(cd))
    o = ops.attention(q, cross["k"].to(cd), cross["v"].to(cd), None, cd,
                      kind="full")
    out = torch.einsum("bshk,hkd->bsd", o, w["wo"].to(cd))
    return par.from_model(out) if heads_tp else out


def _init_segment(gen: torch.Generator, cfg: ArchConfig, seg: Segment,
                  device: torch.device,
                  cross_attn: bool = False) -> Tuple[Params, ...]:
    out = []
    for block in seg.blocks:
        layers = [_init_block(gen, cfg, block, device, cross_attn)
                  for _ in range(seg.repeat)]
        out.append(_stack(layers))
    return tuple(out)


def _stack(layers):
    """Stack the layers' trees leaf by leaf, dropping each layer's leaf
    as it is stacked, so that at most one leaf is held twice (DeepSeek's
    expert stacks are 15 GB each). One layer is a view, not a copy."""
    if isinstance(layers[0], dict):
        return {k: _stack([lay.pop(k) for lay in layers])
                for k in list(layers[0])}
    if len(layers) == 1:
        return layers.pop().unsqueeze(0)
    out = torch.stack(layers)
    layers.clear()
    return out


def _run_segment(params_stack, cfg: ArchConfig, seg: Segment,
                 x: torch.Tensor, positions: torch.Tensor,
                 mask_kind: Optional[str], cache_stack=None,
                 cache_pos: Optional[int] = None, par: L.Local = L.LOCAL,
                 specs=None, enc_out: Optional[torch.Tensor] = None,
                 cross_stack=None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Python loop over the repeat axis (the reference scans it). Layer r
    of block bi gets the views ``cache_stack[bi][...][r]``. Returns (x,
    the sum of the MoE blocks' aux losses, or None without MoE). With
    ``cfg.remat`` and grad enabled (no cache), each repeat is one
    checkpoint, as the reference checkpoints its scan body. Under a mesh
    ``specs`` holds each block's per-layer placements, by which
    ``par.layer`` gathers a layer's weights (inside the checkpoint, so
    that the backward gathers them again). An encoder-decoder segment
    takes the encoder's states ``enc_out`` and its slice of the cross
    cache ``cross_stack``, one slot a repeat for its one attention
    block."""
    if cross_stack is not None and \
            sum(b.kind == "attn" for b in seg.blocks) != 1:
        raise ValueError(f"{cfg.name}: an encoder-decoder pattern has "
                         f"exactly one attention block")
    remat = cfg.remat and cache_stack is None and torch.is_grad_enabled()
    run = functools.partial(checkpoint, _run_repeat, use_reentrant=False) \
        if remat else _run_repeat
    aux = None
    for r in range(seg.repeat):
        x, a = run(params_stack, cfg, seg, r, x, positions, mask_kind,
                   cache_stack, cache_pos, par, specs, enc_out, cross_stack)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _run_repeat(params_stack, cfg: ArchConfig, seg: Segment, r: int,
                x: torch.Tensor, positions: torch.Tensor,
                mask_kind: Optional[str], cache_stack,
                cache_pos: Optional[int], par: L.Local = L.LOCAL,
                specs=None, enc_out: Optional[torch.Tensor] = None,
                cross_stack=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The pattern's blocks at repeat ``r``: (x, their aux sum or None)."""
    aux = None
    cross = None if cross_stack is None else _index(cross_stack, r)
    for bi, block in enumerate(seg.blocks):
        cache = None if cache_stack is None else _index(cache_stack[bi], r)
        p = _index(params_stack[bi], r)
        if specs is not None:
            p = par.layer(p, specs[bi])
        x, a = _apply_block(p, cfg, block, x, positions, mask_kind, cache,
                            cache_pos, par, enc_out, cross)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    # one rank; a sharded model (repro_torch.models.parallel) sets its
    # mesh's collectives, the tree's placements, each segment's per-layer
    # placements and the encoder's
    par = L.LOCAL
    specs = None
    seg_specs = None
    enc_specs = None

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
            "segments": tuple(_init_segment(generator, cfg, seg, dev,
                                            cfg.is_encoder_decoder)
                              for seg in cfg.segments),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                        generator=generator, device=dev)
                            * 0.02).to(cfg.pdtype)
        if cfg.is_encoder_decoder:
            p["encoder"] = {
                "in_proj": (torch.randn((AUDIO_FEAT_DIM, cfg.d_model),
                                        generator=generator, device=dev)
                            * 0.05).to(cfg.pdtype),
                "segments": tuple(_init_segment(generator, cfg, seg, dev)
                                  for seg in cfg.encoder_segments),
                "final_norm": L.init_rmsnorm(cfg, dev),
            }
        if cfg.num_image_tokens:
            p["img_proj"] = (torch.randn((IMAGE_FEAT_DIM, cfg.d_model),
                                         generator=generator, device=dev)
                             * 0.05).to(cfg.pdtype)
        if cfg.mtp_depth:
            p["mtp"] = {
                "proj": (torch.randn((2 * cfg.d_model, cfg.d_model),
                                     generator=generator, device=dev)
                         * 0.02).to(cfg.pdtype),
                "block": _init_block(generator, cfg, MTP_BLOCK, dev),
                "norm": L.init_rmsnorm(cfg, dev),
            }
        return p

    def _embed_tokens(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"].to(self.cfg.cdtype)[tokens]

    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, int]:
        """The tokens' embeddings, after the projected image prefix of an
        image config given ``batch["image_feats"]``: (x, the number of
        prefix positions)."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"])
        if not (cfg.num_image_tokens and "image_feats" in batch):
            return x, 0
        w = params["img_proj"] if self.specs is None else \
            self.par.layer(params["img_proj"], self.specs["img_proj"])
        img = torch.einsum("bnf,fd->bnd", batch["image_feats"].to(cfg.cdtype),
                           w.to(cfg.cdtype))
        return torch.cat([img, x], dim=1), img.shape[1]

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over stub frame features (B,F,128): the
        projection, sinusoidal positions, the encoder stack (full
        attention, RoPE on its self-attention, as the reference's) and
        its final norm. Under a mesh ``enc_specs`` places the encoder's
        leaves: its layers run as the decoder's do."""
        cfg, specs = self.cfg, self.enc_specs
        enc, cd = params["encoder"], cfg.cdtype
        if specs is not None:
            enc = {k: enc[k] if k == "segments" else
                   self.par.layer(enc[k], specs[k]) for k in enc}
        x = torch.einsum("bfe,ed->bfd", frames.to(cd), enc["in_proj"].to(cd))
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device).to(cd)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for si, (seg, ps) in enumerate(zip(cfg.encoder_segments,
                                           enc["segments"])):
            x, _ = _run_segment(ps, cfg, seg, x, positions, "full",
                                par=self.par, specs=None if specs is None
                                else specs["segments"][si])
        return L.rmsnorm(enc["final_norm"], cfg, x)

    def _head(self, params: Params, x: torch.Tensor,
              norm: Optional[Params] = None) -> torch.Tensor:
        cfg = self.cfg
        x = L.rmsnorm(params["final_norm"] if norm is None else norm, cfg,
                      x)
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return torch.einsum("bsd,dv->bsv", x, w.to(cfg.cdtype)).float()

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary of the logits an entry point returns
        (they are whole here)."""
        return logits

    def _layers(self, params: Params, x: torch.Tensor, kind: str,
                positions: torch.Tensor, state=None,
                cache_pos: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every segment over x, with the cache of ``state`` if given and
        the encoder's states ``enc_out``: (x, the MoE blocks' aux
        sum)."""
        cfg = self.cfg
        par = self.par if state is None else self._cache_par(state)
        cross = None if state is None else state[1]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, (seg, ps) in enumerate(zip(cfg.segments,
                                           params["segments"])):
            x, a = _run_segment(
                ps, cfg, seg, x, positions, kind,
                None if state is None else state[0][si], cache_pos, par,
                None if self.seg_specs is None else self.seg_specs[si],
                enc_out, None if cross is None else cross[si])
            if a is not None:
                aux = aux + a
        return x, aux

    def _cache_par(self, state) -> L.Local:
        """The collectives of a run over the cache of ``state``."""
        return self.par

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scoring forward over ``batch["tokens"]`` (B,S) int, with the
        batch's frames or image features. Returns (logits (B,S,V) f32,
        aux): the logits of the text positions (the head runs on those
        alone), aux the MoE routers' losses and, for a config with MTP,
        the MTP loss unless ``batch["enable_mtp"] is False``; it is 0 for
        the other families."""
        cfg = self.cfg
        x, n_prefix = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc_out = self._encode(params, batch["frames"]) \
            if cfg.is_encoder_decoder else None
        x, aux = self._layers(params, x, "causal", positions,
                              enc_out=enc_out)
        if n_prefix:
            x = x[:, n_prefix:].contiguous()
        logits = self._head(params, x)
        if cfg.mtp_depth and batch.get("enable_mtp", True) is not False:
            aux = aux + self._mtp_loss(params, x, batch["tokens"])
        return logits, aux

    def _mtp_loss(self, params: Params, h: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction (depth 1): from h_i and
        emb(t_{i+1}) predict t_{i+2}; 0.1 x the mean cross entropy."""
        cfg = self.cfg
        if tokens.shape[1] < 3:
            return torch.zeros((), dtype=torch.float32, device=h.device)
        mtp = self._mtp_params(params)
        emb_next = self._embed_tokens(params, tokens[:, 1:])
        hcat = torch.cat([h[:, :-1], emb_next], dim=-1)
        x = torch.einsum("bsd,de->bse", hcat, mtp["proj"].to(cfg.cdtype))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _ = _apply_block(mtp["block"], cfg, MTP_BLOCK, x, positions,
                            "causal", par=self.par)
        logits = self._head(params, x, norm=mtp["norm"])
        return 0.1 * self._batch_mean(
            self._cross_entropy(logits[:, :-1], tokens[:, 2:]))

    def _mtp_params(self, params: Params) -> Params:
        """The MTP module's weights for use."""
        return params["mtp"]

    def _batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of per-token values over the batch."""
        return x.mean()

    def _cross_entropy(self, logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
        return _cross_entropy(logits, targets)

    def _mean_loss(self, num: torch.Tensor, den: torch.Tensor,
                   aux: torch.Tensor) -> torch.Tensor:
        """The loss from the summed cross entropy, its count and aux."""
        return num / torch.clamp(den, min=1.0) + aux

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch["tokens"]`` plus the
        forward's aux; with ``batch["loss_mask"]`` (B,S) the CE is the
        mean over the masked-in targets (at least 1 in the divisor)."""
        logits, aux = self.forward(params, batch)
        tokens = batch["tokens"]
        ce = self._cross_entropy(logits[:, :-1], tokens[:, 1:])
        if "loss_mask" in batch:
            m = batch["loss_mask"][:, 1:].float()
            num, den = (ce * m).sum(), m.sum()
        else:
            num = ce.sum()
            den = torch.tensor(float(ce.numel()), device=ce.device)
        return self._mean_loss(num, den, aux)

    def grad_sq_norm(self, grads) -> torch.Tensor:
        """The squared global norm of a gradient tree, which the
        optimizer's clip reads."""
        return sq_norm(grads)

    def init_cache(self, batch: int, smax: int, device=None):
        """A fresh cache state of ``smax`` slots: (cache, cross)."""
        return init_cache(self.cfg, batch, smax,
                          device=self.device if device is None else device)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                smax: int) -> Tuple[torch.Tensor, Any]:
        """Process the prompt ``batch["tokens"]`` (B,S), after an image
        config's prefix, into a fresh cache of ``smax`` slots (the
        prefix takes slots too). Returns (last-position logits (B,1,V)
        f32, (cache, cross)): ``cross`` holds, a decoder layer, the
        encoder's K/V at the F frames of ``batch["frames"]``, else
        None."""
        tokens = batch["tokens"]
        return self._prefill(params, batch, self.init_cache(
            tokens.shape[0], smax, tokens.device))

    def _prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                 state):
        cfg = self.cfg
        x, _ = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = self._encode(params, batch["frames"])
            state = (state[0], _cross_at(state[1], enc_out.shape[1])) + \
                tuple(state[2:])
        x, _ = self._layers(params, x, "causal", positions, state,
                            enc_out=enc_out)
        # the kernels take contiguous rows: the last position's is a copy
        return self._head(params, x[:, -1:].contiguous()), state

    def decode_step(self, params: Params, token: torch.Tensor, pos: int,
                    cache_state) -> Tuple[torch.Tensor, Any]:
        """One decode step. token: (B,1) int; pos: the token's position
        (0-based, the image prefix counted) as a host int. Returns
        (logits (B,1,V) f32, cache state); the cache is updated in place
        and returned."""
        pos = int(pos)
        x = self._embed_tokens(params, token)
        positions = torch.full((1, 1), pos, device=x.device)
        x, _ = self._layers(params, x, "decode", positions, cache_state,
                            pos)
        return self._head(params, x), cache_state


def _cross_at(cross, frames: int):
    """The cross cache of a prefill over ``frames`` encoder frames. The
    reference's prefill replaces the buffer of ``encoder_max_frames``
    with the encoder's K/V, so that decode attends over exactly the F
    frames given: a buffer of another length is replaced by one of F
    (every slot then written by the prefill), one of F is kept."""
    return tuple({k: t if t.shape[2] == frames else
                  t.new_empty(t.shape[:2] + (frames,) + t.shape[3:])
                  for k, t in seg.items()} for seg in cross)


def build_model(cfg: ArchConfig,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """A model on ``device`` (default ``cuda``; raises without a GPU)."""
    return Model(cfg, resolve_device(device))
