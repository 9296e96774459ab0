"""The assigned input shapes and their stand-ins on the ``meta`` device:
the reference's ``repro/launch/shapes.py``.

  train_4k     seq=4096    global_batch=256   (train step)
  prefill_32k  seq=32768   global_batch=32    (prefill)
  decode_32k   seq=32768   global_batch=128   (decode_step: ONE new token
                                               against a seq-long cache)
  long_500k    seq=524288  global_batch=1     (decode_step; sub-quadratic
                                               archs only)

``batch_specs``, ``cache_specs`` and ``decode_specs`` return ``meta``
tensors (shapes and dtypes, no storage). The encoder-decoder and image
families' adjustments are kept as the reference writes them, for when
the port builds those models.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.kvcache import init_cache

AUDIO_FEAT_DIM = 128
IMAGE_FEAT_DIM = 1024
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether this (arch, shape) combination runs."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("full-attention architecture without a sliding-"
                       "window variant: long_500k decode skipped")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs of train/prefill batches, on ``meta``."""
    b, s = shape.batch, shape.seq
    if cfg.is_encoder_decoder:
        if shape.kind == "train":
            frames, toks = s // 2, s // 2
        else:
            frames, toks = cfg.encoder_max_frames, s
        return {"tokens": _meta((b, toks), torch.int32),
                "frames": _meta((b, frames, AUDIO_FEAT_DIM), cfg.cdtype)}
    if cfg.num_image_tokens:
        toks = max(s - cfg.num_image_tokens, 8)
        return {"tokens": _meta((b, toks), torch.int32),
                "image_feats": _meta((b, cfg.num_image_tokens,
                                      IMAGE_FEAT_DIM), cfg.cdtype)}
    return {"tokens": _meta((b, s), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> Any:
    """The decode cache of ``shape``, on ``meta``: ``(cache, cross)``."""
    return init_cache(cfg, shape.batch, shape.seq, device=META)


def decode_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    return {"token": _meta((shape.batch, 1), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": cache_specs(cfg, shape)}


def dryrun_config(cfg: ArchConfig, shape: ShapeSpec,
                  mesh_data_size: int) -> Tuple[ArchConfig, bool]:
    """The reference's numerics and memory policy for production: bf16
    params and compute, remat for training, bf16 optimizer moments for
    the >20B configs (the returned flag), MoE routing groups aligned
    with the data axes, the vocabulary padded to a multiple of 16 (the
    model axis) so the embedding, the head and the loss's logits shard.
    Returns (config, big)."""
    big = cfg.param_count() > 20e9
    groups = mesh_data_size if cfg.num_experts else 1
    t = shape.batch * shape.seq
    if groups > 1 and t % groups != 0:
        groups = 1
    model_size = 16
    vocab = -(-cfg.vocab_size // model_size) * model_size
    return dataclasses.replace(
        cfg,
        vocab_size=vocab,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=(shape.kind == "train"),
        moe_groups=groups,
    ), big
