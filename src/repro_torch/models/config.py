"""Architecture configuration for the served/trained model zoo.

One ``ArchConfig`` describes any of the six assigned architecture families
(dense / moe / ssm / hybrid / enc-dec audio / vlm) as a sequence of
*segments*: a segment is a repeating pattern of blocks whose parameters
are stacked along a leading ``repeat`` axis (the same layout as the JAX
reference, so parameter trees convert one to one); the port walks that
axis with a Python loop.

Example patterns:
  dense llama:  [Segment((Block("attn","dense"),), repeat=16)]
  deepseek-v3:  [Segment((attn,"dense"), 3), Segment((attn,"moe"), 58)]
  jamba:        [Segment(8-block period {1 attn + 7 mamba, moe on odd}, 9)]
  xlstm:        [Segment((mlstm, mlstm, mlstm, slstm), 3)]
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import torch_dtype

BLOCK_KINDS = ("attn", "mamba", "mlstm", "slstm")
FFN_KINDS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class Block:
    kind: str = "attn"        # one of BLOCK_KINDS
    ffn: str = "dense"        # one of FFN_KINDS

    def __post_init__(self):
        assert self.kind in BLOCK_KINDS, self.kind
        assert self.ffn in FFN_KINDS, self.ffn


@dataclasses.dataclass(frozen=True)
class Segment:
    blocks: Tuple[Block, ...]
    repeat: int

    @property
    def num_layers(self) -> int:
        return len(self.blocks) * self.repeat


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|encdec|vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]  # decoder stack
    head_dim: Optional[int] = None

    # -- attention flavor --------------------------------------------------
    qkv_bias: bool = False                 # qwen2
    rope_theta: float = 10000.0
    sliding_window: int = 0                # 0 = full attention
    use_mla: bool = False                  # deepseek-v3 MLA
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                      # expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_groups: int = 1                    # group-limited routing (EP)

    # -- SSM (mamba) / xLSTM ------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    xlstm_expand: int = 2
    ssm_chunk: int = 256                   # chunked-scan length

    # -- encoder-decoder (whisper) -------------------------------------------
    encoder_segments: Tuple[Segment, ...] = ()
    encoder_max_frames: int = 1500         # whisper 30 s @ 50 Hz

    # -- vlm ------------------------------------------------------------------
    num_image_tokens: int = 0              # stub patch-embedding count

    # -- activation -------------------------------------------------------------
    act: str = "swiglu"                    # "swiglu" | "gelu" (non-gated)

    # -- heads / training ------------------------------------------------------
    mtp_depth: int = 0                     # deepseek multi-token prediction
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # -- numerics ---------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False

    # ------------------------------------------------------------------ helpers
    @property
    def qk_head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments)

    @property
    def is_encoder_decoder(self) -> bool:
        return bool(self.encoder_segments)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: no full-attention block, or sliding window."""
        if self.sliding_window > 0:
            return True
        kinds = {
            b.kind for seg in self.segments for b in seg.blocks
        }
        if "attn" not in kinds:
            return True
        # hybrids keep attention but KV is O(window)=O(full) — attention KV
        # at 500k is fine when it is a small minority and batch==1; mark
        # hybrids as long-context capable per the assignment.
        attn_frac = sum(
            seg.repeat * sum(1 for b in seg.blocks if b.kind == "attn")
            for seg in self.segments
        ) / max(self.num_layers, 1)
        return attn_frac <= 0.25

    # ---------------------------------------------------------- param counts
    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            h = self.num_heads
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            return (d * self.q_lora_rank
                    + self.q_lora_rank * h * qk
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * h * (self.qk_nope_head_dim
                                               + self.v_head_dim)
                    + h * self.v_head_dim * d)
        hd = self.resolved_head_dim
        return (d * self.num_heads * hd          # q
                + 2 * d * self.num_kv_heads * hd  # k, v
                + self.num_heads * hd * d)        # o

    def _dense_ffn_params(self) -> int:
        mats = 3 if self.act == "swiglu" else 2  # gate/up/down vs up/down
        return mats * self.d_model * self.d_ff

    def _moe_ffn_params(self) -> int:
        per_expert = 3 * self.d_model * self.moe_d_ff  # experts stay gated
        return (self.num_experts * per_expert
                + self.num_shared_experts * per_expert
                + self.d_model * self.num_experts)  # router

    def _mamba_params(self) -> int:
        d_in = self.d_model * self.mamba_expand
        st = self.mamba_d_state
        return (self.d_model * 2 * d_in           # in_proj
                + d_in * self.mamba_d_conv        # conv
                + d_in * (st * 2 + 1) + d_in * st  # x->B,C,dt; A
                + d_in * self.d_model)            # out_proj

    def _xlstm_params(self, kind: str) -> int:
        d_in = self.d_model * self.xlstm_expand
        if kind == "mlstm":
            return (self.d_model * 2 * d_in       # up proj (x, gate)
                    + 3 * d_in * d_in             # q, k, v
                    + 2 * d_in                    # i, f gate biases-ish
                    + d_in * self.d_model)
        # slstm: 4 gates over d_model + ffn-ish projection
        return 4 * self.d_model * self.d_model * 2 + self.d_model * self.d_model

    def _block_params(self, b: Block) -> int:
        n = {"attn": self._attn_params(),
             "mamba": self._mamba_params(),
             "mlstm": self._xlstm_params("mlstm"),
             "slstm": self._xlstm_params("slstm")}[b.kind]
        if b.ffn == "dense":
            n += self._dense_ffn_params()
        elif b.ffn == "moe":
            n += self._moe_ffn_params()
        return n + 2 * self.d_model  # norms

    def param_count(self) -> int:
        """Total parameters (embeddings + stacks + head)."""
        n = self.vocab_size * self.d_model       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # unembedding
        for seg in self.segments:
            n += seg.repeat * sum(self._block_params(b) for b in seg.blocks)
        for seg in self.encoder_segments:
            n += seg.repeat * sum(self._block_params(b) for b in seg.blocks)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.num_experts == 0:
            return self.param_count()
        n = self.param_count()
        per_expert = 3 * self.d_model * self.moe_d_ff
        moe_blocks = sum(
            seg.repeat * sum(1 for b in seg.blocks if b.ffn == "moe")
            for seg in tuple(self.segments) + tuple(self.encoder_segments)
        )
        inactive = moe_blocks * (self.num_experts
                                 - self.num_experts_per_tok) * per_expert
        return n - inactive

    def flops_per_token(self, seq_len: int = 1) -> float:
        """~6*N_active per trained token; 2*N_active per inferred token,
        plus attention O(s*d) term. Used by the analytic profiler."""
        n = self.active_param_count()
        attn_layers = sum(
            seg.repeat * sum(1 for b in seg.blocks if b.kind == "attn")
            for seg in self.segments
        )
        window = self.sliding_window or seq_len
        attn = 2 * 2 * attn_layers * min(seq_len, window) * \
            self.num_heads * self.qk_head_dim
        return 2 * n + attn


def dense_segments(num_layers: int) -> Tuple[Segment, ...]:
    return (Segment((Block("attn", "dense"),), num_layers),)


def scale_down(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers,
    d_model<=512, <=4 experts)."""
    def shrink_segments(segs: Tuple[Segment, ...]) -> Tuple[Segment, ...]:
        if not segs:
            return segs
        out = []
        budget = 2  # at most 2 pattern units total
        for seg in segs:
            if budget <= 0:
                break
            out.append(Segment(seg.blocks, 1))
            budget -= 1
        return tuple(out)

    d_model = min(cfg.d_model, 256)
    num_heads = min(cfg.num_heads, 4)
    base = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=max(1, min(cfg.num_kv_heads,
                                num_heads if cfg.num_kv_heads >= cfg.num_heads
                                else max(1, num_heads // 2))),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else cfg.d_ff,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64 if cfg.head_dim else None,
        segments=shrink_segments(cfg.segments),
        encoder_segments=shrink_segments(cfg.encoder_segments),
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else cfg.moe_d_ff,
        q_lora_rank=64, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        num_image_tokens=min(cfg.num_image_tokens, 16),
        encoder_max_frames=min(cfg.encoder_max_frames, 64),
        mtp_depth=min(cfg.mtp_depth, 1),
        ssm_chunk=64,
    )
    return dataclasses.replace(base, **overrides)
