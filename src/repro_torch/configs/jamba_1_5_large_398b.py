"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave + MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) vocab=65536. Period of 8 layers: one
attention layer (index 4) + seven Mamba layers; MoE (16 experts, top-2,
hidden 24576 = the assignment's d_ff) on every other layer, dense MLP on
the rest. 9 periods = 72 layers. Attention is a 12.5% minority => the
long_500k decode shape runs natively (KV cache only for 9 layers).
"""

from repro_torch.models.config import ArchConfig, Block, Segment, scale_down

_PATTERN = tuple(
    Block("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

ARCH = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    segments=(Segment(_PATTERN, 9),),
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)

SMOKE = scale_down(ARCH)
