"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE every layer:
32 experts, top-8, expert hidden 512 (the assignment's d_ff).
"""

from repro_torch.models.config import ArchConfig, Block, Segment, scale_down

ARCH = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    segments=(Segment((Block("attn", "moe"),), 24),),
    num_experts=32,
    num_experts_per_tok=8,
    moe_d_ff=512,
    tie_embeddings=True,
)

SMOKE = scale_down(ARCH)
