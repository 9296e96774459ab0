"""deepseek-v3-671b [moe] — MLA + 1 shared/256 routed top-8 + MTP
[arXiv:2412.19437].

61L d_model=7168 128H vocab=129280. MLA: q_lora 1536, kv_lora 512,
qk_nope 128, qk_rope 64, v_head 128 (the latent cache is the serving
memory win). FFN: first 3 layers dense (hidden 18432, per the paper);
remaining 58 layers MoE with 256 routed experts (hidden 2048 — the
assignment's d_ff) top-8 plus 1 shared expert. MTP depth 1.
"""

from repro_torch.models.config import ArchConfig, Block, Segment, scale_down

ARCH = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    segments=(
        Segment((Block("attn", "dense"),), 3),
        Segment((Block("attn", "moe"),), 58),
    ),
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    mtp_depth=1,
)

SMOKE = scale_down(ARCH)
