"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409].

Decoder backbone only (the assignment's carve-out): 40L d_model=5120 32H
(GQA kv=8, head_dim=128) d_ff=14336 vocab=131072. The ViT frontend is a
stub — ``input_specs`` provides 1024 precomputed patch embeddings that a
learned projector maps into d_model and prepends to the text tokens.
"""

from repro_torch.models.config import ArchConfig, dense_segments, scale_down

ARCH = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    segments=dense_segments(40),
    rope_theta=1000000.0,
    num_image_tokens=1024,
)

SMOKE = scale_down(ARCH)
