"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064.
"""

from repro_torch.models.config import ArchConfig, dense_segments, scale_down

ARCH = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    segments=dense_segments(32),
)

SMOKE = scale_down(ARCH)
