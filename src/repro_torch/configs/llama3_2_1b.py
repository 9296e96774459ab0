"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, head_dim 64,
RoPE + SwiGLU, tied embeddings. ``ARCH_SW`` is the sliding-window (8192)
variant used for the long_500k decode shape (DESIGN.md §4).
"""

import dataclasses

from repro_torch.models.config import ArchConfig, dense_segments, scale_down

ARCH = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    segments=dense_segments(16),
    rope_theta=500000.0,
    tie_embeddings=True,
)

ARCH_SW = dataclasses.replace(ARCH, name="llama3.2-1b-sw",
                              sliding_window=8192)

SMOKE = scale_down(ARCH)
SMOKE_SW = dataclasses.replace(scale_down(ARCH_SW), sliding_window=64)
