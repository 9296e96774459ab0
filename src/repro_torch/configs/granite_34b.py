"""granite-34b [dense] — MQA code model (non-gated GELU MLP) [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
"""

from repro_torch.models.config import ArchConfig, dense_segments, scale_down

ARCH = ArchConfig(
    name="granite-34b",
    family="dense",
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    segments=dense_segments(88),
    act="gelu",
)

SMOKE = scale_down(ARCH)
