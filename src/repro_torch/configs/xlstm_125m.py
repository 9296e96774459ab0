"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H vocab=50304, d_ff=0 (cells carry their own
projections). Pattern: 3 mLSTM (chunkwise-parallel matrix memory)
followed by 1 sLSTM (sequential scalar memory), repeated 3x — an xLSTM
[7:1]-style mix at 12-layer scale. Fully recurrent => long_500k capable.
"""

from repro_torch.models.config import ArchConfig, Block, Segment, scale_down

_PATTERN = (
    Block("mlstm", "none"),
    Block("mlstm", "none"),
    Block("mlstm", "none"),
    Block("slstm", "none"),
)

ARCH = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    segments=(Segment(_PATTERN, 3),),
    tie_embeddings=True,
)

SMOKE = scale_down(ARCH)
