"""whisper-small [audio] — enc-dec with stubbed conv frontend
[arXiv:2212.04356].

Transformer backbone only: 12L encoder + 12L decoder, d_model=768 12H
(kv=12, MHA) d_ff=3072 vocab=51865. The mel-spectrogram + conv feature
extractor is a stub: ``input_specs`` provides precomputed frame features
(F, 128) which a learned projector lifts to d_model (sinusoidal positions
on the encoder). In the reference's design the decoder uses RoPE
instead of whisper's learned absolute embeddings.
"""

from repro_torch.models.config import ArchConfig, Block, Segment, scale_down

ARCH = ArchConfig(
    name="whisper-small",
    family="encdec",
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    segments=(Segment((Block("attn", "dense"),), 12),),
    encoder_segments=(Segment((Block("attn", "dense"),), 12),),
    encoder_max_frames=1500,
)

SMOKE = scale_down(ARCH)
