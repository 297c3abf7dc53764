"""Whisper-tiny [arXiv:2212.04356; unverified]: the encoder-decoder
transformer backbone.

4L (decoder) d_model=384 6H d_ff=1536 vocab=51865; 4 encoder layers over
1500 precomputed mel-frame embeddings (the convolutional frontend is a
stub, as in the reference). The decoder has causal self-attention (cached
in decode) and cross-attention over the encoder's output.
"""
from .base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    encdec=EncDecConfig(encoder_layers=4, encoder_seq=1500),
    notes="enc-dec, conv frontend stubbed [arXiv:2212.04356; unverified]",
)
