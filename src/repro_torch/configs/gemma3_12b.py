"""Gemma3-12B [hf:google/gemma-3-1b-pt; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local(window=1024):global attention pattern, 128k context. head_dim=256.

Sub-quadratic eligible: 5/6 of layers are sliding-window; long_500k decode is
dominated by windowed layers and the 1/6 global layers attend over the sharded
KV cache (decode is O(cache) per token, not O(cache^2)).
"""
from .base import ArchConfig

# pattern entry 0 = global, >0 = sliding window
_PATTERN = (1024, 1024, 1024, 1024, 1024, 0)  # 5 local : 1 global

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    window_pattern=_PATTERN,
    notes="5:1 local:global, 128k [hf:google/gemma-3-1b-pt; unverified]",
)
