"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000,
RG-LRU recurrent blocks : local attention 2:1 (pattern R,R,A), window 2048.
"""
from .base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("R", "R", "A"), lru_width=2560, window=2048),
    notes="RG-LRU + local attn, 2:1 [arXiv:2402.19427; hf]",
)
