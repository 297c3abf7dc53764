"""The paper's own model family: Qwen2.5 0.5B / 1.5B / 3B [Qwen Team 2024].

LoRA rank 8 on q,k,v,o,gate,up,down per the paper's §5.1.
"""
from .base import ArchConfig

CONFIGS = [
    ArchConfig(
        name="qwen2.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151936,
        head_dim=64,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        notes="paper model (Table 1 row 1)",
    ),
    ArchConfig(
        name="qwen2.5-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        head_dim=128,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        notes="paper model (Table 1 row 2)",
    ),
    ArchConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab=151936,
        head_dim=128,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        notes="paper model (Table 1 row 3)",
    ),
]
