"""OLMoE-1B-7B [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304,
MoE 64 experts top-8, no shared experts.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024, n_shared=0),
    rope_theta=10000.0,
    notes="64 experts top-8 [arXiv:2409.02060; hf]",
)
