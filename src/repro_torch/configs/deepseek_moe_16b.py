"""DeepSeekMoE-16B [arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=102400,
2 shared + 64 routed top-6 (fine-grained experts), first layer dense FFN.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_expert=1408, n_shared=2,
        first_layer_dense=True,
    ),
    notes="2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066; hf]",
)
