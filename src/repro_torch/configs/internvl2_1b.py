"""InternVL2-1B [arXiv:2404.16821; hf]: the language backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The InternViT
frontend is a stub, as in the reference: the caller hands in 256
precomputed patch embeddings, which are prepended to the text sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    frontend_tokens=256,
    notes="InternViT + InternLM2; vision frontend stubbed [arXiv:2404.16821; hf]",
)
