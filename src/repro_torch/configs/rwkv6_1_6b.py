"""RWKV6 (Finch) 1.6B [arXiv:2404.05892; unverified].

24L d_model=2048 attention-free (data-dependent decay WKV), d_ff=7168
channel-mix, vocab=65536. head count used only for WKV state blocking
(32 heads of dim 64).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # WKV head blocking
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    notes="Finch — data-dependent decay [arXiv:2404.05892; unverified]",
)
