"""Architecture configuration (the port's own copy of ``repro.configs.base``).

Only what the dense Qwen2.5 serving path reads is kept: :class:`LoRAConfig`
and the dense fields of :class:`ArchConfig`, with the same ``reduced()``
cut to size as the reference, so a reduced config names the same shapes in
both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LoRAConfig:
    """Paper setup: rank 8, alpha 16, applied to q,k,v,o,gate,up,down."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # d_model // n_heads unless overridden
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config (the reference's cut for dense archs)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            dtype="float32",
            lora=LoRAConfig(rank=4, alpha=8.0, targets=self.lora.targets),
        )
