"""Config registry of the port: the dense Qwen2.5 configs and the MoE
configs (OLMoE-1B-7B, DeepSeekMoE-16B). ``get_config(name)`` returns the
full :class:`ArchConfig`."""
from __future__ import annotations

from . import deepseek_moe_16b, olmoe_1b_7b, qwen2_5_paper
from .base import ArchConfig, LoRAConfig, MoEConfig

REGISTRY = {c.name: c for c in (*qwen2_5_paper.CONFIGS, olmoe_1b_7b.CONFIG,
                                deepseek_moe_16b.CONFIG)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "LoRAConfig", "MoEConfig", "REGISTRY", "get_config"]
