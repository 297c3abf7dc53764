"""Config registry of the port: the dense configs (the paper's Qwen2.5
0.5B-3B, Granite-8B, Minitron-4B, Qwen2.5-32B and Gemma3-12B with its 5:1
local:global pattern), the MoE configs (OLMoE-1B-7B, DeepSeekMoE-16B), the
attention-free RWKV6-1.6B (``ssm``), RecurrentGemma-2B (``hybrid``:
RG-LRU and local attention, R,R,A), InternVL2-1B (``vlm``: patch
embeddings ahead of the text) and Whisper-tiny (``audio``: an encoder over
mel frames and a cross-attending decoder). ``get_config(name)`` returns
the full :class:`ArchConfig`."""
from __future__ import annotations

from . import (deepseek_moe_16b, gemma3_12b, granite_8b, internvl2_1b,
               minitron_4b, olmoe_1b_7b, qwen2_5_32b, qwen2_5_paper,
               recurrentgemma_2b, rwkv6_1_6b, whisper_tiny)
from .base import ArchConfig, EncDecConfig, HybridConfig, LoRAConfig, MoEConfig

REGISTRY = {c.name: c for c in (
    *qwen2_5_paper.CONFIGS, olmoe_1b_7b.CONFIG, deepseek_moe_16b.CONFIG,
    granite_8b.CONFIG, gemma3_12b.CONFIG, qwen2_5_32b.CONFIG,
    minitron_4b.CONFIG, internvl2_1b.CONFIG, whisper_tiny.CONFIG,
    rwkv6_1_6b.CONFIG, recurrentgemma_2b.CONFIG)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "EncDecConfig", "HybridConfig", "LoRAConfig",
           "MoEConfig", "REGISTRY", "get_config"]
