"""Config registry of the port: the dense Qwen2.5 configs so far.
``get_config(name)`` returns the full :class:`ArchConfig`."""
from __future__ import annotations

from . import qwen2_5_paper
from .base import ArchConfig, LoRAConfig

REGISTRY = {c.name: c for c in qwen2_5_paper.CONFIGS}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "LoRAConfig", "REGISTRY", "get_config"]
