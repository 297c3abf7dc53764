"""MeBP baseline (``repro.core.mebp``, paper §3.3): the same model and
per-block checkpointing, but every inner op under the ``plain`` backend, so
autograd decides what to keep: ``h = x @ A``, the attention probabilities
and the normalised activations are saved. The memory gap between this and
MeSP is the paper's measurement."""
from __future__ import annotations

from repro_torch.api.policy import PLAIN
from repro_torch.configs.base import ArchConfig
from repro_torch.core import mesp


def value_and_grad(params, cfg: ArchConfig, batch: dict):
    return mesp.value_and_grad(params, cfg, batch, policy=PLAIN)


def train_step(params, cfg: ArchConfig, batch: dict, lr: float):
    return mesp.train_step(params, cfg, batch, lr, policy=PLAIN)
