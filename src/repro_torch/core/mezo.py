"""MeZO baseline (``repro.core.mezo``, paper §3.2): the historical entry
points over ``repro_torch.zo`` (the dense sampler, one query).

The estimator lives in ``zo/`` (samplers, estimator, the ``mezo*``
engines); Table 3's metrics in ``core/gradcheck.py``; the engine-vs-exact
probe in ``zo/gradquality.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.zo import estimator as _estimator


def spsa_grad(params, cfg: ArchConfig, batch: dict, seed: int,
              eps: float = 1e-3):
    """MeZO gradient estimate over the LoRA params: ((L₊ − L₋)/2ε) · z."""
    return _estimator.spsa_grad(params, cfg, batch, seed, eps=eps)


def train_step(params, cfg: ArchConfig, batch: dict, seed: int, lr: float,
               eps: float = 1e-3):
    return _estimator.train_step(params, cfg, batch, seed, lr, eps)
