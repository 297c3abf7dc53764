"""Optimizers over sparse (LoRA-only) gradient trees
(``repro.optim.optimizers``).

Gradient trees from the engines have ``None`` at frozen leaves, so state is
kept for the trainable parameters only. The port has plain SGD, the
paper's optimizer (§5.1, lr 1e-4) and the training default; the
reference's ``sgd_momentum`` and ``adamw`` are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

OPTIMIZERS = ("sgd",)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (params, state)


@torch.no_grad()
def sgd_apply(params, grads, lr: float):
    """``p - lr · g`` (g cast to p's dtype) where g is not None; frozen
    leaves are returned as they are."""
    if isinstance(params, dict):
        return {k: sgd_apply(params[k], grads[k], lr) for k in params}
    return params if grads is None else params - lr * grads.to(params.dtype)


def sgd(lr) -> Optimizer:
    """Plain SGD; ``lr`` a float or a schedule step -> float."""
    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        return sgd_apply(params, grads, lr_t), {"step": step}

    return Optimizer(init, update)


def make_optimizer(name: str, lr) -> Optimizer:
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; the port has "
            f"{OPTIMIZERS}")
    return sgd(lr)
