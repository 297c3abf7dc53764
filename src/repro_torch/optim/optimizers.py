"""Optimizers over sparse (LoRA-only) gradient trees
(``repro.optim.optimizers``).

Gradient trees from the engines have ``None`` at frozen leaves, so state is
kept for the trainable parameters only: a moment is made (in f32, on the
parameter's device) the first time its leaf has a gradient, and stays
``None`` elsewhere. Plain SGD is the paper's optimizer (§5.1, lr 1e-4) and
the training default; ``sgd_momentum`` and ``adamw`` keep their moments in
f32 whatever the parameter dtype and cast the update back on apply.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_map

OPTIMIZERS = ("sgd", "sgd_momentum", "adamw")


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (params, state)


def _lr(lr, step):
    return lr(step) if callable(lr) else lr


@torch.no_grad()
def sgd_apply(params, grads, lr: float):
    """``p - lr · g`` (g cast to p's dtype) where g is not None; frozen
    leaves are returned as they are."""
    return tree_map(lambda p, g: p if g is None else p - lr * g.to(p.dtype),
                params, grads)


def sgd(lr) -> Optimizer:
    """Plain SGD; ``lr`` a float or a schedule step -> float."""
    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        return sgd_apply(params, grads, _lr(lr, step)), {"step": step}

    return Optimizer(init, update)


def sgd_momentum(lr, beta: float = 0.9) -> Optimizer:
    """``m = beta · m + g``, ``p - lr · m``."""
    def init(params):
        return {"step": 0, "m": None}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr(lr, step)
        m = tree_map(lambda g, m_, p: None if g is None else
                 beta * (m_ if m_ is not None else
                         torch.zeros_like(p, dtype=torch.float32))
                 + g.float(), grads, state["m"], params)
        new = tree_map(lambda p, mi: p if mi is None else
                   (p - lr_t * mi).to(p.dtype), params, m)
        return new, {"step": step, "m": m}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction and decoupled ``weight_decay``."""
    def init(params):
        return {"step": 0, "m": None, "v": None}

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr(lr, step)
        m = tree_map(lambda g, m_, p: None if g is None else
                 b1 * (m_ if m_ is not None else zeros(p))
                 + (1 - b1) * g.float(), grads, state["m"], params)
        v = tree_map(lambda g, v_, p: None if g is None else
                 b2 * (v_ if v_ is not None else zeros(p))
                 + (1 - b2) * g.float().square(), grads, state["v"], params)
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step

        def apply(p, mi, vi):
            if mi is None:
                return p
            upd = (mi / c1) / ((vi / c2).sqrt() + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p - lr_t * upd).to(p.dtype)

        return tree_map(apply, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; expected one of "
                         f"{OPTIMIZERS}")
    return {"sgd": sgd, "sgd_momentum": sgd_momentum,
            "adamw": adamw}[name](lr, **kw)
