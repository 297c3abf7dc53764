"""MeSP training engine (``repro.core.mesp``, paper §4).

:func:`value_and_grad` is the production form: the model's loop over blocks
stores only block inputs (``torch.utils.checkpoint`` per block under
``policy.remat``) and every inner op is a hand-derived autograd Function
(``core/structured.py``; with the ``cuda`` backend the same rules through
the CUDA kernels of ``kernels/ops.py``), so one backward pass runs exactly
the paper's recompute schedule. LoRA gradients are applied once per step;
for SGD that equals the paper's immediate per-block update, because the
LoRA parameters of different blocks are disjoint.

The paper's §4.3 loop with an immediate update per block (the reference's
``sequential_train_step``, engine ``mesp_seq``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizers


def value_and_grad(params, cfg: ArchConfig, batch: dict, *,
                   policy: ExecutionPolicy = STRUCTURED):
    """(loss, grads over the LoRA factors): the grads tree has the params'
    nesting, with None at frozen leaves. ``params`` is left as it is: the
    trainable leaves are differentiated through detached copies. The
    frozen base's format must be ``policy.quantize``."""
    found = quant.tree_method(params)
    if found != policy.quantize:
        raise ValueError(f"the frozen base is {found!r} but "
                         f"policy.quantize is {policy.quantize!r}")
    leaves = []

    def lift(tree, mask):
        if isinstance(tree, dict):
            return {k: lift(tree[k], mask[k]) for k in tree}
        if not mask:
            return tree
        leaves.append(tree.detach().requires_grad_(True))
        return leaves[-1]

    def fill(mask, grads):
        if isinstance(mask, dict):
            return {k: fill(v, grads) for k, v in mask.items()}
        return next(grads) if mask else None

    mask = model_lib.trainable_mask(params)
    loss = model_lib.loss_fn(lift(params, mask), cfg, batch, policy=policy)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), fill(mask, iter(grads))


def train_step(params, cfg: ArchConfig, batch: dict, lr: float, *,
               policy: ExecutionPolicy = STRUCTURED):
    """One SGD step over the LoRA params. Returns (params, loss)."""
    loss, grads = value_and_grad(params, cfg, batch, policy=policy)
    return optimizers.sgd_apply(params, grads, lr), loss
