"""MeSP training engines (``repro.core.mesp``, paper §4).

Two forms, with the same gradients:

1. :func:`value_and_grad` is the production form: the model's loop over blocks
stores only block inputs (``torch.utils.checkpoint`` per block under
``policy.remat``) and every inner op is a hand-derived autograd Function
(``core/structured.py``; with the ``cuda`` backend the same rules through
the CUDA kernels of ``kernels/ops.py``), so one backward pass runs exactly
the paper's recompute schedule. LoRA gradients are applied once per step;
for SGD that equals the paper's immediate per-block update, because the
LoRA parameters of different blocks are disjoint.

2. :func:`sequential_train_step` is the paper's §4.3 loop verbatim (engine
   ``mesp_seq``): a reverse Python loop over blocks, each recomputed from
   its stored input, its LoRA gradients taken with ``torch.autograd.grad``
   and SGD applied at once, before the next block's backward.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant, structured
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models import parallel
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map


def _check_base(params, policy: ExecutionPolicy) -> None:
    found = quant.tree_method(params)
    if found != policy.quantize:
        raise ValueError(f"the frozen base is {found!r} but "
                         f"policy.quantize is {policy.quantize!r}")


def _lift(tree, mask, leaves):
    """``tree`` with each LoRA leaf (or view) replaced by a detached leaf that
    needs grad (appended to ``leaves``)."""
    def lift(t, m):
        if not m:
            return t
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    return tree_map(lift, tree, mask)


def value_and_grad(params, cfg: ArchConfig, batch: dict, *,
                   policy: ExecutionPolicy = STRUCTURED):
    """(loss, grads over the LoRA factors): the grads tree has the params'
    nesting, with None at frozen leaves. ``params`` is left as it is: the
    trainable leaves are differentiated through detached copies. The
    frozen base's format must be ``policy.quantize``.

    Under a model axis (``policy.tp``) ``params`` are this rank's shards,
    and the LoRA leaves of which each rank holds a part of the gradient
    (column-parallel A, row-parallel B: ``models/parallel.py``) are summed
    over the axis here, in one f32 buffer, so the grads returned are this
    rank's shards of the whole gradient (before any data-axis sync)."""
    _check_base(params, policy)

    def fill(mask, grads):
        return tree_map(lambda m: next(grads) if m else None, mask)

    mask, leaves = model_lib.trainable_mask(params), []
    loss = model_lib.loss_fn(_lift(params, mask, leaves), cfg, batch,
                             policy=policy)
    grads = fill(mask, iter(torch.autograd.grad(loss, leaves)))
    return loss.detach(), parallel.sum_partials(grads, policy.tp)


def train_step(params, cfg: ArchConfig, batch: dict, lr: float, *,
               policy: ExecutionPolicy = STRUCTURED):
    """One SGD step over the LoRA params. Returns (params, loss)."""
    loss, grads = value_and_grad(params, cfg, batch, policy=policy)
    return optimizers.sgd_apply(params, grads, lr), loss


def _lora_copy(tree, mask):
    """``tree`` with its LoRA leaves copied (the step's output) and its
    frozen leaves shared."""
    return tree_map(lambda t, m: t.clone() if m else t, tree, mask)


def _views(tree, mask):
    """The LoRA leaves of a block's tree of views, in ``_lift``'s order."""
    return tree_leaves(tree_map(lambda t, m: t if m else None, tree, mask))


def sequential_train_step(params, cfg: ArchConfig, batch: dict, lr: float,
                          *, policy: ExecutionPolicy = STRUCTURED):
    """Paper §4.3: the forward stores only block inputs; the backward walks
    the blocks in reverse, recomputes each from its input, takes its LoRA
    gradients and applies SGD to them at once. Dense family without a
    window pattern only, as in the reference. Returns
    (params, loss); ``params`` is left as it is.

    Block 0's input, the frozen embedding, needs no gradient, so block 0
    runs no input-gradient work (as in :func:`value_and_grad`). The
    updates go, under ``no_grad``, into rows of copies of the stacked LoRA
    leaves made once per step; nothing of block i's graph or gradients
    outlives its iteration. Under a data axis (``policy.dp``) each block's
    LoRA gradients are all-reduced over it before that block's update, and
    the returned loss is the global batch's."""
    if policy.tp is not None:
        raise ValueError("sequential_train_step (mesp_seq) does not run "
                         "under a model axis yet (ROADMAP.md §1, item 3)")
    if cfg.family != "dense" or cfg.window_pattern:
        raise ValueError("sequential_train_step runs the dense family "
                         "without a window pattern only, not "
                         f"{cfg.name!r} ({cfg.family})")
    _check_base(params, policy)
    dp = policy.dp
    w = dp.weight(batch["labels"]) if dp is not None else None
    mask = model_lib.trainable_mask(params["blocks"])
    blocks = _lora_copy(params["blocks"], mask)
    n = blocks["ln1"].shape[0]

    def block(bp, x):
        return model_lib.dense_block(bp, x, cfg, cache=None,
                                     policy=policy)[0]

    # forward: store only the block inputs
    with torch.no_grad():
        x = layers.embed(params["embed"], batch["tokens"], cfg)
        inputs = []
        for i in range(n):
            inputs.append(x)
            x = block(model_lib._layer(blocks, i), x)

    # head: the loss and its gradient at the last block's output
    with torch.enable_grad():
        x = x.requires_grad_(True)
        xn = layers.norm(params["final_norm"], x, cfg, policy=policy)
        loss = structured.softmax_xent(
            layers.unembed(params["embed"], xn, cfg), batch["labels"])
        (g,) = torch.autograd.grad(loss, x)
    del x, xn

    # backward: reverse loop, recompute, update at once
    for i in reversed(range(n)):
        bp = model_lib._layer(blocks, i)
        leaves = []
        with torch.enable_grad():
            xi = inputs[i].requires_grad_(i > 0)
            y = block(_lift(bp, mask, leaves), xi)
            grads = torch.autograd.grad(y, leaves + [xi] * (i > 0), g)
        del y
        lora = grads[:len(leaves)]
        if dp is not None:
            lora = dp.all_reduce(lora, w)
        with torch.no_grad():
            for p, gp in zip(_views(bp, mask), lora):
                p.sub_(lr * gp.to(p.dtype))
        g = grads[-1] if i > 0 else None
        inputs[i] = None
        del grads, lora, leaves, bp, xi
    loss = loss.detach()
    if dp is not None:
        loss = dp.all_reduce([loss.reshape(1)], w)[0].reshape(loss.shape)
    return {**params, "blocks": blocks}, loss
