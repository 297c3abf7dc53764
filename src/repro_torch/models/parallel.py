"""Megatron tensor and sequence parallelism on the model axis: the
collectives as autograd Functions, the vocab-parallel embedding, and the
model-axis sum of the LoRA gradients that each rank holds only a part of.

The reference leaves these to XLA's SPMD partitioner, which inserts them
from the placement rules (``launch/sharding.py``). The port writes them
out around the dense family's linears (``models/layers.py``), each over
``runtime.elastic.ModelParallel`` (``policy.tp``), which counts the bytes
it hands over:

* :func:`copy_to` (identity forward, all-reduce backward) before a
  column-parallel linear whose input is replicated, and :func:`reduce_from`
  (all-reduce forward, identity backward) after a row-parallel one;
* with sequence parallelism (``policy.sp``), the activations between the
  linears hold this rank's part of the sequence: :func:`gather_seq`
  (all-gather along the sequence forward, reduce-scatter backward) before
  a column-parallel linear, :func:`scatter_seq` (reduce-scatter forward,
  all-gather backward) after a row-parallel one;
* :func:`vocab_embed`: the rows of the token table this rank holds
  (``tok`` is vocab-parallel), zero for the others, then summed over the
  axis (reduce-scattered along the sequence under SP).

Where MeSP meets the model axis. The LoRA kernels are unchanged; each
rank runs them on its shards:

* a column-parallel linear (q, k, v, gate, up): x is whole, A is
  replicated and B holds this rank's columns, so ``dA = xᵀ·(s·g_s·B_sᵀ)``
  is this rank's part of a sum over the axis, while ``dB_s`` is complete;
* a row-parallel linear (o, down): x and A hold this rank's rows and B is
  replicated; the recomputed ``h = x_s·A_s`` is itself a part of a sum,
  so ``dB = s·hᵀ·g`` is a part, while ``dA_s`` is complete (g is whole
  after the backward of the reduce-scatter).

:func:`sum_partials` sums those leaves (:func:`partial_lora`) over the
axis once a step, in one f32 buffer, before the data axis's sync
(``core/mesp.value_and_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.sharding import _CM_COL, _CM_ROW, _COL, _ROW
from repro_torch.tree import leaves_with_paths, tree_map_with_path


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_scatter(g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, ctx.dim), None, None


def copy_to(x, tp):
    """Identity forward, all-reduce of the gradient backward."""
    return _CopyTo.apply(x, tp)


def reduce_from(x, tp):
    """All-reduce forward, identity backward."""
    return _ReduceFrom.apply(x, tp)


def gather_seq(x, tp, dim: int = 1):
    """All-gather along the sequence forward, reduce-scatter backward."""
    return _GatherSeq.apply(x, tp, dim)


def scatter_seq(x, tp, dim: int = 1):
    """Reduce-scatter along the sequence forward, all-gather backward."""
    return _ScatterSeq.apply(x, tp, dim)


def enter(x, policy):
    """The input of a block's column-parallel linears from a block-boundary
    activation: gathered along the sequence under SP, else copied."""
    tp = policy.tp
    if tp is None:
        return x
    return gather_seq(x, tp) if policy.sp else copy_to(x, tp)


def leave(y, policy):
    """A row-parallel linear's partial output summed over the axis:
    reduce-scattered along the sequence under SP, else all-reduced."""
    tp = policy.tp
    if tp is None:
        return y
    return scatter_seq(y, tp) if policy.sp else reduce_from(y, tp)


def vocab_embed(tok, tokens, policy):
    """Token rows from this rank's vocab shard ``tok`` [V/mp, d]: the rows
    of tokens it holds, zero for the others, summed over the axis (exact:
    one rank holds each row), reduce-scattered along the sequence under
    SP."""
    tp = policy.tp
    v = tok.shape[0]
    local = tokens - tp.index * v
    inside = (local >= 0) & (local < v)
    x = tok[local.clamp(0, v - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return leave(x, policy)


def partial_lora(path) -> bool:
    """True for a LoRA leaf whose gradient each rank holds only a part of:
    A of a column-parallel linear, B of a row-parallel one (the placement
    rules of ``launch/sharding.py``; an MoE expert stack is
    expert-parallel, not split, and never partial)."""
    if len(path) < 2 or path[-1] not in ("a", "b") or "moe" in path:
        return False
    parent, in_cm = path[-2], "cm" in path
    col = parent in (_CM_COL if in_cm else _COL)
    row = parent in (_CM_ROW if in_cm else _ROW)
    return (path[-1] == "a" and col) or (path[-1] == "b" and row)


def sum_partials(grads, tp):
    """``grads`` with its :func:`partial_lora` leaves summed over the model
    axis, in one f32 buffer (each back in its dtype); the other leaves as
    they are."""
    if tp is None or tp.size == 1:
        return grads
    part = [(p, g) for p, g in leaves_with_paths(grads) if partial_lora(p)]
    if not part:
        return grads
    flat = tp.all_reduce(torch.cat([g.reshape(-1).to(torch.float32)
                                    for _, g in part]))
    out, i = {}, 0
    for p, g in part:
        out[p] = flat[i:i + g.numel()].reshape(g.shape).to(g.dtype)
        i += g.numel()
    return tree_map_with_path(lambda p, g: out.get(p, g), grads)


def partial_numel(tree) -> int:
    """Elements of ``tree``'s :func:`partial_lora` leaves (one rank's
    share of the model-axis gradient sum)."""
    return sum(t.numel() for p, t in leaves_with_paths(tree)
               if partial_lora(p))
