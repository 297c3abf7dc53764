"""Gradient compression for the data-parallel reduction
(``repro.optim.compression``).

LoRA gradients are already small (r·(d_in + d_out) a layer), but across
many ranks the all-reduce still costs. Two schemes, over trees with
``None`` at frozen leaves (``repro_torch/tree.py``):

* :func:`to_bf16` / :func:`from_bf16`: the payload cast to bf16 (half the
  bytes) and back to f32 for the accumulation after the reduce;
* :func:`topk_sparsify`: per leaf, keep the entries of largest magnitude
  with error feedback: what is not sent is carried to the next step, so
  nothing is lost across steps (Stich et al.). The reference's threshold
  semantics: k = max(1, int(size · frac)), and the mask keeps every entry
  with |x| ≥ the k-th largest |x|, so ties keep more than k.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, unflatten


def to_bf16(grads):
    return tree_map(lambda g: None if g is None else g.to(torch.bfloat16),
                    grads)


def from_bf16(grads):
    return tree_map(lambda g: None if g is None else g.to(torch.float32),
                    grads)


def topk_sparsify(grads, frac: float, error_state=None):
    """(sent, new error state): per leaf, ``acc = g + error`` (f32), the
    entries of ``acc`` with |acc| ≥ its k-th largest |acc| (k = max(1,
    int(size · frac))) sent, the rest kept as the new error state."""
    if error_state is None:
        error_state = tree_map(
            lambda g: None if g is None else torch.zeros_like(
                g, dtype=torch.float32), grads)

    def one(g, e):
        acc = g.to(torch.float32) + e
        k = max(1, int(acc.numel() * frac))
        flat = acc.reshape(-1)
        thresh = torch.topk(flat.abs(), k).values[-1]
        sent = (flat * (flat.abs() >= thresh).to(torch.float32)
                ).reshape(acc.shape)
        return sent, acc - sent

    outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(error_state))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))
