"""Gradient-quality analysis (``repro.core.gradcheck``, paper §5.6, Table 3).

Compares a gradient estimate with the exact gradient, over the whole tree
and per layer: cosine similarity, sign agreement, relative error. The
paper's finding: MeZO's estimates are essentially uncorrelated with the
true gradients (cosine ≈ 0.001, sign agreement ≈ 50 %).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.tree import tree_leaves, tree_map


def _leaves(tree):
    """Leaves in sorted-key order (the reference's flatten order), None
    skipped."""
    return tree_leaves(tree, sort=True)


def _flat_concat(tree) -> torch.Tensor:
    leaves = [t.reshape(-1).float() for t in _leaves(tree)]
    return torch.cat(leaves) if leaves else torch.zeros(0)


def gradient_metrics(g_est, g_true) -> Dict[str, torch.Tensor]:
    """Cosine similarity, sign agreement and relative error (0-d f32
    tensors) of two trees of the same nesting."""
    a, b = _flat_concat(g_est), _flat_concat(g_true)
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    cos = torch.dot(a, b) / torch.clamp_min(na * nb, 1e-30)
    sign = (torch.sign(a) == torch.sign(b)).float().mean()
    rel = torch.linalg.vector_norm(a - b) / torch.clamp_min(nb, 1e-30)
    return {"cosine_sim": cos, "sign_agree": sign, "rel_error": rel}


def _row(tree, i: int):
    return tree_map(lambda t: None if t is None else t[i], tree)


def per_layer_metrics(g_est_blocks, g_true_blocks,
                      n_layers: int) -> List[dict]:
    """Table 3: the metrics per transformer layer of stacked [L, ...] block
    gradients, as floats with ``layer``."""
    out = []
    for i in range(n_layers):
        m = gradient_metrics(_row(g_est_blocks, i), _row(g_true_blocks, i))
        out.append({k: float(v) for k, v in m.items()} | {"layer": i})
    return out
