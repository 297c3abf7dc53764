"""Weight bridge: the reference's parameter pytree, as numpy, to the port's
nested dict of tensors.

The caller converts the JAX tree to numpy arrays on its side
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX. Keys and shapes are kept as they are: stacked ``[L, ...]`` block
leaves, a window pattern's ``groups`` leaves ``[n_groups, period, ...]``,
``{"w", "a", "b"[, "bias"]}`` linears and ``AdapterStore``-stacked
``[L, R, d, r]`` adapter leaves all come through unchanged, and so do
quantized weight leaves (``core/quant.py``: ``{"q", "scale"}`` int8,
``{"q4", "scale"[, "code"][, "kpad"]}`` packed 4-bit): their integer bytes
keep their dtype, and their ``scale`` and ``code`` stay f32 whatever
``dtype`` is asked for, since they define the dequantization.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import quant

# numpy has no bfloat16; the JAX side hands bf16 leaves over as ml_dtypes'
# bfloat16, which numpy reports by name and torch cannot read directly
_BF16_NAMES = ("bfloat16",)


def _leaf(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name in _BF16_NAMES:
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def from_numpy_tree(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors on
    ``device``; floating leaves are cast to ``dtype`` when it is given,
    except inside a quantized weight leaf, which keeps its dtypes."""
    if isinstance(tree, dict):
        # a quantized leaf holds "scale" beside "q"/"q4"; a bare "q" key is
        # the attention's query linear
        if quant.is_quantized(tree) or quant.is_packed(tree):
            return {k: _leaf(v, device, None) for k, v in tree.items()}
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)


def to_numpy_tree(tree):
    """The port's tree back to numpy (f32 for bf16 leaves), for comparisons."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
