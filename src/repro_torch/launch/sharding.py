"""Placement rules for the (pod, data, model) mesh (``repro.launch.
sharding``): which dim of each leaf lies on which mesh axis.

Megatron-style tensor parallelism on the ``model`` axis, as in the
reference:

* column-parallel: q/k/v projections, MLP gate/up (the weight's output
  dim on ``model``);
* row-parallel: the o projection, MLP down (the input dim on ``model``);
* expert-parallel: MoE expert stacks on their leading E dim;
* LoRA factors: the factor dim touching a sharded weight dim is sharded
  the same way; the rank dim is always replicated;
* a vocab-parallel embedding and logits.

Activations: batch on the data axes, and between blocks the sequence on
``model`` (Megatron sequence parallelism, :func:`activation_spec`).

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names, or None (replicated), the port's counterpart of a
``jax.sharding.PartitionSpec``; ``()`` is a replicated scalar. The
functions walk the port's trees (``repro_torch/tree.py``: dicts and lists)
and return a tree of specs with the same nesting (None where the tree has
None). A mesh is anything with a ``shape`` mapping axis names to sizes
(``runtime.elastic.DeviceMesh``).

The rules are the reference's for every family; the port executes those of
the dense family (``models/parallel.py``), and refuses the others at a
model axis above 1 (``api/spec.py``). One difference by design: where the
reference's :func:`_guard` quietly replicates a leaf whose dim the model
axis does not divide, and GSPMD reshards it mid-head, the port refuses
such a mesh up front (``TrainSpec.validate``), since its hand-written
kernels cannot split a head (``ROADMAP.md`` §3).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.tree import tree_map_with_path

MODEL = "model"

# projections whose weight is column-parallel ([d_in, d_out·shard]) keyed by
# their parent dict name; row-parallel analogously
_COL = {"q", "k", "v", "gate", "up", "x_proj", "gate_proj", "rg_w", "in_w",
        "g", "w"}
_ROW = {"o", "down", "out_proj"}
# rwkv channel-mix reuses k/v/r names with different roles
_CM_COL = {"k", "r"}
_CM_ROW = {"v"}


def _trailing_spec(keys, leaf) -> Tuple:
    """The spec of a leaf's trailing dims from its path ``keys``."""
    last = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else None
    in_moe = "moe" in keys
    in_cm = "cm" in keys

    if last == "tok":
        return (MODEL, None)            # vocab-parallel embedding
    if last == "head":
        return (None, MODEL)            # vocab-parallel logits
    if last == "router":
        return (None, None)

    # quantized frozen weight: ``w`` became {"q", "scale"} or {"q4",
    # "scale"[, "code", "kpad"]}; q/q4 keep w's layout, scale is
    # [..., 1, d_out] (the guard drops an axis on its size-1 dim)
    if last in ("q", "q4", "scale") and parent == "w":
        return _trailing_spec(keys[:-1], leaf)
    # the nf4 codebook and the odd-K parity marker are replicated
    if last in ("code", "kpad") and parent == "w":
        return (None,)

    if in_moe and last in ("w", "a", "b") and parent in ("gate", "up", "down") \
            and hasattr(leaf, "ndim"):
        return (MODEL, None, None)      # expert-parallel stacks [E, ·, ·]

    col = (parent in _CM_COL) if in_cm else (parent in _COL)
    row = (parent in _CM_ROW) if in_cm else (parent in _ROW)

    if last == "w" and (col or row):
        return (None, MODEL) if col else (MODEL, None)
    if last == "a":                     # LoRA A: [d_in, r]
        return (MODEL, None) if row else (None, None)
    if last == "b":                     # LoRA B: [r, d_out]
        return (None, MODEL) if col else (None, None)
    if last == "bias":
        return (MODEL,) if col else (None,)
    # norms, token-shift mixes, decay vectors, conv weights: replicated
    return tuple([None] * getattr(leaf, "ndim", 1))


def _axis_size(mesh, axis) -> int:
    """The ranks along ``axis``: a name, a tuple of names, or None (1)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _guard(spec_dims, leaf, mesh):
    """Drop axes whose size does not divide the dim they would split (the
    reference's rule; the port refuses such meshes before it places
    anything, ``api/spec.py``)."""
    if mesh is None:
        return tuple(spec_dims)
    shape = getattr(leaf, "shape", ())
    out = []
    for i, ax in enumerate(spec_dims):
        if ax is not None and i < len(shape) and \
                shape[i] % _axis_size(mesh, ax) != 0:
            out.append(None)
        else:
            out.append(ax)
    return tuple(out)


def _leaf_spec(keys, leaf, mesh):
    t = _trailing_spec(keys, leaf)
    nd = leaf.ndim
    extra = nd - len(t)
    if extra < 0:     # a vector matched a matrix rule (defensive)
        return tuple([None] * nd)
    return _guard(tuple([None] * extra + list(t)), leaf, mesh)


def param_specs(cfg, params, mesh=None) -> Any:
    """The spec tree of ``params`` (stacked leading dims take None). With
    ``mesh``, an axis that does not divide its dim is dropped."""
    def one(path, leaf):
        if leaf is None:
            return None
        return _leaf_spec(list(path), leaf, mesh)

    return tree_map_with_path(one, params)


def opt_specs(cfg, opt_state, mesh=None) -> Any:
    """Optimizer state: scalars replicated; moment trees mirror the param
    specs (their ``m`` / ``v`` keys dropped from the path)."""
    def one(path, leaf):
        if leaf is None:
            return None
        if getattr(leaf, "ndim", 0) == 0:
            return ()
        keys = list(path)
        return _leaf_spec([k for k in keys if k not in ("m", "v")] or keys,
                          leaf, mesh)

    return tree_map_with_path(one, opt_state)


def opt_specs_like(opt_state, pspecs) -> Any:
    """Specs of ``opt_state`` from its params' spec tree ``pspecs``: each
    moment leaf takes the spec of its parameter (its path past the moment
    tree's key, ``m`` or ``v``); scalars are replicated. The port places
    optimizer state by these. :func:`opt_specs`, the reference's rule,
    drops every ``m`` or ``v`` key of a path, the value projection's too,
    so it gives ``attn/v``'s moments the specs of ``attn``'s own leaves;
    a moment must lie as its parameter does (``ROADMAP.md`` §3)."""
    def one(path, leaf):
        if leaf is None:
            return None
        if getattr(leaf, "ndim", 0) == 0:
            return ()
        spec = pspecs
        for k in path[1:]:
            spec = spec[k]
        return spec

    return tree_map_with_path(one, opt_state)


def dp_axes(mesh) -> Tuple:
    """The composed data-parallel axes of a mesh: ('pod', 'data') or
    ('data',)."""
    return tuple(a for a in mesh.shape if a in ("pod", "data"))


def _dp_size(mesh) -> int:
    return _axis_size(mesh, dp_axes(mesh))


def batch_spec(mesh, global_batch: int) -> Tuple:
    """The batch on the data axes when they divide it, else replicated."""
    dp = dp_axes(mesh)
    size = _dp_size(mesh)
    if global_batch % size == 0 and global_batch >= size:
        return (dp,)
    return ()


def cache_specs(cfg, cache, mesh, global_batch: int) -> Any:
    """Decode-state placement: the batch on the data axes when they divide
    it; KV heads on ``model`` when it divides them, else the cache's
    sequence dim on ``model``; batch-1 long-context decode puts the
    sequence dim on the data axes too. (Decode under a mesh is not run by
    the port yet, ``ROADMAP.md`` §1, item 3.)"""
    dp = dp_axes(mesh)
    size = _dp_size(mesh)
    batch_on_dp = global_batch % size == 0 and global_batch >= size
    bspec = dp if batch_on_dp else None
    heads_divisible = cfg.n_kv_heads % mesh.shape[MODEL] == 0
    s_axes = []
    if not batch_on_dp:
        s_axes.extend(dp)
    if not heads_divisible:
        s_axes.append(MODEL)
    sspec = tuple(s_axes) if s_axes else None
    hspec = MODEL if heads_divisible else None

    def one(path, leaf):
        if leaf is None:
            return None
        last = path[-1]
        nd = getattr(leaf, "ndim", 0)
        if last in ("k", "v") and nd >= 4:
            t = (bspec, hspec, sspec, None)       # [..., B, Hkv, S, D]
        elif last == "wkv" and nd >= 4:
            t = (bspec, MODEL, None, None)        # [B, H, D, D]
        elif last in ("shift_tm", "shift_cm", "lru") and nd >= 2:
            t = (bspec, MODEL)
        elif last == "conv" and nd >= 3:
            t = (bspec, None, MODEL)
        elif last == "enc_out" and nd >= 3:
            t = (bspec, None, None)
        elif last == "len":
            return ()
        else:
            return tuple([None] * nd)
        extra = nd - len(t)
        return _guard(tuple([None] * extra + list(t)), leaf, mesh)

    return tree_map_with_path(one, cache)


def activation_spec(mesh, global_batch: int, *,
                    seq_on_model: bool = True) -> Tuple:
    """Block-boundary activations [B, N, d]: the batch on the data axes
    and, Megatron SP, the sequence on ``model``."""
    b = batch_spec(mesh, global_batch)
    return (b[0] if b else None, MODEL if seq_on_model else None, None)


def row_parallel(path) -> bool:
    """True for the path of a row-parallel frozen weight (``[..., proj,
    "w"]`` with its input dim on ``model``)."""
    keys = list(path)
    if len(keys) < 2 or keys[-1] != "w" or "moe" in keys:
        return False
    return keys[-2] in (_CM_ROW if "cm" in keys else _ROW)


def model_dim(spec) -> Optional[int]:
    """The dim a spec puts on ``model`` (alone, not composed), or None."""
    for i, ax in enumerate(spec or ()):
        if ax == MODEL:
            return i
    return None
