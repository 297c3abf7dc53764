"""Quantized frozen base weights (``repro.core.quant``): int8 and packed
sub-8-bit (int4 / nf4), in PyTorch.

The paper keeps the frozen base QLoRA-style in 4 bits and dequantizes it on
the fly (§4.5). Only frozen ``w`` leaves quantize; LoRA factors, biases,
norms and embeddings stay in the model's dtype. On the ``cuda`` backend the
quantized kernels (``kernels/lora_quant.py``, ``kernels/lora_pack4.py``)
read these bytes and the scale row and never write a dense float W0 to
device memory; the other backends dequantize first (:func:`maybe_dequant`).

The formats are byte for byte the reference's, so a tree quantized by
either package bridges to the other unchanged (plain dicts):

* int8: ``{"q": int8 [..., K, N], "scale": f32 [..., 1, N]}``, symmetric
  per output channel, ``W0 = q · scale``;
* int4: ``{"q4": uint8 [..., ceil(K/2), N], "scale": f32 [..., 1, N]}``,
  q in [-7, 7] two's complement, ``W0 = q · scale``;
* nf4: the int4 layout plus ``"code": f32 [..., 16]`` (the codebook; its
  presence marks the method), ``W0 = code[nibble] · scale``.

``q4`` byte row ``j`` holds input row ``2j`` in its low nibble and ``2j+1``
in its high nibble. Odd K pads the last high nibble with the format's
encoding of 0.0 (0 for int4, 7 for nf4) and adds ``"kpad": uint8 [..., 1]``,
whose presence records the parity. ``code`` and ``kpad`` broadcast over the
weight's leading dims, so stacked ``[L, K, N]`` block leaves keep one
leading axis.

Every function works on tensors on whatever device they are given.
"""
from __future__ import annotations

import functools

import torch

#: Normal-float-4 codebook (QLoRA §3.1): the 16 quantiles of N(0, 1)
#: renormalised to [-1, 1], with an exact zero at index 7. Each value is
#: exact in f32; the kernels bake them in, and the tree carries a copy.
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
#: nibble that dequantizes to 0.0 in each packed format (the odd-K pad)
INT4_ZERO_NIBBLE = 0
NF4_ZERO_NIBBLE = 7

#: ``--quantize`` values of the train CLI and ``init_params``
METHODS = ("none", "int8", "int4", "nf4")


@functools.lru_cache(maxsize=None)
def codebook(device, dtype=torch.float32) -> torch.Tensor:
    """:data:`NF4_CODE` as a [16] tensor of ``dtype`` on ``device``, made
    once per (device, dtype) and shared: never write to it. (Made once, it
    can be read inside a CUDA graph capture, where a host copy cannot.)"""
    return torch.tensor(NF4_CODE, dtype=torch.float32,
                        device=device).to(dtype)


def _absmax(w: torch.Tensor) -> torch.Tensor:
    """Per output channel: max |w| over the input axis, f32 [..., 1, N]."""
    return w.float().abs().amax(dim=-2, keepdim=True)


def quantize_int8(w: torch.Tensor):
    """w [..., K, N] -> (q int8 [..., K, N], scale f32 [..., 1, N])."""
    scale = torch.clamp_min(_absmax(w), 1e-8) / 127.0
    q = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


# ------------------------------------------------------------- 4-bit pack


def pack_nibbles(nibbles: torch.Tensor, *, pad_value: int = 0):
    """[..., K, N] nibble values (0..15) -> [..., ceil(K/2), N] uint8: byte
    row j holds row 2j in the low nibble and row 2j+1 in the high nibble;
    odd K appends one ``pad_value`` nibble."""
    v = nibbles.to(torch.uint8)
    if v.shape[-2] % 2:
        pad = torch.full((*v.shape[:-2], 1, v.shape[-1]), pad_value,
                         dtype=torch.uint8, device=v.device)
        v = torch.cat([v, pad], dim=-2)
    return v[..., 0::2, :] | (v[..., 1::2, :] << 4)


def unpack_nibbles(packed: torch.Tensor, k: int | None = None):
    """[..., ceil(K/2), N] uint8 -> [..., K, N] int32 nibble values;
    ``k`` drops the odd-K pad row, ``None`` keeps all ``2 · rows``."""
    v = packed.to(torch.int32)
    both = torch.stack([v & 0xF, v >> 4], dim=-2)        # [..., rows, 2, N]
    out = both.reshape(*packed.shape[:-2], -1, packed.shape[-1])
    return out if k is None else out[..., :k, :]


def sign_extend4(nibbles: torch.Tensor) -> torch.Tensor:
    """Two's-complement sign extension of 4-bit values held in int32."""
    return (nibbles ^ 8) - 8


def quantize_int4(w: torch.Tensor):
    """w [..., K, N] -> (q4 uint8 [..., ceil(K/2), N], scale [..., 1, N]):
    symmetric per output channel, q in [-7, 7], scale = absmax / 7."""
    scale = torch.clamp_min(_absmax(w), 1e-8) / 7.0
    q = torch.clamp(torch.round(w.float() / scale), -7, 7)
    return pack_nibbles(q.to(torch.int32) & 0xF,
                        pad_value=INT4_ZERO_NIBBLE), scale


def quantize_nf4(w: torch.Tensor):
    """w [..., K, N] -> (q4 uint8 [..., ceil(K/2), N], scale [..., 1, N]):
    per-channel absmax scaling to [-1, 1], then the nearest codebook entry
    through the midpoints (a left search, as the reference's)."""
    code = codebook(w.device)
    mids = (code[1:] + code[:-1]) / 2.0
    scale = torch.clamp_min(_absmax(w), 1e-8)
    idx = torch.searchsorted(mids, (w.float() / scale).contiguous())
    return pack_nibbles(idx, pad_value=NF4_ZERO_NIBBLE), scale


def dequantize_packed(q4, scale, method: str, dtype=torch.bfloat16,
                      k: int | None = None):
    """Packed q4 + scale -> dense [..., K, N] weights."""
    nib = unpack_nibbles(q4, k)
    if method == "int4":
        w = sign_extend4(nib).float()
    elif method == "nf4":
        w = codebook(q4.device)[nib.long()]
    else:
        raise ValueError(f"unknown packed method {method!r}")
    return (w * scale).to(dtype)


# ------------------------------------------------------------ leaf formats


def _stacked(n: int, part) -> dict:
    """The leaf dicts ``part(0) .. part(n - 1)`` stacked on a new leading
    axis, into outputs made once from the first (one matrix at a time). On
    the ``meta`` device only the first is made: the outputs' shapes and
    dtypes are all there is."""
    first = part(0)
    out = {k: v.new_empty((n, *v.shape)) for k, v in first.items()}
    if next(iter(first.values())).is_meta:
        return out
    for i in range(n):
        p = first if i == 0 else part(i)
        for k, v in p.items():
            out[k][i] = v
    return out


def quantize_leaf(w: torch.Tensor, method: str) -> dict:
    """Dense frozen weight -> the quantized leaf dict of ``method``. A
    stacked ``[..., K, N]`` weight is quantized one matrix at a time into
    outputs made once, so the f32 transients stay one matrix's size."""
    if w.ndim > 2:
        return _stacked(w.shape[0], lambda i: quantize_leaf(w[i], method))
    if method == "int8":
        q, s = quantize_int8(w)
        return {"q": q, "scale": s}
    if method in ("int4", "nf4"):
        q4, s = (quantize_int4 if method == "int4" else quantize_nf4)(w)
        leaf = {"q4": q4, "scale": s}
        lead = tuple(w.shape[:-2])
        if method == "nf4":
            leaf["code"] = codebook(w.device).repeat(*lead, 1)
        if w.shape[-2] % 2:
            leaf["kpad"] = torch.ones((*lead, 1), dtype=torch.uint8,
                                      device=w.device)
        return leaf
    raise ValueError(f"unknown quantize method {method!r}; "
                     f"expected one of {METHODS[1:]}")


def is_quantized(p) -> bool:
    """True for an int8 ``{"q", "scale"}`` leaf."""
    return isinstance(p, dict) and "q" in p and "scale" in p


def is_packed(p) -> bool:
    """True for a packed 4-bit ``{"q4", "scale"}`` leaf."""
    return isinstance(p, dict) and "q4" in p and "scale" in p


def packed_method(p) -> str:
    """"int4" or "nf4" for a packed leaf (the codebook is the marker)."""
    return "nf4" if "code" in p else "int4"


def packed_k(p) -> int:
    """The unpacked input dimension of a packed leaf."""
    return 2 * p["q4"].shape[-2] - (1 if "kpad" in p else 0)


def tree_method(params) -> str:
    """The format of a tree's frozen ``w`` leaves (those
    :func:`quantize_frozen` quantizes): one of :data:`METHODS`. A tree
    whose leaves mix formats raises."""
    found = set()

    def walk(tree, key):
        if is_quantized(tree):
            found.add("int8")
        elif is_packed(tree):
            found.add(packed_method(tree))
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, None)
        elif key == "w" and isinstance(tree, torch.Tensor) and tree.ndim >= 2:
            found.add("none")

    walk(params, None)
    if len(found) > 1:
        raise ValueError(f"frozen weights mix formats: {sorted(found)}")
    return found.pop() if found else "none"


def tree_bytes(tree, key=None, frozen_base=False) -> int:
    """Bytes of a parameter tree's tensors; with ``frozen_base``, of its
    frozen ``w`` leaves alone (dense, or a quantized leaf's codes, scale
    and codebook)."""
    if isinstance(tree, dict):
        if is_quantized(tree) or is_packed(tree):
            return sum(t.numel() * t.element_size() for t in tree.values())
        return sum(tree_bytes(v, k, frozen_base) for k, v in tree.items())
    if frozen_base and key != "w":
        return 0
    return tree.numel() * tree.element_size()


def maybe_dequant(p, dtype=torch.bfloat16):
    """A (possibly quantized) linear weight leaf as a dense matrix."""
    if is_packed(p):
        return dequantize_packed(p["q4"], p["scale"], packed_method(p),
                                 dtype, k=packed_k(p))
    if is_quantized(p):
        return dequantize_int8(p["q"], p["scale"], dtype)
    return p


def _requantize_leaf(leaf: dict, method: str) -> dict:
    """A quantized leaf in ``method``'s format, one matrix of a stack at a
    time: each matrix dequantized to f32 and quantized again, so the f32
    transients stay one matrix's size."""
    codes = leaf["q"] if is_quantized(leaf) else leaf["q4"]
    if codes.ndim > 2:
        return _stacked(codes.shape[0], lambda i: _requantize_leaf(
            {k: v[i] for k, v in leaf.items()}, method))
    return quantize_leaf(maybe_dequant(leaf, torch.float32), method)


def quantize_frozen_(params, *, method: str = "int8",
                     skip_keys=("a", "b", "bias")):
    """:func:`quantize_frozen` in place, for a tree of dicts and lists the
    caller owns: each frozen leaf's codes replace it in its container as
    soon as they are made, so its source (a bf16 stack, or the codes of
    another format) is freed there, before the next leaf is read, when
    nothing else holds it. Stacks go one matrix at a time. Returns
    ``params``."""
    def walk(node):
        keys = list(node) if isinstance(node, dict) else range(len(node))
        for key in keys:
            leaf = node[key] if key not in skip_keys else None
            if is_quantized(leaf) or is_packed(leaf):
                node[key] = None
                node[key] = _requantize_leaf(leaf, method)
            elif isinstance(leaf, (dict, list)):
                walk(leaf)
            elif key == "w" and isinstance(leaf, torch.Tensor) \
                    and leaf.ndim >= 2:
                node[key] = None
                node[key] = quantize_leaf(leaf, method)
            del leaf

    walk(params)
    return params


def _owned(tree):
    """``tree``'s dicts and lists copied (tuples as lists), its tensors
    shared: a tree :func:`quantize_frozen_` may rewrite."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_owned(v) for v in tree]
    return tree


def quantize_frozen(params, *, method: str = "int8",
                    skip_keys=("a", "b", "bias")):
    """Every frozen >= 2-D ``w`` leaf as its ``method`` format; a new tree,
    the rest of it shared. Leaves already quantized are quantized again
    from their f32 values (int8 -> int4 is a plain re-call), one matrix of
    a stack at a time (:func:`quantize_frozen_` on a copy of the tree's
    containers)."""
    return quantize_frozen_(_owned(params), method=method,
                            skip_keys=skip_keys)


def weights_format(method) -> str:
    """A ``--quantize`` method as the serve accounting's weights format
    (``serve/residency.py``): "bf16" for None or "none", else the method.
    The single choke point for that mapping: an unknown method raises
    rather than being charged as bf16."""
    m = "none" if method is None else method
    if m not in METHODS:
        raise ValueError(f"unknown quantize method {method!r}; "
                         f"expected one of {METHODS}")
    return "bf16" if m == "none" else m


def quantize_params(params, method):
    """``method`` applied to a parameter tree; None or "none" returns it as
    it is. ``init_params(quantize=)`` makes the same tree leaf by leaf."""
    if method is None or method == "none":
        return params
    if method in METHODS[1:]:
        return quantize_frozen(params, method=method)
    raise ValueError(f"unknown quantize method {method!r}; "
                     f"expected one of {METHODS}")
