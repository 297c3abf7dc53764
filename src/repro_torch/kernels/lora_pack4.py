"""The LoRA linear's forward and input gradient over a packed 4-bit frozen
base (int4 or nf4): the CUDA source ``csrc/lora_pack4.cu``, its wrappers
and their plain PyTorch versions.

Replace the TPU kernels of ``src/repro/kernels/lora_pack4.py``, with
``W0 = w(q4) · s``: q4 uint8 [ceil(K/2), N] holds rows 2j and 2j+1 in the
low and high nibble of byte row j (``core/quant.py``'s format), s is f32
[1, N], and w is the sign-extended nibble (int4) or ``NF4_CODE[nibble]``
rounded to the activations' dtype (nf4), as ``_unpack_tile`` has it:

* :func:`lora_fused_q4` (``lora_fused_q4``, ``_lora_fused_q4_kernel``):
  ``y = (x@w)·s + s_lora·round(x@A)@B``;
* :func:`lora_dx_q4` (``lora_dx_q4``, ``_lora_dx_q4_kernel``):
  ``dx = round(g·round(s))@wᵀ + dh@Aᵀ`` with ``dh = round((s_lora·g)@Bᵀ)``
  (summed in the bf16 kernel's own loop, computed by the f32 wrapper);
  K comes from A (``a.shape[0]``), so an odd K's pad row is never written.

int4 and nf4 are one kernel body with the format as a template parameter.
Roundings, the wrappers' contract and the launch counts are those of
``kernels/lora_quant.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels import lora_fused as _lf
from repro_torch.kernels.lora_quant import validate_base

#: packed formats -> the method code the C entry points take
METHOD_CODES = {"int4": 0, "nf4": 1}

_P, _I, _F = _build.C_PTR, _build.C_INT, _build.C_FLOAT
_FWD_ARGS = [_I, _I] + [_P] * 6 + [_I] * 4 + [_F, _I, _P]
_DX_ARGS = [_I] + [_P] * 6 + [_I] * 4 + [_P]
_DX_TC_ARGS = [_I] + [_P] * 6 + [_I] * 4 + [_F, _I, _P]


def _method(method: str) -> int:
    if method not in METHOD_CODES:
        raise ValueError(f"unknown packed method {method!r}; expected one "
                         f"of {tuple(METHOD_CODES)}")
    return METHOD_CODES[method]


# ------------------------------------------------------------ plain versions


def unpack_weights(q4, method: str, dtype, k: int):
    """[ceil(K/2), N] bytes -> [k, N] weights in ``dtype``, unscaled: the
    TPU kernel's ``_unpack_tile`` (nf4 codebook entries rounded to dtype)."""
    _method(method)
    nib = quant.unpack_nibbles(q4, k)
    if method == "int4":
        return quant.sign_extend4(nib).to(dtype)
    return quant.codebook(q4.device, dtype)[nib.long()]


def lora_fused_q4_ref(x, q4, s, a, b, scale: float = 2.0, *,
                      method: str = "int4"):
    """Plain version of the forward, in the TPU kernel's roundings."""
    xf = x.float()
    h = (xf @ a.float()).to(x.dtype)
    acc = xf @ unpack_weights(q4, method, x.dtype, x.shape[1]).float()
    return (acc * s.float() + scale * (h.float() @ b.float())).to(x.dtype)


def lora_dx_q4_ref(g, q4, s, a, b, scale: float = 2.0, *,
                   method: str = "int4"):
    """Plain version of dx, in the TPU kernel's roundings."""
    dh = _lf._dh(g, b, scale)
    gs = (g * s.to(g.dtype)).float()
    w = unpack_weights(q4, method, g.dtype, a.shape[0]).float()
    return (gs @ w.T + dh.float() @ a.float().T).to(g.dtype)


# ------------------------------------------------------------------ wrappers


def lora_fused_q4(x, q4, s, a, b, scale: float = 2.0, *,
                  method: str = "int4", split=None):
    """x [M,K], q4 uint8 [ceil(K/2),N], s f32 [1,N], a [K,r], b [r,N] ->
    y [M,N] in x's dtype. ``split``: the bf16 body's K split
    (``lora_fused.split_of`` by default)."""
    code = _method(method)
    if not x.is_cuda:
        return lora_fused_q4_ref(x, q4, s, a, b, scale, method=method)
    r = _lf._dims(x, q4, a)
    M, K = x.shape
    N = q4.shape[1]
    _lf._validate("lora_fused_q4", x, {"x": x, "a": a, "b": b},
                  {"x": (M, K), "a": (K, r), "b": (r, N)})
    validate_base("lora_fused_q4", x, q4, s, torch.uint8, ((K + 1) // 2, N),
                  N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_pack4", "lora_fused_q4", _FWD_ARGS)
    with torch.cuda.device(x.device):
        split = _lf.split_of("lora_fused_q4", x.dtype, M, K, N, split)
        rc = fn(_lf._DTYPES[x.dtype], code, x.data_ptr(), q4.data_ptr(),
                s.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), M, K,
                N, r, float(scale), split, _lf._stream())
    _build.check("lora_pack4", rc, f"lora_fused_q4 launch (split {split})")
    lora_fused_q4.launches += 1
    return y


def lora_dx_q4(g, q4, s, a, b, scale: float = 2.0, *, method: str = "int4",
               split=None):
    """g [M,N], q4 uint8 [ceil(K/2),N], s f32 [1,N], a [K,r], b [r,N] ->
    dx [M,K] in g's dtype (K from a). ``split``: the bf16 body's split of
    N."""
    code = _method(method)
    if not g.is_cuda:
        return lora_dx_q4_ref(g, q4, s, a, b, scale, method=method)
    r = _lf._dims(g, q4, a)
    M, N = g.shape
    K = a.shape[0]
    _lf._validate("lora_dx_q4", g, {"g": g, "a": a, "b": b},
                  {"g": (M, N), "a": (K, r), "b": (r, N)})
    validate_base("lora_dx_q4", g, q4, s, torch.uint8, ((K + 1) // 2, N), N)
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        split = _lf.split_of("lora_dx_q4", g.dtype, M, K, N, split)
        if g.dtype == torch.bfloat16:
            fn = _build.function("lora_pack4", "lora_dx_q4_tc", _DX_TC_ARGS)
            rc = fn(code, g.data_ptr(), q4.data_ptr(), s.data_ptr(),
                    a.data_ptr(), b.data_ptr(), dx.data_ptr(), M, K, N, r,
                    float(scale), split, _lf._stream())
        else:
            dh = _lf._dh(g, b, scale)
            fn = _build.function("lora_pack4", "lora_dx_q4", _DX_ARGS)
            rc = fn(code, g.data_ptr(), q4.data_ptr(), s.data_ptr(),
                    a.data_ptr(), dh.data_ptr(), dx.data_ptr(), M, K, N, r,
                    _lf._stream())
    _build.check("lora_pack4", rc, f"lora_dx_q4 launch (split {split})")
    lora_dx_q4.launches += 1
    return dx


lora_fused_q4.launches = 0
lora_dx_q4.launches = 0
