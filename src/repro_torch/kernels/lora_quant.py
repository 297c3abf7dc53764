"""The LoRA linear's forward and input gradient over an int8 frozen base:
the CUDA source ``csrc/lora_quant.cu``, its wrappers and their plain
PyTorch versions.

Replace the TPU kernels of ``src/repro/kernels/lora_quant.py``, with
``W0 = q · s`` (q int8 [K, N], s f32 [1, N], ``core/quant.py``'s format):

* :func:`lora_fused_q` (``lora_fused_q``, ``_lora_fused_q_kernel``):
  ``y = (x@q)·s + s_lora·round(x@A)@B``, the scale applied once per output
  after the sum over K, h summed on chip and never stored;
* :func:`lora_dx_q` (``lora_dx_q``, ``_lora_dx_q_kernel``):
  ``dx = round(g·round(s))@qᵀ + dh@Aᵀ`` with ``dh = round((s_lora·g)@Bᵀ)``,
  the thin product the TPU wrapper computed outside its kernel: the bf16
  kernel sums it in its own loop (one launch), the f32 wrapper computes it
  before its kernel; q is read in place (the TPU wrapper wrote a
  transposed copy).

"round" is a rounding to x's (or g's) dtype, where the TPU kernels round;
every sum is f32. dA and dB never read W0: the dense ``lora_dab`` kernel
serves every format. Each wrapper launches its kernel for CUDA tensors and
raises on what the kernel does not take; a tensor on the CPU gets the plain
version (``*_ref``), which dequantizes. ``<wrapper>.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import lora_fused as _lf

_P, _I, _F = _build.C_PTR, _build.C_INT, _build.C_FLOAT
_FWD_ARGS = [_I] + [_P] * 6 + [_I] * 4 + [_F, _I, _P]
_DX_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_DX_TC_ARGS = [_P] * 6 + [_I] * 4 + [_F, _I, _P]


# ------------------------------------------------------------ plain versions


def lora_fused_q_ref(x, q, s, a, b, scale: float = 2.0):
    """Plain version of the forward, in the TPU kernel's roundings."""
    xf = x.float()
    h = (xf @ a.float()).to(x.dtype)
    acc = xf @ q.to(x.dtype).float()
    return (acc * s.float() + scale * (h.float() @ b.float())).to(x.dtype)


def lora_dx_q_ref(g, q, s, a, b, scale: float = 2.0):
    """Plain version of dx, in the TPU kernel's roundings."""
    dh = _lf._dh(g, b, scale)
    gs = (g * s.to(g.dtype)).float()
    return (gs @ q.to(g.dtype).float().T
            + dh.float() @ a.float().T).to(g.dtype)


# ------------------------------------------------------------------ wrappers


def validate_base(what, x, q, s, q_dtype, q_shape, n):
    """The quantized base beside activations x: codes ``q`` of ``q_dtype``
    and shape ``q_shape`` ([K, N], or [E, K, N] for a stack of experts),
    and scale ``s`` f32 [1, n] (a stack's [E, 1, n]), both contiguous on
    x's device."""
    s_shape = (*q_shape[:-2], 1, n)
    for name, t, dtype, shape in (("q", q, q_dtype, q_shape),
                                  ("s", s, torch.float32, s_shape)):
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def lora_fused_q(x, q, s, a, b, scale: float = 2.0, *, split=None):
    """x [M,K], q int8 [K,N], s f32 [1,N], a [K,r], b [r,N] -> y [M,N] in
    x's dtype. ``split``: the bf16 body's K split (``lora_fused.split_of``
    by default)."""
    if not x.is_cuda:
        return lora_fused_q_ref(x, q, s, a, b, scale)
    r = _lf._dims(x, q, a)
    M, K = x.shape
    N = q.shape[1]
    _lf._validate("lora_fused_q", x, {"x": x, "a": a, "b": b},
                  {"x": (M, K), "a": (K, r), "b": (r, N)})
    validate_base("lora_fused_q", x, q, s, torch.int8, (K, N), N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_quant", "lora_fused_q", _FWD_ARGS)
    with torch.cuda.device(x.device):
        split = _lf.split_of("lora_fused_q", x.dtype, M, K, N, split)
        rc = fn(_lf._DTYPES[x.dtype], x.data_ptr(), q.data_ptr(),
                s.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), M, K,
                N, r, float(scale), split, _lf._stream())
    _build.check("lora_quant", rc, f"lora_fused_q launch (split {split})")
    lora_fused_q.launches += 1
    return y


def lora_dx_q(g, q, s, a, b, scale: float = 2.0, *, split=None):
    """g [M,N], q int8 [K,N], s f32 [1,N], a [K,r], b [r,N] -> dx [M,K] in
    g's dtype. ``split``: the bf16 body's split of N."""
    if not g.is_cuda:
        return lora_dx_q_ref(g, q, s, a, b, scale)
    r = _lf._dims(g, q, a)
    M, N = g.shape
    K = q.shape[0]
    _lf._validate("lora_dx_q", g, {"g": g, "a": a, "b": b},
                  {"g": (M, N), "a": (K, r), "b": (r, N)})
    validate_base("lora_dx_q", g, q, s, torch.int8, (K, N), N)
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        split = _lf.split_of("lora_dx_q", g.dtype, M, K, N, split)
        if g.dtype == torch.bfloat16:
            fn = _build.function("lora_quant", "lora_dx_q_tc", _DX_TC_ARGS)
            rc = fn(g.data_ptr(), q.data_ptr(), s.data_ptr(), a.data_ptr(),
                    b.data_ptr(), dx.data_ptr(), M, K, N, r, float(scale),
                    split, _lf._stream())
        else:
            dh = _lf._dh(g, b, scale)
            fn = _build.function("lora_quant", "lora_dx_q", _DX_ARGS)
            rc = fn(g.data_ptr(), q.data_ptr(), s.data_ptr(), a.data_ptr(),
                    dh.data_ptr(), dx.data_ptr(), M, K, N, r, _lf._stream())
    _build.check("lora_quant", rc, f"lora_dx_q launch (split {split})")
    lora_dx_q.launches += 1
    return dx


lora_fused_q.launches = 0
lora_dx_q.launches = 0
