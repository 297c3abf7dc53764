"""RMSNorm forward and backward: the CUDA kernels ``csrc/rmsnorm_fwd.cu``
and ``csrc/rmsnorm_bwd.cu``, their wrappers, and their plain PyTorch
versions.

Replace the TPU kernels of ``src/repro/kernels/rmsnorm.py``, with their
formulas in f32:

* :func:`rmsnorm` (``rmsnorm``, ``_rmsnorm_kernel``):
  ``y = x · rsqrt(mean(x²) + eps) · w``;
* :func:`rmsnorm_bwd` (``rmsnorm_bwd``, ``_rmsnorm_bwd_kernel``):
  ``dx = (g·w − x̂·mean(g·w·x̂))·rsqrt(mean(x²) + eps)`` with x̂ recomputed
  from x, and ``dw = Σ_rows g·x̂`` from per-row f32 partials added here in a
  fixed order.

What bounds both on the H100: bytes (each element read once and written
once, a few FLOPs each); at decode, with 8 rows of 896, the launch itself.
Both run one warp a row (``csrc/rownorm.cuh`` holds their row loads): the
row's operands (x and w; x, g and w) come in one round trip of 16-byte
loads where the width and the bases allow them (element by element
otherwise) and stay in registers, warp shuffles give the f32 sums (Σx²;
Σx² and Σ(g·w)·x), and the output is written from the registers, so no
block barrier and one read of x and g up to 4,096 bf16 or 2,048 f32
values a row. Any row count and width, nothing padded.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; a tensor on the CPU gets the plain version
(``*_ref``). ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([_build.C_INT] + [_build.C_PTR] * 3 + [_build.C_INT] * 2
             + [_build.C_FLOAT, _build.C_PTR])
_BWD_ARGTYPES = ([_build.C_INT] + [_build.C_PTR] * 5 + [_build.C_INT] * 2
                 + [_build.C_FLOAT, _build.C_PTR])


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """Plain version, in the TPU kernel's formula."""
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, w, g, eps: float = 1e-6):
    """Plain version of the backward, in the TPU kernel's formula:
    (dx in x's dtype, dw in w's dtype)."""
    xf, gf = x.float(), g.float()
    rms = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    xhat = xf * rms
    dxhat = gf * w.float()
    dx = (dxhat - xhat * torch.mean(dxhat * xhat, -1, keepdim=True)) * rms
    return dx.to(x.dtype), (gf * xhat).sum(0).to(w.dtype)


def _validate(what, x, w, others=()):
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes f32 or bf16 x and w of the "
                        f"same type, got {x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"expected x [M, d] and w [d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for t in (w, *others):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x is on {x.device}")
    for t in others:
        if t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"expected g like x {tuple(x.shape)} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    if not all(t.is_contiguous() for t in (x, w, *others)):
        raise ValueError("x, w and g must be contiguous")


def rmsnorm(x, w, eps: float = 1e-6):
    """x [M, d], w [d] -> [M, d] in x's dtype."""
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    _validate("rmsnorm_fwd", x, w)
    M, d = x.shape
    y = torch.empty_like(x)
    fn = _build.function("rmsnorm_fwd", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        autotune.choose_blocks("rmsnorm", x.dtype, M=M, d=d)   # fixed plan
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
                M, d, float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check("rmsnorm_fwd", rc, "rmsnorm_fwd launch")
    rmsnorm.launches += 1
    return y


def rmsnorm_bwd(x, w, g, eps: float = 1e-6, *, need_dw: bool = True):
    """x, g [M, d], w [d] -> (dx [M, d] in x's dtype, dw [d] in w's dtype,
    or None when ``need_dw`` is false: then no partials are written)."""
    if not x.is_cuda:
        dx, dw = rmsnorm_bwd_ref(x, w, g, eps)
        return dx, (dw if need_dw else None)
    _validate("rmsnorm_bwd", x, w, (g,))
    M, d = x.shape
    dx = torch.empty_like(x)
    dwp = (torch.empty((M, d), dtype=torch.float32, device=x.device)
           if need_dw else None)
    fn = _build.function("rmsnorm_bwd", "rmsnorm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        autotune.choose_blocks("rmsnorm", x.dtype, M=M, d=d)   # fixed plan
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), g.data_ptr(),
                dx.data_ptr(), dwp.data_ptr() if need_dw else None, M, d,
                float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check("rmsnorm_bwd", rc, "rmsnorm_bwd launch")
    rmsnorm_bwd.launches += 1
    return dx, (dwp.sum(0).to(w.dtype) if need_dw else None)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
