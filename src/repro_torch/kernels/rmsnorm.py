"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm_fwd.cu``, its wrapper,
and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py:rmsnorm``
(``_rmsnorm_kernel``), with its formula in f32:
``y = x · rsqrt(mean(x²) + eps) · w``.

What bounds it on the H100: bytes (each element read once and written
once, ~4 FLOPs each); at decode, with 8 rows of 896, the launch itself.
The design is one block per row: a block-wide f32 sum of squares, then one
pass that writes the scaled row. Any row count and width, nothing padded.

:func:`rmsnorm` launches the kernel for CUDA tensors and raises on what
the kernel does not take; a tensor on the CPU gets :func:`rmsnorm_ref`.
``rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([_build.C_INT] + [_build.C_PTR] * 3 + [_build.C_INT] * 2
             + [_build.C_FLOAT, _build.C_PTR])


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """Plain version, in the TPU kernel's formula."""
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * rms * w.float()).to(x.dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    """x [M, d], w [d] -> [M, d] in x's dtype."""
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x and w of the "
                        f"same type, got {x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"expected x [M, d] and w [d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x is on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    M, d = x.shape
    y = torch.empty_like(x)
    fn = _build.function("rmsnorm_fwd", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
                M, d, float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check("rmsnorm_fwd", rc, "rmsnorm_fwd launch")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
