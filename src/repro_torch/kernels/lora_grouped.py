"""Grouped LoRA forward for multi-tenant decode: the CUDA kernel
``csrc/lora_grouped_fwd.cu``, its wrapper, and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/lora_grouped.py:lora_grouped``
(``_grouped_fwd_kernel``) in its serving form: one shared base W0
(``Ew == 1``) in float, a stack of R resident adapters, and an int32
per-tile routing vector that stays on the device::

    y[m] = x[m] @ W0 + s · (x[m] @ A[g]) @ B[g],   g = gid[m // bm]

What bounds it on the H100: reading W0. Decode multiplies 8 rows by the
whole frozen base (2·M FLOPs per 2-byte weight), so the kernel lives far
below the card's ridge of ~295 FLOPs per byte; one qwen2.5-0.5b decode step streams ~716 MB of
W0 through it. The design reads each W0 element once for up to 8 rows,
keeps h = x @ A[g] in shared memory only, and masks the ragged edges
instead of padding copies (the source's header has the details).

:func:`lora_grouped` launches the kernel for CUDA tensors and raises on
what the kernel does not take; a tensor on the CPU gets
:func:`lora_grouped_ref`. ``lora_grouped.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest LoRA rank the kernel takes (``RMAX`` in the source)
MAX_RANK = 16

_ARGTYPES = ([_build.C_INT] + [_build.C_PTR] * 6 + [_build.C_INT] * 6
             + [_build.C_FLOAT, _build.C_PTR])


def lora_grouped_ref(x, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """Plain version, with the kernel's arithmetic: f32 sums, h rounded to
    x's type before it meets B, output in x's type."""
    row = gid.long().repeat_interleave(bm)
    xf = x.float()
    acc = xf @ w0.float()
    h = torch.einsum("mk,mkr->mr", xf, a[row].float()).to(x.dtype)
    delta = torch.einsum("mr,mrn->mn", h.float(), b[row].float())
    return (acc + scale * delta).to(x.dtype)


def _validate(x, w0, a, b, gid, bm):
    if x.dtype not in _DTYPES:
        raise TypeError(f"lora_grouped kernel takes f32 or bf16, not "
                        f"{x.dtype}")
    for name, t in (("w0", w0), ("a", a), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"gid must be int32, got {gid.dtype}")
    for name, t in (("x", x), ("w0", w0), ("a", a), ("b", b), ("gid", gid)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2 or w0.ndim != 2 or a.ndim != 3 or b.ndim != 3:
        raise ValueError("expected x [M,K], w0 [K,N], a [R,K,r], b [R,r,N]")
    M, K = x.shape
    N = w0.shape[1]
    R, _, r = a.shape
    if (w0.shape[0] != K or a.shape[1] != K or b.shape != (R, r, N)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w0 "
                         f"{tuple(w0.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if bm < 1 or M % bm or gid.shape != (M // bm,):
        raise ValueError(f"rows {M} must be whole tiles of bm={bm}, with "
                         f"one gid per tile (got gid {tuple(gid.shape)})")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside 1..{MAX_RANK}")


def lora_grouped(x, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """x [M,K] (M % bm == 0), w0 [K,N], a [R,K,r], b [R,r,N],
    gid int32 [M // bm] -> y [M,N] in x's dtype."""
    if not x.is_cuda:
        return lora_grouped_ref(x, w0, a, b, gid, scale, bm=bm)
    _validate(x, w0, a, b, gid, bm)
    M, K = x.shape
    N = w0.shape[1]
    R, _, r = a.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_grouped_fwd", "lora_grouped_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), w0.data_ptr(), a.data_ptr(),
                b.data_ptr(), gid.data_ptr(), y.data_ptr(), M, K, N, R, r,
                bm, float(scale), torch.cuda.current_stream().cuda_stream)
    _build.check("lora_grouped_fwd", rc, "lora_grouped_fwd launch")
    lora_grouped.launches += 1
    return y


lora_grouped.launches = 0
