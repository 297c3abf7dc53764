"""Kernel dispatch for the ``cuda`` backend (``repro.kernels.ops``).

For a tensor on the CPU each kernel wrapper takes its plain version; for a
CUDA tensor under ``backend="cuda"`` it launches the kernel or raises.
There is no shape fallback: what the kernel does not take is an error.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.kernels import lora_grouped as _lg
from repro_torch.kernels import rmsnorm as _rn


def lora_grouped_decode(x, w0, a, b, tile_gid, bias=None, scale: float = 2.0,
                        *, bm: int = 8,
                        policy: ExecutionPolicy = STRUCTURED):
    """Runtime-routed grouped linear for the serving decode path: a shared
    frozen base w0 [K,N], a stack of resident adapters a [R,K,r] /
    b [R,r,N], and ``tile_gid`` int32 [M // bm], a device tensor holding
    each slot tile's AdapterStore slot. The ``structured`` backend runs the
    gather reference (same math, plain PyTorch). The bias is added after
    the kernel."""
    M, K = x.shape
    if M % bm:
        raise ValueError(f"decode rows {M} not a multiple of tile {bm}")
    if policy.backend == "cuda":
        y = _lg.lora_grouped(x.contiguous(), w0, a, b, tile_gid, scale, bm=bm)
    else:
        row = tile_gid.long().repeat_interleave(bm)
        h = torch.einsum("mk,mkr->mr", x, a[row])
        y = (x @ w0 + scale * torch.einsum("mr,mrn->mn", h, b[row])
             ).to(x.dtype)
    return y + bias if bias is not None else y


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis of x (any leading shape) by the kernel."""
    return _rn.rmsnorm(x.reshape(-1, x.shape[-1]).contiguous(), w,
                       eps).reshape(x.shape)


def launch_counts() -> dict:
    """{kernel: launches} of every kernel wrapper."""
    return {"lora_grouped_fwd": _lg.lora_grouped.launches,
            "rmsnorm_fwd": _rn.rmsnorm.launches}


def reset_launch_counts() -> None:
    _lg.lora_grouped.launches = 0
    _rn.rmsnorm.launches = 0
