"""Kernel dispatch for the ``cuda`` backend (``repro.kernels.ops``).

For a tensor on the CPU each kernel wrapper takes its plain version; for a
CUDA tensor under ``backend="cuda"`` it launches the kernel or raises.
There is no shape fallback: what the kernel does not take is an error.

The autograd Functions here pair kernel forwards with kernel backwards that
follow the paper's structured rules, as the reference's custom_vjps do:
:func:`lora_linear` is ``lora_fused_fwd`` forward and ``lora_dx`` +
``lora_dab`` backward, saving x (h is recomputed on chip); :func:`rmsnorm`
is ``rmsnorm_fwd`` forward and ``rmsnorm_bwd`` backward, saving x.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.core import structured
from repro_torch.kernels import lora_fused as _lf
from repro_torch.kernels import lora_grouped as _lg
from repro_torch.kernels import rmsnorm as _rn

#: query rows from which the reference runs its flash-attention kernels
#: (``PALLAS_ATTN_MIN_SEQ``); below it both take the structured sdpa
ATTN_MIN_SEQ = 64


def _flat(x):
    return x.reshape(-1, x.shape[-1])


# ---------------------------------------------------------------------------
# LoRA linear: fused forward (h on chip) + dx and one-pass dA/dB backward
# ---------------------------------------------------------------------------


class _LoRALinearKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, a, b, scale):
        ctx.scale = scale
        ctx.save_for_backward(x, w0, a, b)           # h is never saved
        y = _lf.lora_fused(_flat(x).contiguous(), w0, a, b, scale)
        return y.reshape(*x.shape[:-1], w0.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w0, a, b = ctx.saved_tensors
        g2 = _flat(g).to(x.dtype).contiguous()
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = _lf.lora_dx(g2, w0, a, b, ctx.scale).reshape(x.shape)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            da, db = _lf.lora_dab(_flat(x).contiguous(), g2, a, b, ctx.scale)
        return dx, None, da, db, None


def lora_linear(x, w0, a, b, bias=None, scale: float = 2.0):
    """``x@w0 + scale·(x@a)@b [+ bias]`` through the LoRA kernels, any
    leading dims on x. The bias is frozen: a plain add after the kernel,
    as in the reference, saves nothing."""
    y = _LoRALinearKernel.apply(x, w0, a, b, scale)
    return y + bias if bias is not None else y


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


# ---------------------------------------------------------------------------
# RMSNorm: forward kernel + backward kernel (rms and x̂ recomputed from x)
# ---------------------------------------------------------------------------


class _RMSNormKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _rn.rmsnorm(_flat(x).contiguous(), w, eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _rn.rmsnorm_bwd(_flat(x).contiguous(), w,
                                 _flat(g).to(x.dtype).contiguous(), ctx.eps,
                                 need_dw=ctx.needs_input_grad[1])
        return (dx.reshape(x.shape) if ctx.needs_input_grad[0] else None,
                dw, None)


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis of x (any leading shape) by the kernels."""
    return _RMSNormKernel.apply(x, w, eps)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def sdpa(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention dispatch, as the reference's ``attention_supported``:
    below :data:`ATTN_MIN_SEQ` query rows the structured sdpa (saves q, k,
    v; the probabilities are recomputed). From there on the reference runs
    its flash-attention kernels, which the port has not written yet: that
    raises, on the card and on the CPU, rather than run plain attention in
    the kernels' place."""
    if q.shape[2] >= ATTN_MIN_SEQ:
        raise NotImplementedError(
            f"attention over {q.shape[2]} >= {ATTN_MIN_SEQ} query rows runs "
            "the flash-attention kernels (the reference's "
            "flash_attention_fwd / flash_attention_bwd), which the port has "
            "not written yet; use --seq < 64 or another engine")
    return structured.sdpa(q, k, v, window, causal)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_COUNTED = {"lora_grouped_fwd": _lg.lora_grouped, "rmsnorm_fwd": _rn.rmsnorm,
            "lora_fused_fwd": _lf.lora_fused, "lora_dx": _lf.lora_dx,
            "lora_dab": _lf.lora_dab, "rmsnorm_bwd": _rn.rmsnorm_bwd}


def launch_counts() -> dict:
    """{kernel: launches} of every kernel wrapper."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
