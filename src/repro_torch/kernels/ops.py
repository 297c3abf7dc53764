"""Kernel dispatch for the ``cuda`` backend (``repro.kernels.ops``).

For a tensor on the CPU each kernel wrapper takes its plain version; for a
CUDA tensor under ``backend="cuda"`` it launches the kernel or raises.
There is no shape fallback: what the kernel does not take is an error.

The autograd Functions here pair kernel forwards with kernel backwards that
follow the paper's structured rules, as the reference's custom_vjps do:
:func:`lora_linear` is ``lora_fused_fwd`` forward and ``lora_dx`` +
``lora_dab`` backward, saving x (h is recomputed on chip), or over a
quantized base ``lora_fused_q``/``lora_fused_q4`` forward and
``lora_dx_q``/``lora_dx_q4`` + ``lora_dab`` backward, saving the codes and
the scale (never a dense W0); :func:`lora_grouped_linear` (MoE's expert
linears over [E, ·, ·] stacks) is ``lora_grouped_gemm`` forward and
``lora_grouped_dx`` + ``lora_grouped_dab`` backward, saving x, W0, A and B,
or over quantized expert stacks ``lora_grouped_gemm_q``/``_q4`` forward and
``lora_grouped_dx_q``/``_q4`` + ``lora_grouped_dab`` backward, saving x,
the codes, the scale, A and B (never h, never a dense expert W0);
:func:`rmsnorm`
is ``rmsnorm_fwd`` forward and ``rmsnorm_bwd`` backward, saving x;
:func:`sdpa` from 64 query rows is ``flash_fwd`` forward and
``flash_bwd_dq`` + ``flash_bwd_dkv`` backward, saving q, k, v, out and the
row logsumexp (the probabilities are recomputed on chip).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.core import quant, structured
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lora_fused as _lf
from repro_torch.kernels import lora_grouped as _lg
from repro_torch.kernels import lora_pack4 as _lp4
from repro_torch.kernels import lora_quant as _lq
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import rope as _rope
from repro_torch.kernels import tiling as _tiling

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


# Over a quantized base: the codes and the scale are frozen (no gradient);
# dA and dB never read W0, so the dense lora_dab kernel serves every format.


def _quant_backward(ctx, g, dx_fn):
    x, q, s, a, b = ctx.saved_tensors
    g2 = _flat(g).to(x.dtype).contiguous()
    dx = da = db = None
    if ctx.needs_input_grad[0]:
        dx = dx_fn(g2, q, s, a, b, ctx.scale).reshape(x.shape)
    if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
        da, db = _lf.lora_dab(_flat(x).contiguous(), g2, a, b, ctx.scale)
    return dx, None, None, da, db


class _LoRALinearKernelQ(torch.autograd.Function):
    """int8 base {"q": [K,N], "scale": [1,N]}: saves exactly (x, q, s, a, b)."""

    @staticmethod
    def forward(ctx, x, q, s, a, b, scale):
        ctx.scale = scale
        ctx.save_for_backward(x, q, s, a, b)
        y = _lq.lora_fused_q(_flat(x).contiguous(), q, s, a, b, scale)
        return y.reshape(*x.shape[:-1], q.shape[1])

    @staticmethod
    def backward(ctx, g):
        return (*_quant_backward(ctx, g, _lq.lora_dx_q), None)


class _LoRALinearKernelP4(torch.autograd.Function):
    """Packed 4-bit base {"q4": [ceil(K/2),N], "scale": [1,N], ...}: saves
    exactly (x, q4, s, a, b)."""

    @staticmethod
    def forward(ctx, x, q4, s, a, b, scale, method):
        ctx.scale, ctx.method = scale, method
        ctx.save_for_backward(x, q4, s, a, b)
        y = _lp4.lora_fused_q4(_flat(x).contiguous(), q4, s, a, b, scale,
                               method=method)
        return y.reshape(*x.shape[:-1], q4.shape[1])

    @staticmethod
    def backward(ctx, g):
        def dx_fn(*args):
            return _lp4.lora_dx_q4(*args, method=ctx.method)
        return (*_quant_backward(ctx, g, dx_fn), None, None)


def lora_linear(x, w0, a, b, bias=None, scale: float = 2.0):
    """``x@w0 + scale·(x@a)@b [+ bias]`` through the LoRA kernels, any
    leading dims on x. ``w0`` is a dense matrix, an int8 ``{"q", "scale"}``
    leaf or a packed 4-bit ``{"q4", "scale", ...}`` leaf, as in the
    reference's dispatch; a quantized leaf goes to the quantized kernels
    and is never dequantized here. The bias is frozen: a plain add after
    the kernel, as in the reference, saves nothing."""
    if quant.is_packed(w0):
        y = _LoRALinearKernelP4.apply(x, w0["q4"], w0["scale"], a, b, scale,
                                      quant.packed_method(w0))
    elif quant.is_quantized(w0):
        y = _LoRALinearKernelQ.apply(x, w0["q"], w0["scale"], a, b, scale)
    else:
        y = _LoRALinearKernel.apply(x, w0, a, b, scale)
    return y + bias if bias is not None else y


def lora_grouped_decode(x, w0, a, b, tile_gid, bias=None, scale: float = 2.0,
                        *, bm: int = 8,
                        policy: ExecutionPolicy = STRUCTURED):
    """Runtime-routed grouped linear for the serving decode path: a shared
    frozen base w0 [K,N] (dense, an int8 ``{"q", "scale"}`` leaf or a packed
    ``{"q4", "scale", ...}`` leaf), a stack of resident adapters a [R,K,r] /
    b [R,r,N], and ``tile_gid`` int32 [M // bm], a device tensor holding
    each slot tile's AdapterStore slot. The ``cuda`` backend runs the
    grouped kernel of the base's format (``lora_grouped``,
    ``lora_grouped_q``, ``lora_grouped_q4``; in bf16 one tensor-core body,
    ``csrc/lora_grouped_decode_tc.cuh``, in f32 a CUDA-core one), which
    reads the codes and never writes a dense W0; the ``structured`` backend
    runs the gather reference over ``quant.maybe_dequant(w0)`` (same math,
    plain PyTorch), as the reference's dispatch does. The bias is added after the kernel.
    A base the grouped path does not take raises under every backend: a
    per-expert stack (``Ew == E``, MoE) or a packed leaf of another K."""
    M, K = x.shape
    if M % bm:
        raise ValueError(f"decode rows {M} not a multiple of tile {bm}")
    codes = (w0["q4"] if quant.is_packed(w0) else
             w0["q"] if quant.is_quantized(w0) else w0)
    if codes.ndim != 2:
        raise ValueError(f"grouped decode takes one shared base [K, N], got "
                         f"{tuple(codes.shape)} (a per-expert base is MoE's)")
    if quant.is_packed(w0) and quant.packed_k(w0) != K:
        raise ValueError(f"packed base holds K={quant.packed_k(w0)} rows, "
                         f"x has {K}")
    if policy.backend == "cuda":
        x = x.contiguous()
        if quant.is_packed(w0):
            y = _lg.lora_grouped_q4(x, w0["q4"], w0["scale"], a, b, tile_gid,
                                    scale, bm=bm,
                                    method=quant.packed_method(w0))
        elif quant.is_quantized(w0):
            y = _lg.lora_grouped_q(x, w0["q"], w0["scale"], a, b, tile_gid,
                                   scale, bm=bm)
        else:
            y = _lg.lora_grouped(x, w0, a, b, tile_gid, scale, bm=bm)
    else:
        w = quant.maybe_dequant(w0, x.dtype)
        row = tile_gid.long().repeat_interleave(bm)
        h = torch.einsum("mk,mkr->mr", x, a[row])
        y = (x @ w + scale * torch.einsum("mr,mrn->mn", h, b[row])
             ).to(x.dtype)
    return y + bias if bias is not None else y


# ---------------------------------------------------------------------------
# Grouped LoRA linear over per-expert stacks (MoE): one launch for all
# experts, every bm-row tile one expert's, routed by an int32 gid on the
# device
# ---------------------------------------------------------------------------


def grouped_bm(rows: int) -> int:
    """Row-tile height for groups of ``rows`` rows: 128-row tiles for big
    groups, else one tile of ``rows`` rounded up to 8 (the reference's
    ``_grouped_bm``)."""
    return 128 if rows >= 128 else -(-max(rows, 1) // 8) * 8


@functools.lru_cache(maxsize=None)
def _expert_gid(E: int, tiles: int, device: torch.device):
    """int32 [E · tiles]: expert e owns tiles e·tiles .. (e+1)·tiles - 1.
    Made once per shape and device and shared: never write to it."""
    return torch.arange(E, dtype=torch.int32, device=device
                        ).repeat_interleave(tiles)


def _pad_rows(t, Cp):
    """[E, C, ·] -> [E·Cp, ·] rows, zero rows past C (a view when C ==
    Cp and t is contiguous)."""
    E, C, n = t.shape
    if Cp != C:
        t = torch.nn.functional.pad(t, (0, 0, 0, Cp - C))
    return t.reshape(E * Cp, n).contiguous()


def _grouped_rows(ctx, x, gid, bm, scale):
    """The grouped kernels' rows [E·Cp, K] of x [E, C, K], E buffers of C
    rows each zero-padded up to Cp, a multiple of ``bm`` (a view when C ==
    Cp and x is contiguous); ``gid`` int32 [E·Cp / bm] routes every tile.
    The layout goes on ``ctx``."""
    ctx.gid, ctx.bm, ctx.scale = gid, bm, scale
    return _pad_rows(x, -(-x.shape[1] // bm) * bm)


def _grouped_out(y, x):
    """The kernel's rows [E·Cp, N] as x's buffers [E, C, N]."""
    E, C, _ = x.shape
    return y.view(E, -1, y.shape[-1])[:, :C]


def _grouped_backward(ctx, g, x, a, b, ia, dx_fn):
    """(dx, dA, dB) of a grouped linear: ``dx_fn(g rows)`` for dx,
    ``lora_grouped_dab`` for dA and dB (it never reads W0); A and B are the
    Function's inputs ``ia`` and ``ia + 1``."""
    Cp = -(-x.shape[1] // ctx.bm) * ctx.bm
    g2 = _pad_rows(g.to(x.dtype), Cp)
    dx = da = db = None
    if ctx.needs_input_grad[0]:
        dx = _grouped_out(dx_fn(g2), x)
    if ctx.needs_input_grad[ia] or ctx.needs_input_grad[ia + 1]:
        da, db = _lg.lora_grouped_dab(_pad_rows(x, Cp), g2, a, b, ctx.gid,
                                      ctx.scale, bm=ctx.bm)
    return dx, da, db


class _GroupedLoRAKernel(torch.autograd.Function):
    """x [E, C, K] (E buffers of C rows, tile t of the padded rows routed
    to ``gid[t]``), w0 [G, K, N], a [G, K, r], b [G, r, N] -> [E, C, N].
    Saves exactly (x, w0, a, b): never h, never a copy of the stack."""

    @staticmethod
    def forward(ctx, x, w0, a, b, gid, bm, scale):
        rows = _grouped_rows(ctx, x, gid, bm, scale)
        ctx.save_for_backward(x, w0, a, b)
        return _grouped_out(_lg.lora_grouped_gemm(rows, w0, a, b, gid, scale,
                                                  bm=bm), x)

    @staticmethod
    def backward(ctx, g):
        x, w0, a, b = ctx.saved_tensors
        dx, da, db = _grouped_backward(
            ctx, g, x, a, b, 2, lambda g2: _lg.lora_grouped_dx(
                g2, w0, a, b, ctx.gid, ctx.scale, bm=ctx.bm))
        return dx, None, da, db, None, None, None


class _GroupedLoRAKernelQ(torch.autograd.Function):
    """int8 stacks: x [E, C, K], q int8 [G, K, N], s f32 [G, 1, N], a, b
    -> [E, C, N]. Saves exactly (x, q, s, a, b)."""

    @staticmethod
    def forward(ctx, x, q, s, a, b, gid, bm, scale):
        rows = _grouped_rows(ctx, x, gid, bm, scale)
        ctx.save_for_backward(x, q, s, a, b)
        return _grouped_out(_lg.lora_grouped_gemm_q(rows, q, s, a, b, gid,
                                                    scale, bm=bm), x)

    @staticmethod
    def backward(ctx, g):
        x, q, s, a, b = ctx.saved_tensors
        dx, da, db = _grouped_backward(
            ctx, g, x, a, b, 3, lambda g2: _lg.lora_grouped_dx_q(
                g2, q, s, a, b, ctx.gid, ctx.scale, bm=ctx.bm))
        return dx, None, None, da, db, None, None, None


class _GroupedLoRAKernelP4(torch.autograd.Function):
    """Packed 4-bit stacks: x [E, C, K], q4 uint8 [G, ceil(K/2), N], s f32
    [G, 1, N], a, b -> [E, C, N]. Saves exactly (x, q4, s, a, b)."""

    @staticmethod
    def forward(ctx, x, q4, s, a, b, gid, bm, scale, method):
        rows = _grouped_rows(ctx, x, gid, bm, scale)
        ctx.method = method
        ctx.save_for_backward(x, q4, s, a, b)
        return _grouped_out(_lg.lora_grouped_gemm_q4(
            rows, q4, s, a, b, gid, scale, bm=bm, method=method), x)

    @staticmethod
    def backward(ctx, g):
        x, q4, s, a, b = ctx.saved_tensors
        dx, da, db = _grouped_backward(
            ctx, g, x, a, b, 3, lambda g2: _lg.lora_grouped_dx_q4(
                g2, q4, s, a, b, ctx.gid, ctx.scale, bm=ctx.bm,
                method=ctx.method))
        return dx, None, None, da, db, None, None, None, None


def lora_grouped_linear(x, w0, a, b, scale: float = 2.0):
    """The MoE expert linear ``x[e] @ w0[e] + scale·(x[e]@a[e])@b[e]`` for
    every expert e through the grouped kernels: x [E, C, K] (C rows of each
    expert's capacity buffer), a [E, K, r], b [E, r, N] -> [E, C, N]. As the
    reference's dispatch (``_grouped_dispatch``): tiles of ``grouped_bm(C)``
    rows, C padded up to whole tiles, one tile run per expert; ``w0`` a
    dense stack [E, K, N], an int8 ``{"q", "scale"}`` leaf or a packed
    ``{"q4", "scale", ...}`` leaf, each to the kernels of its format, which
    read the codes as stored. Differentiable in x, a and b; W0 is
    frozen."""
    E, C, _ = x.shape
    bm = grouped_bm(C)
    return _grouped_apply(x, w0, a, b, _expert_gid(E, -(-C // bm), x.device),
                          bm, scale)


def _grouped_apply(x, w0, a, b, gid, bm, scale):
    """The grouped Function of ``w0``'s format over x [E, C, K] in tiles of
    ``bm`` rows routed by ``gid``."""
    if quant.is_packed(w0):
        if quant.packed_k(w0) != x.shape[-1]:
            raise ValueError(f"packed expert stack holds K="
                             f"{quant.packed_k(w0)} rows, x has "
                             f"{x.shape[-1]}")
        return _GroupedLoRAKernelP4.apply(x, w0["q4"], w0["scale"], a, b, gid,
                                          bm, scale, quant.packed_method(w0))
    if quant.is_quantized(w0):
        return _GroupedLoRAKernelQ.apply(x, w0["q"], w0["scale"], a, b, gid,
                                         bm, scale)
    return _GroupedLoRAKernel.apply(x, w0, a, b, gid, bm, scale)


def lora_grouped_ragged(x, group_sizes, w0, a, b, scale: float = 2.0, *,
                        bm: int = 8):
    """Ragged grouped LoRA linear (the reference's
    ``ops.lora_grouped_ragged``): x [M, K] is the concatenation of the
    groups' rows, ``group_sizes[g]`` rows for group g (zero-size groups
    allowed); w0 [E, K, N] (dense, an int8 ``{"q", "scale"}`` or a packed
    ``{"q4", "scale", ...}`` stack), a [E, K, r], b [E, r, N], E =
    ``len(group_sizes)`` -> [M, N]. The rows are packed into tiles of
    ``bm`` (each group padded to whole tiles, an empty group given none,
    ``kernels/tiling.py``) in plain PyTorch, so gradients flow through the
    packing; the grouped kernels' Functions run on the packed rows as one
    buffer, their tiles routed by the schedule's gid, both made anew each
    call (group sizes change from call to call). No row at all gives [0,
    N]."""
    sizes = tuple(int(s) for s in group_sizes)
    if quant.is_packed(w0):
        N = w0["q4"].shape[-1]
    elif quant.is_quantized(w0):
        N = w0["q"].shape[-1]
    else:
        N = w0.shape[-1]
    if sum(sizes) == 0:
        return x.new_zeros((0, N))
    gid = torch.from_numpy(_tiling.grouped_schedule(sizes, bm)[0]).to(
        x.device)
    xp = _tiling.pack_ragged_rows(x, sizes, bm)
    y = _grouped_apply(xp[None], w0, a, b, gid, bm, scale)[0]
    return _tiling.unpack_ragged_rows(y, sizes, bm)


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
# attention: the flash kernels (forward + lse-driven backward), the
# structured sdpa below ATTN_MIN_SEQ query rows
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """q [B,H,Nq,D], k/v [B,Hkv,Nk,D] -> out [B,H,Nq,D]. Saves exactly
    (q, k, v, out, lse) in the kernels' [B·H, N, D] layout: never the
    probabilities, and never a rotated q or k (with ``rope`` the kernels
    rotate on load). The rope tables are constants with no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, rope, causal, window):
        B, H, Nq, D = q.shape
        Hkv, Nk = k.shape[1], k.shape[2]
        q3 = q.reshape(B * H, Nq, D).contiguous()
        k3 = k.reshape(B * Hkv, Nk, D).contiguous()
        v3 = v.reshape(B * Hkv, Nk, D).contiguous()
        out, lse = _fa.flash_attention_fwd(
            q3, k3, v3, rope, causal=causal, window=window,
            q_per_kv=H // Hkv, return_lse=True)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.rope, ctx.causal, ctx.window = rope, causal, window
        ctx.shapes = (q.shape, k.shape)
        return out.view(B, H, Nq, D)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, lse = ctx.saved_tensors
        qs, ks = ctx.shapes
        dq, dk, dv = _fa.flash_attention_bwd(
            q3, k3, v3, out, lse, g.reshape(out.shape), ctx.rope,
            causal=ctx.causal, window=ctx.window, q_per_kv=qs[1] // ks[1])
        return dq.view(qs), dk.view(ks), dv.view(ks), None, None, None


def attention_supported(q, k) -> bool:
    """The reference's test for its flash path: [B,H,N,D] layouts, whole
    GQA groups and at least :data:`ATTN_MIN_SEQ` query rows."""
    if q.ndim != 4 or k.ndim != 4:
        return False
    H, Hkv = q.shape[1], k.shape[1]
    return Hkv >= 1 and H % Hkv == 0 and q.shape[2] >= ATTN_MIN_SEQ


def sdpa(q, k, v, *, causal: bool = True, window: int = 0, rope=None):
    """Attention dispatch, as the reference's: from :data:`ATTN_MIN_SEQ`
    query rows the flash kernels (:class:`_FlashAttention`), below it (or
    for a partial GQA group) the structured sdpa, which saves q, k, v and
    recomputes the probabilities. ``rope=(cos, sin)`` ([N, D/2] f32)
    arrives unapplied: the kernels rotate q and k tiles on load; the
    structured path applies the same tables first."""
    if not attention_supported(q, k):
        if rope is not None:
            q = _rope.apply_rope_tables(q, *rope)
            k = _rope.apply_rope_tables(k, *rope)
        return structured.sdpa(q, k, v, window, causal)
    return _FlashAttention.apply(q, k, v, rope, causal, window)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_COUNTED = {"lora_grouped_fwd": _lg.lora_grouped,
            "lora_grouped_q": _lg.lora_grouped_q,
            "lora_grouped_q4": _lg.lora_grouped_q4,
            "lora_grouped_gemm": _lg.lora_grouped_gemm,
            "lora_grouped_dx": _lg.lora_grouped_dx,
            "lora_grouped_dab": _lg.lora_grouped_dab,
            "lora_grouped_gemm_q": _lg.lora_grouped_gemm_q,
            "lora_grouped_gemm_q4": _lg.lora_grouped_gemm_q4,
            "lora_grouped_dx_q": _lg.lora_grouped_dx_q,
            "lora_grouped_dx_q4": _lg.lora_grouped_dx_q4,
            "rmsnorm_fwd": _rn.rmsnorm,
            "lora_fused_fwd": _lf.lora_fused, "lora_dx": _lf.lora_dx,
            "lora_dab": _lf.lora_dab, "rmsnorm_bwd": _rn.rmsnorm_bwd,
            "lora_fused_q": _lq.lora_fused_q, "lora_dx_q": _lq.lora_dx_q,
            "lora_fused_q4": _lp4.lora_fused_q4,
            "lora_dx_q4": _lp4.lora_dx_q4,
            "flash_fwd": _fa.flash_attention_fwd,
            "flash_bwd_dq": _fa.flash_bwd_dq,
            "flash_bwd_dkv": _fa.flash_bwd_dkv,
            "rope_fwd": _rope.rope_fwd}


def launch_counts() -> dict:
    """{kernel: launches} of every kernel wrapper."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
