"""Grouped LoRA forward for multi-tenant decode: the CUDA kernels of
``csrc/lora_grouped_fwd.cu``, their wrappers, and their plain PyTorch
versions.

Replace the TPU kernels of ``src/repro/kernels/lora_grouped.py`` in their
serving form: one shared base W0 (``Ew == 1``), a stack of R resident
adapters, and an int32 per-tile routing vector that stays on the device::

    y[m] = x[m] @ W0 + s · (x[m] @ A[g]) @ B[g],   g = gid[m // bm]

* :func:`lora_grouped` (``lora_grouped``, ``_grouped_fwd_kernel``): W0 in
  x's float type;
* :func:`lora_grouped_q` (``lora_grouped_q``, ``_grouped_fwd_q_kernel``):
  ``W0 = q · s``, int8 codes q [K, N] and an f32 scale row s [1, N];
* :func:`lora_grouped_q4` (``lora_grouped_q4``, ``_grouped_fwd_q4_kernel``
  with ``_unpack_tile``): ``W0 = w(q4) · s``, packed codes q4 uint8
  [ceil(K/2), N] (``core/quant.py``'s layout), w the sign-extended nibble
  (int4) or the nf4 codebook entry rounded to x's dtype.

Over a quantized base the codes become weights in x's dtype inside the
kernel and the scale multiplies the f32 accumulator once per output::

    y = round(acc · s + s_lora · round(h) @ B[g]),  acc = x @ w,  h = x @ A[g]

("round": to x's dtype), the TPU kernels' ``_finish``. The shared base is
passed as [K, N] (the reference's wrappers take ``quant.add_group_axis``'s
[1, K, N]); a per-expert base (``Ew == E``) belongs to MoE, not ported.

What bounds them on the H100: reading W0. Decode multiplies 8 rows by the
whole frozen base (2·M FLOPs per weight), far below the card's ridge of
~295 FLOPs per byte; one qwen2.5-0.5b decode step streams ~716 MB of W0
through the float kernel, ~358 MB of int8 codes or ~179 MB of packed ones.
Each W0 element is read once for up to 8 rows, h = x @ A[g] stays in
shared memory, and the ragged edges are masked instead of padded (the
source's header has the details).

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; a tensor on the CPU gets the plain version
(``*_ref``). ``<wrapper>.launches`` counts kernel launches. A gid outside
[0, R) gives NaN rows in the kernels and in the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_pack4 import METHOD_CODES, unpack_weights
from repro_torch.kernels.lora_quant import validate_base

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest LoRA rank the kernels take (``RMAX`` in the source)
MAX_RANK = 16

_P, _I, _F = _build.C_PTR, _build.C_INT, _build.C_FLOAT
_ARGTYPES = [_I] + [_P] * 6 + [_I] * 6 + [_F, _P]
_Q_ARGTYPES = [_I] + [_P] * 7 + [_I] * 6 + [_F, _P]
_Q4_ARGTYPES = [_I, _I] + [_P] * 7 + [_I] * 6 + [_F, _P]


# ------------------------------------------------------------ plain versions


def _grouped_ref(acc, x, a, b, gid, scale, bm, s=None):
    """The kernels' epilogue on the f32 product ``acc`` = x @ w: h rounded
    to x's dtype before it meets B, the scale row (if any) on ``acc``, rows
    of a gid outside [0, R) NaN, output in x's dtype."""
    row = gid.long().repeat_interleave(bm)
    bad = (row < 0) | (row >= a.shape[0])
    row = row.masked_fill(bad, 0)
    h = torch.einsum("mk,mkr->mr", x.float(), a[row].float()).to(x.dtype)
    delta = torch.einsum("mr,mrn->mn", h.float(), b[row].float())
    if s is not None:
        acc = acc * s.float()
    y = acc + scale * delta
    return y.masked_fill(bad[:, None], float("nan")).to(x.dtype)


def lora_grouped_ref(x, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """Plain version, with the kernel's arithmetic: f32 sums, h rounded to
    x's type before it meets B, output in x's type."""
    return _grouped_ref(x.float() @ w0.float(), x, a, b, gid, scale, bm)


def lora_grouped_q_ref(x, q, s, a, b, gid, scale: float = 2.0, *, bm: int):
    """Plain version over an int8 base: the f32 product over the codes in
    x's dtype, then ``acc · s``."""
    acc = x.float() @ q.to(x.dtype).float()
    return _grouped_ref(acc, x, a, b, gid, scale, bm, s)


def lora_grouped_q4_ref(x, q4, s, a, b, gid, scale: float = 2.0, *,
                        bm: int, method: str = "int4"):
    """Plain version over a packed base: the f32 product over the unpacked
    weights in x's dtype (K from x), then ``acc · s``."""
    w = unpack_weights(q4, method, x.dtype, x.shape[1])
    return _grouped_ref(x.float() @ w.float(), x, a, b, gid, scale, bm, s)


# ------------------------------------------------------------------ wrappers


def _validate_adapters(what, x, a, b, gid, bm, n):
    """x [M, K] f32/bf16, a [R, K, r], b [R, r, n] of x's dtype and gid
    int32 [M // bm], all contiguous on x's device. Returns (M, K, R, r)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16, not {x.dtype}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"gid must be int32, got {gid.dtype}")
    for name, t in (("x", x), ("a", a), ("b", b), ("gid", gid)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2 or a.ndim != 3 or b.ndim != 3:
        raise ValueError("expected x [M,K], a [R,K,r], b [R,r,N]")
    M, K = x.shape
    R, _, r = a.shape
    if a.shape[1] != K or b.shape != (R, r, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, N {n}")
    if bm < 1 or M % bm or gid.shape != (M // bm,):
        raise ValueError(f"rows {M} must be whole tiles of bm={bm}, with "
                         f"one gid per tile (got gid {tuple(gid.shape)})")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside 1..{MAX_RANK}")
    return M, K, R, r


def _validate(x, w0, a, b, gid, bm):
    if w0.ndim != 2:
        raise ValueError("expected x [M,K], w0 [K,N], a [R,K,r], b [R,r,N]")
    M, K, R, r = _validate_adapters("lora_grouped", x, a, b, gid, bm,
                                    w0.shape[1])
    if w0.dtype != x.dtype:
        raise TypeError(f"w0 is {w0.dtype}, x is {x.dtype}")
    if w0.device != x.device:
        raise ValueError(f"w0 is on {w0.device}, x is on {x.device}")
    if not w0.is_contiguous():
        raise ValueError("w0 must be contiguous")
    if w0.shape[0] != K:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w0 "
                         f"{tuple(w0.shape)}")
    return M, K, R, r


def _launch(lib_fn, argtypes, lead, x, base, a, b, gid, M, K, N, R, r, bm,
            scale):
    """Allocate y, launch ``lib_fn`` of ``lora_grouped_fwd`` with the
    leading int arguments ``lead`` and the base's pointers ``base``, check
    the launch."""
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_grouped_fwd", lib_fn, argtypes)
    with torch.cuda.device(x.device):
        rc = fn(*lead, x.data_ptr(), *(t.data_ptr() for t in base),
                a.data_ptr(), b.data_ptr(), gid.data_ptr(), y.data_ptr(), M,
                K, N, R, r, bm, float(scale),
                torch.cuda.current_stream().cuda_stream)
    _build.check("lora_grouped_fwd", rc, f"{lib_fn} launch")
    return y


def lora_grouped(x, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """x [M,K] (M % bm == 0), w0 [K,N], a [R,K,r], b [R,r,N],
    gid int32 [M // bm] -> y [M,N] in x's dtype."""
    if not x.is_cuda:
        return lora_grouped_ref(x, w0, a, b, gid, scale, bm=bm)
    M, K, R, r = _validate(x, w0, a, b, gid, bm)
    y = _launch("lora_grouped_fwd", _ARGTYPES, (_DTYPES[x.dtype],), x, (w0,),
                a, b, gid, M, K, w0.shape[1], R, r, bm, scale)
    lora_grouped.launches += 1
    return y


def lora_grouped_q(x, q, s, a, b, gid, scale: float = 2.0, *, bm: int):
    """x [M,K] (M % bm == 0), q int8 [K,N], s f32 [1,N], a [R,K,r],
    b [R,r,N], gid int32 [M // bm] -> y [M,N] in x's dtype."""
    if not x.is_cuda:
        return lora_grouped_q_ref(x, q, s, a, b, gid, scale, bm=bm)
    if q.ndim != 2:
        raise ValueError(f"lora_grouped_q: q must be [K, N], got "
                         f"{tuple(q.shape)}")
    N = q.shape[1]
    M, K, R, r = _validate_adapters("lora_grouped_q", x, a, b, gid, bm, N)
    validate_base("lora_grouped_q", x, q, s, torch.int8, (K, N), N)
    y = _launch("lora_grouped_q", _Q_ARGTYPES, (_DTYPES[x.dtype],), x,
                (q, s), a, b, gid, M, K, N, R, r, bm, scale)
    lora_grouped_q.launches += 1
    return y


def lora_grouped_q4(x, q4, s, a, b, gid, scale: float = 2.0, *, bm: int,
                    method: str = "int4"):
    """x [M,K] (M % bm == 0), q4 uint8 [ceil(K/2),N], s f32 [1,N],
    a [R,K,r], b [R,r,N], gid int32 [M // bm] -> y [M,N] in x's dtype.
    K comes from x: an odd K's pad nibble meets no column of x."""
    if method not in METHOD_CODES:
        raise ValueError(f"unknown packed method {method!r}; expected one "
                         f"of {tuple(METHOD_CODES)}")
    if not x.is_cuda:
        return lora_grouped_q4_ref(x, q4, s, a, b, gid, scale, bm=bm,
                                   method=method)
    if q4.ndim != 2:
        raise ValueError(f"lora_grouped_q4: q4 must be [ceil(K/2), N], got "
                         f"{tuple(q4.shape)}")
    N = q4.shape[1]
    M, K, R, r = _validate_adapters("lora_grouped_q4", x, a, b, gid, bm, N)
    validate_base("lora_grouped_q4", x, q4, s, torch.uint8,
                  ((K + 1) // 2, N), N)
    y = _launch("lora_grouped_q4", _Q4_ARGTYPES,
                (_DTYPES[x.dtype], METHOD_CODES[method]), x, (q4, s), a, b,
                gid, M, K, N, R, r, bm, scale)
    lora_grouped_q4.launches += 1
    return y


lora_grouped.launches = 0
lora_grouped_q.launches = 0
lora_grouped_q4.launches = 0
