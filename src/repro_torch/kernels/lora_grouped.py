"""Grouped LoRA kernels: the CUDA sources ``csrc/lora_grouped_fwd.cu``
(multi-tenant decode) and ``csrc/lora_grouped_train.cu`` (training over
per-expert stacks, MoE), their wrappers, and their plain PyTorch versions.

Replace the TPU kernels of ``src/repro/kernels/lora_grouped.py``. Rows come
in tiles of ``bm``, each tile of one group, and an int32 per-tile routing
vector ``gid`` stays on the device::

    y[m] = x[m] @ W0[g] + s · (x[m] @ A[g]) @ B[g],   g = gid[m // bm]

Serving (``lora_grouped_fwd.cu``): one shared base W0 (``Ew == 1``) and a
stack of R resident adapters.

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
[1, K, N]).

What bounds them on the H100: reading W0. Decode multiplies 8 rows by the
whole frozen base (2·M FLOPs per weight), far below the card's ridge of
~295 FLOPs per byte; one qwen2.5-0.5b decode step streams ~716 MB of W0
through the float kernel, ~358 MB of int8 codes or ~179 MB of packed ones.
In bf16 all three run one tensor-core body (``csrc/lora_grouped_decode_tc.
cuh``): W0 read once for up to 16 rows through a ring of 16-byte copies,
mma.sync on x and W0's fragments built in registers from every format,
h = x @ A[g] summed on the tensor cores in the same loop and kept on chip,
K split across a thread-block cluster by the plan chosen per shape on the
host (``autotune.choose_blocks``: a measured plan, else
:func:`decode_plan`'s) and passed to the C entry. In f32 they run
the CUDA-core body of ``lora_grouped_fwd.cu``. Ragged edges are masked
instead of padded (the sources' headers have the details).

Training over expert stacks (``lora_grouped_train.cu``): W0 [E, K, N] per
expert (``Ew == E``), A [E, K, r], B [E, r, N], each tile of ``bm`` rows
one expert's capacity buffer.

* :func:`lora_grouped_gemm` (``lora_grouped``, ``_grouped_fwd_kernel``
  with ``_w_index``): the forward above, h rounded to x's dtype before it
  meets B;
* :func:`lora_grouped_dx` (``lora_grouped_dx``, ``_grouped_dx_kernel``):
  ``dx = g @ W0[g]ᵀ + dh @ A[g]ᵀ`` with ``dh = round((s·g) @ B[g]ᵀ)`` per
  tile, the thin product the TPU wrapper made outside its kernel
  (``_grouped_dh``), made here in PyTorch too;
* :func:`lora_grouped_dab` (``lora_grouped_dab``, ``_grouped_dab_kernel``):
  per group ``dA = xᵀ·dh``, ``dB = round(x@A)ᵀ·round(s·g)`` over the
  group's tiles, h and dh recomputed on chip; a group with no tile gets
  zeros. In bf16 one launch on tensor cores (``csrc/lora_dab_tc.cuh``, the
  dense :func:`~repro_torch.kernels.lora_fused.lora_dab`'s body), a
  cluster a group, with no workspace; in f32 per 8-row block, reduced per
  group in a second launch.

Over quantized expert stacks (``Ew == E``): int8 codes q [E, K, N] or
packed q4 uint8 [E, ceil(K/2), N] with an f32 scale [E, 1, N] (the layouts
of ``core/quant.py``), read in place by both passes; dA/dB keep
:func:`lora_grouped_dab`, which never reads W0.

* :func:`lora_grouped_gemm_q` / :func:`lora_grouped_gemm_q4`
  (``lora_grouped_q`` / ``lora_grouped_q4`` with Ew = E,
  ``_grouped_fwd_q_kernel`` / ``_grouped_fwd_q4_kernel``): ``acc = x @ w``
  in f32 over the codes as weights in x's dtype, then
  ``round(acc·s + scale·round(h) @ B[g])``;
* :func:`lora_grouped_dx_q` / :func:`lora_grouped_dx_q4`
  (``lora_grouped_dx_q`` / ``_dx_q4``, ``_grouped_dx_q_kernel`` /
  ``_grouped_dx_q4_kernel``): ``round(round(g·round(s)) @ wᵀ + dh @ A[g]ᵀ)``,
  the scale folded onto g, dh the wrapper's as above.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; a tensor on the CPU gets the plain version
(``*_ref``). ``<wrapper>.launches`` counts kernel launches. A gid outside
[0, R) (or [0, E)) gives NaN rows in the kernels and in the plain
versions; :func:`lora_grouped_dab` adds such a tile to no group. Its
kernel carries the TPU kernel's contract that each group's tiles are
contiguous in ``gid``: a group whose tiles are not one run gets NaN in its
dA and dB, in the kernel and in the plain version (checking the values on
the host would stall the stream on every call).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.lora_fused import dab_plan_of
from repro_torch.kernels.lora_pack4 import METHOD_CODES, unpack_weights
from repro_torch.kernels.lora_quant import validate_base

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest LoRA rank the decode kernels take (``RMAX`` in their source)
MAX_RANK = 16
#: largest LoRA rank the training kernels take (``lora_gemm.cuh``'s RMAX)
TRAIN_MAX_RANK = 32

_P, _I, _F = _build.C_PTR, _build.C_INT, _build.C_FLOAT
# the decode entries: ..., scale, then the bf16 body's plan (split, bn,
# part, hc) and the stream
_ARGTYPES = [_I] + [_P] * 6 + [_I] * 6 + [_F] + [_I] * 4 + [_P]
_Q_ARGTYPES = [_I] + [_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P]
_Q4_ARGTYPES = [_I, _I] + [_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P]
_GEMM_ARGS = [_I] + [_P] * 6 + [_I] * 6 + [_F, _P]
_GDX_ARGS = [_I] + [_P] * 6 + [_I] * 6 + [_P]
_GDAB_ARGS = [_I] + [_P] * 8 + [_I] * 6 + [_F, _P]
_GQ_ARGS = [_I] + [_P] * 7 + [_I] * 6 + [_F, _P]
_GQ4_ARGS = [_I, _I] + [_P] * 7 + [_I] * 6 + [_F, _P]
_GDXQ_ARGS = [_I] + [_P] * 7 + [_I] * 6 + [_P]
_GDXQ4_ARGS = [_I, _I] + [_P] * 7 + [_I] * 6 + [_P]


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


#: the bf16 decode body's slab depth (K rows, whole byte rows of a packed
#: base), largest K split (the portable cluster size), h columns of a part
#: at most, and SM count the plan assumes when given none
DECODE_KD, DECODE_MAX_SPLIT, DECODE_MAX_H_COLS, H100_SMS = 128, 8, 64, 132


def _cdiv(a, b):
    return -(-a // b)


def _max_slots(M: int, part: int, bm: int) -> int:
    """The most tiles of ``bm`` rows that one part of ``part`` rows of M
    touches (``max_slots`` of ``csrc/lora_grouped_decode_tc.cuh``)."""
    most = 0
    for p in range(min(_cdiv(M, part), bm)):
        m0 = p * part
        most = max(most, (min(m0 + part, M) - 1) // bm - m0 // bm + 1)
    return most


@functools.lru_cache(maxsize=None)
def decode_plan(M: int, K: int, N: int, r: int, *, bm: int,
                sms: int = H100_SMS) -> dict:
    """The bf16 decode body's plan for x [M, K] -> y [M, N] at rank r in
    tiles of ``bm`` rows on a card of ``sms`` SMs. It depends on the
    shapes alone:

    * ``part``: rows a block holds, one m16 fragment (16), or 8 or 4 where
      the part's slots side by side would need more than 64 h columns
      (each slot r rounded up to 8 or 16); ``h_cols``: those columns, the
      sum rounded up to 16;
    * ``bn``: the column tile, 128 where N has two such tiles, else 64
      (128 holds one block an SM, 64 two);
    * ``split``: the members of a cluster over K's slabs of 128 rows, as
      many as the SMs hold of the tiles' blocks at once, at most 8 and at
      most one a slab.

    Each block's chain of round trips and barriers, and the x and A every
    block reads beside its W0 columns, set a launch's time more than the
    number of blocks does: fewer, wider blocks won at every decode shape
    (``scripts/profile_torch_grouped.py --family decode_sweep``).

    Also the grid's ``blocks`` and each member's K range (``k_ranges``,
    for the first member of a cluster [0, ...), whole slabs)."""
    rw = 8 if r <= 8 else 16
    part = next(p for p in (16, 8, 4)
                if _max_slots(M, p, bm) * rw <= DECODE_MAX_H_COLS)
    h_cols = _cdiv(_max_slots(M, part, bm) * rw, 16) * 16
    parts, nk = _cdiv(M, part), _cdiv(K, DECODE_KD)
    bn = 128 if N > 128 else 64
    tiles = _cdiv(N, bn) * parts
    per_sm = 1 if bn == 128 else 2
    split = max(1, min(DECODE_MAX_SPLIT, nk, per_sm * sms // tiles))
    ranges = [(z * nk // split * DECODE_KD,
               min(K, (z + 1) * nk // split * DECODE_KD))
              for z in range(split)]
    return {"split": split, "bn": bn, "part": part, "h_cols": h_cols,
            "slabs": nk, "blocks": tiles * split, "k_ranges": ranges}


_SMS = {}


def _sms(device) -> int:
    """SMs of ``device`` (cached: no call to the runtime after the first)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


#: the decode entries -> the reference's op names
_DECODE_OPS = {"lora_grouped_fwd": "lora_grouped",
               "lora_grouped_q": "lora_grouped_q",
               "lora_grouped_q4": "lora_grouped_q4"}


def _launch(lib_fn, argtypes, lead, x, base, a, b, gid, M, K, N, R, r, bm,
            scale, plan=None):
    """Allocate y, launch ``lib_fn`` of ``lora_grouped_fwd`` with the
    leading int arguments ``lead``, the base's pointers ``base`` and the
    bf16 body's plan (the f32 body takes none), check the launch. The
    plan's ``split`` and ``bn`` are ``plan``'s when given, else
    ``autotune.choose_blocks``'s (a measured plan, else
    :func:`decode_plan`'s); ``part`` and ``h_cols`` are the shapes'."""
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_grouped_fwd", lib_fn, argtypes)
    shape_plan = decode_plan(M, K, N, r, bm=bm, sms=_sms(x.device))
    with torch.cuda.device(x.device):
        if plan is None:
            plan = autotune.choose_blocks(_DECODE_OPS[lib_fn], x.dtype, M=M,
                                          K=K, N=N, r=r, bm=bm)
        split = plan.get("split", shape_plan["split"])
        bn = plan.get("bn", shape_plan["bn"])
        rc = fn(*lead, x.data_ptr(), *(t.data_ptr() for t in base),
                a.data_ptr(), b.data_ptr(), gid.data_ptr(), y.data_ptr(), M,
                K, N, R, r, bm, float(scale), split, bn, shape_plan["part"],
                shape_plan["h_cols"],
                torch.cuda.current_stream().cuda_stream)
    _build.check("lora_grouped_fwd", rc,
                 f"{lib_fn} launch (split {split}, bn {bn})")
    return y


def lora_grouped(x, w0, a, b, gid, scale: float = 2.0, *, bm: int,
                 plan=None):
    """x [M,K] (M % bm == 0), w0 [K,N], a [R,K,r], b [R,r,N],
    gid int32 [M // bm] -> y [M,N] in x's dtype. ``plan``: the bf16
    body's ``split`` and ``bn`` (default: ``autotune.choose_blocks``'s)."""
    if not x.is_cuda:
        return lora_grouped_ref(x, w0, a, b, gid, scale, bm=bm)
    M, K, R, r = _validate(x, w0, a, b, gid, bm)
    y = _launch("lora_grouped_fwd", _ARGTYPES, (_DTYPES[x.dtype],), x, (w0,),
                a, b, gid, M, K, w0.shape[1], R, r, bm, scale, plan)
    lora_grouped.launches += 1
    return y


def lora_grouped_q(x, q, s, a, b, gid, scale: float = 2.0, *, bm: int,
                   plan=None):
    """x [M,K] (M % bm == 0), q int8 [K,N], s f32 [1,N], a [R,K,r],
    b [R,r,N], gid int32 [M // bm] -> y [M,N] in x's dtype. ``plan`` as
    :func:`lora_grouped`'s."""
    if not x.is_cuda:
        return lora_grouped_q_ref(x, q, s, a, b, gid, scale, bm=bm)
    if q.ndim != 2:
        raise ValueError(f"lora_grouped_q: q must be [K, N], got "
                         f"{tuple(q.shape)}")
    N = q.shape[1]
    M, K, R, r = _validate_adapters("lora_grouped_q", x, a, b, gid, bm, N)
    validate_base("lora_grouped_q", x, q, s, torch.int8, (K, N), N)
    y = _launch("lora_grouped_q", _Q_ARGTYPES, (_DTYPES[x.dtype],), x,
                (q, s), a, b, gid, M, K, N, R, r, bm, scale, plan)
    lora_grouped_q.launches += 1
    return y


def lora_grouped_q4(x, q4, s, a, b, gid, scale: float = 2.0, *, bm: int,
                    method: str = "int4", plan=None):
    """x [M,K] (M % bm == 0), q4 uint8 [ceil(K/2),N], s f32 [1,N],
    a [R,K,r], b [R,r,N], gid int32 [M // bm] -> y [M,N] in x's dtype.
    K comes from x: an odd K's pad nibble meets no column of x. ``plan``
    as :func:`lora_grouped`'s."""
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
                gid, M, K, N, R, r, bm, scale, plan)
    lora_grouped_q4.launches += 1
    return y



# ------------------------------------------- training over expert stacks


def _tile_groups(gid, E):
    """(gid clipped into [0, E) as int64, the mask of tiles whose gid lies
    in [0, E))."""
    ok = (gid >= 0) & (gid < E)
    return gid.long().clamp(0, E - 1), ok


def _tile_w0(what, w0, e):
    """Each tile's W0, the stack entry of its group: [T, K, N]."""
    if w0.ndim != 3:
        raise ValueError(f"{what}: w0 must be a per-expert stack [E, K, N], "
                         f"got {tuple(w0.shape)}")
    return w0[e]


def _nan_rows(y, ok, bm):
    return y.masked_fill(~ok.repeat_interleave(bm)[:, None], float("nan"))


def _gemm_tiles_ref(x, w, s, a, b, e, ok, scale, bm):
    """The forward over each tile's weights w [T, K, N] (x's dtype) and
    scale s [T, 1, N] (f32, None for a float W0): ``acc = x @ w`` in f32,
    h rounded to x's type before it meets B, ``acc·s + scale·round(h)@B``,
    rows of a tile outside [0, E) NaN, output in x's type."""
    T = e.numel()
    xt = x.reshape(T, bm, -1).float()
    h = (xt @ a[e].float()).to(x.dtype)
    acc = xt @ w.float()
    if s is not None:
        acc = acc * s
    y = acc + scale * (h.float() @ b[e].float())
    return _nan_rows(y.reshape(T * bm, -1), ok, bm).to(x.dtype)


def lora_grouped_gemm_ref(x, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """Plain version of the forward over stacks, with the kernel's
    arithmetic: f32 sums, h rounded to x's type before it meets B, output
    in x's type, rows of a gid outside [0, E) NaN."""
    e, ok = _tile_groups(gid, a.shape[0])
    return _gemm_tiles_ref(x, _tile_w0("lora_grouped_gemm", w0, e), None, a,
                           b, e, ok, scale, bm)


def lora_grouped_gemm_q_ref(x, q, s, a, b, gid, scale: float = 2.0, *,
                            bm: int):
    """Plain version of the forward over int8 expert codes q [E, K, N] and
    scale s [E, 1, N], in the TPU kernel's arithmetic (not a dequantized
    product): the codes in x's dtype, ``acc = x @ q`` in f32, then
    ``acc·s + scale·round(h) @ B``."""
    e, ok = _tile_groups(gid, a.shape[0])
    return _gemm_tiles_ref(x, q[e].to(x.dtype), s[e], a, b, e, ok, scale, bm)


def lora_grouped_gemm_q4_ref(x, q4, s, a, b, gid, scale: float = 2.0, *,
                             bm: int, method: str = "int4"):
    """Plain version of the forward over packed expert codes q4 uint8
    [E, ceil(K/2), N] (K from x): each tile's nibbles as weights in x's
    dtype (nf4's codebook rounded to it, as ``_unpack_tile``), then as
    :func:`lora_grouped_gemm_q_ref`."""
    e, ok = _tile_groups(gid, a.shape[0])
    w = unpack_weights(q4[e], method, x.dtype, x.shape[1])
    return _gemm_tiles_ref(x, w, s[e], a, b, e, ok, scale, bm)


def _grouped_dh(g, b, gid, scale: float, *, bm: int):
    """``dh = round(round(s·g) @ B[g]ᵀ)`` per tile, [M, r] in g's dtype
    (the reference's ``_grouped_dh``): f32 sums; a gid outside [0, E)
    reads B[0] (its dx rows are NaN)."""
    T = gid.numel()
    e, _ = _tile_groups(gid, b.shape[0])
    sg = (scale * g).reshape(T, bm, -1).float()
    return (sg @ b[e].float().mT).to(g.dtype).reshape(T * bm, -1)


def _dx_tiles_ref(g, w, s, a, b, gid, scale, bm):
    """dx over each tile's weights w [T, K, N] (g's dtype) and scale s
    [T, 1, N] (f32, None for a float W0): ``g·round(s)`` rounded to g's
    type, dh rounded to it, f32 sums, one rounding of the output, rows of a
    gid outside [0, E) NaN."""
    T, E = gid.numel(), a.shape[0]
    e, ok = _tile_groups(gid, E)
    dh = _grouped_dh(g, b, gid, scale, bm=bm).reshape(T, bm, -1).float()
    gt = g.reshape(T, bm, -1)
    if s is not None:
        gt = gt * s.to(g.dtype)
    dx = gt.float() @ w.float().mT + dh @ a[e].float().mT
    return _nan_rows(dx.reshape(T * bm, -1), ok, bm).to(g.dtype)


def lora_grouped_dx_ref(g, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """Plain version of dx, with the kernel's arithmetic: dh rounded to
    g's type, f32 sums, one rounding of the output, rows of a gid outside
    [0, E) NaN."""
    e, _ = _tile_groups(gid, a.shape[0])
    return _dx_tiles_ref(g, _tile_w0("lora_grouped_dx", w0, e), None, a, b,
                         gid, scale, bm)


def lora_grouped_dx_q_ref(g, q, s, a, b, gid, scale: float = 2.0, *,
                          bm: int):
    """Plain version of dx over int8 expert codes, in the TPU kernel's
    arithmetic: ``(g·(s → g's dtype)) @ qᵀ + dh @ Aᵀ``, the scale folded
    onto g and rounded to g's type, the codes read as stored."""
    e, _ = _tile_groups(gid, a.shape[0])
    return _dx_tiles_ref(g, q[e].to(g.dtype), s[e], a, b, gid, scale, bm)


def lora_grouped_dx_q4_ref(g, q4, s, a, b, gid, scale: float = 2.0, *,
                           bm: int, method: str = "int4"):
    """Plain version of dx over packed expert codes (K from a): each tile's
    nibbles as weights in g's dtype, then as :func:`lora_grouped_dx_q_ref`."""
    e, _ = _tile_groups(gid, a.shape[0])
    w = unpack_weights(q4[e], method, g.dtype, a.shape[1])
    return _dx_tiles_ref(g, w, s[e], a, b, gid, scale, bm)


def lora_grouped_dab_ref(x, g, a, b, gid, scale: float = 2.0, *, bm: int):
    """Plain version of (dA [E, K, r], dB [E, r, N]): per tile
    ``sg = round(s·g)``, ``h = round(x@A[g])``, ``dh = round(sg@B[g]ᵀ)``,
    f32 sums over each group's tiles, cast to A's and B's dtype. A group
    with no tile gets zeros, a tile with a gid outside [0, E) goes to no
    group, and a group whose tiles are not one contiguous run gets NaN."""
    T, (E, K, r), N = gid.numel(), a.shape, b.shape[2]
    e, ok = _tile_groups(gid, E)
    xt = x.reshape(T, bm, K).float()
    sg = (scale * g.float()).to(x.dtype).float().reshape(T, bm, N)
    h = (xt @ a[e].float()).to(x.dtype).float()
    dh = (sg @ b[e].float().mT).to(x.dtype).float()
    # no boolean indexing (a host sync): a tile with no group adds zeros
    w = ok.float()[:, None, None]
    da = torch.zeros((E, K, r), device=x.device).index_add_(
        0, e, (xt.mT @ dh) * w)
    db = torch.zeros((E, r, N), device=x.device).index_add_(
        0, e, (h.mT @ sg) * w)
    t = torch.arange(T, device=x.device)
    first = torch.full((E,), T, device=x.device).scatter_reduce(
        0, e, torch.where(ok, t, T), "amin")
    last = torch.full((E,), -1, device=x.device).scatter_reduce(
        0, e, torch.where(ok, t, -1), "amax")
    count = torch.zeros(E, dtype=torch.long, device=x.device).index_add_(
        0, e, ok.long())
    split = ((count > 0) & (last - first + 1 != count))[:, None, None]
    return (da.masked_fill(split, float("nan")).to(a.dtype),
            db.masked_fill(split, float("nan")).to(b.dtype))


def _check_stacks(what, act, w0, a, b, gid, bm):
    """act [M, ·] (x, or g for dx) in f32 or bf16; a [E, K, r], b [E, r, N]
    and w0 [E, K, N] (None for dA/dB) of act's dtype; gid int32 [M // bm];
    all contiguous on act's device. Returns (M, K, N, E, r)."""
    if act.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16, not {act.dtype}")
    mats = {"a": a, "b": b, **({} if w0 is None else {"w0": w0})}
    for name, t in mats.items():
        if t.dtype != act.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            f"{act.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"{what}: gid must be int32, got {gid.dtype}")
    for name, t in {**mats, "gid": gid}.items():
        if t.device != act.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{act.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not act.is_contiguous():
        raise ValueError(f"{what}: activations must be contiguous")
    if act.ndim != 2 or a.ndim != 3 or b.ndim != 3 or (
            w0 is not None and w0.ndim != 3):
        raise ValueError(f"{what}: expected [M, ·] rows, a [E,K,r], "
                         "b [E,r,N] and w0 [E,K,N]")
    (E, K, r), N = a.shape, b.shape[2]
    if b.shape != (E, r, N) or (w0 is not None and w0.shape != (E, K, N)):
        raise ValueError(f"{what}: shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, w0 "
                         f"{None if w0 is None else tuple(w0.shape)}")
    M = act.shape[0]
    if bm < 1 or M % bm or gid.shape != (M // bm,):
        raise ValueError(f"{what}: rows {M} must be whole tiles of bm={bm}, "
                         f"one gid per tile (got gid {tuple(gid.shape)})")
    if not 1 <= r <= TRAIN_MAX_RANK:
        raise ValueError(f"{what}: LoRA rank {r} outside "
                         f"1..{TRAIN_MAX_RANK}")
    return M, K, N, E, r


def _cols(what, name, t, n):
    if t.shape[1] != n:
        raise ValueError(f"{what}: {name} has {t.shape[1]} columns, "
                         f"expected {n}")


#: the training forward's and dx's entries -> the reference's op names
#: (their plans are compile-time: ``autotune`` returns them as fixed)
_TRAIN_OPS = {"lora_grouped_gemm": "lora_grouped",
              "lora_grouped_gemm_q": "lora_grouped_q",
              "lora_grouped_gemm_q4": "lora_grouped_q4",
              "lora_grouped_dx": "lora_grouped_dx",
              "lora_grouped_dx_q": "lora_grouped_dx_q",
              "lora_grouped_dx_q4": "lora_grouped_dx_q4"}


def _launch_train(entry, argtypes, lead, act, ptrs, out_shape, dims,
                  scale=None):
    """Allocate the output, launch ``entry`` of ``lora_grouped_train`` with
    the leading ints ``lead``, the pointers ``ptrs`` and the output's, the
    ints ``dims`` (M, K, N, E, r, bm; and ``scale``), check the launch."""
    out = torch.empty(out_shape, dtype=act.dtype, device=act.device)
    fn = _build.function("lora_grouped_train", entry, argtypes)
    tail = () if scale is None else (float(scale),)
    with torch.cuda.device(act.device):
        if entry in _TRAIN_OPS:
            M, K, N, E, _, bm = dims
            autotune.choose_blocks(_TRAIN_OPS[entry], act.dtype, M=M, K=K,
                                   N=N, E=E, bm=bm)
        rc = fn(*lead, *(t.data_ptr() for t in ptrs), out.data_ptr(), *dims,
                *tail, torch.cuda.current_stream().cuda_stream)
    _build.check("lora_grouped_train", rc, f"{entry} launch")
    return out


def lora_grouped_gemm(x, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """x [M,K] (M % bm == 0), w0 [E,K,N], a [E,K,r], b [E,r,N], gid int32
    [M // bm] -> y [M,N] in x's dtype."""
    if not x.is_cuda:
        return lora_grouped_gemm_ref(x, w0, a, b, gid, scale, bm=bm)
    M, K, N, E, r = _check_stacks("lora_grouped_gemm", x, w0, a, b, gid, bm)
    _cols("lora_grouped_gemm", "x", x, K)
    y = _launch_train("lora_grouped_gemm", _GEMM_ARGS, (_DTYPES[x.dtype],), x,
                      (x, w0, a, b, gid), (M, N), (M, K, N, E, r, bm), scale)
    lora_grouped_gemm.launches += 1
    return y


def lora_grouped_dx(g, w0, a, b, gid, scale: float = 2.0, *, bm: int):
    """g [M,N] (M % bm == 0), w0 [E,K,N], a [E,K,r], b [E,r,N], gid int32
    [M // bm] -> dx [M,K] in g's dtype. W0 is read in place: no transposed
    copy is made."""
    if not g.is_cuda:
        return lora_grouped_dx_ref(g, w0, a, b, gid, scale, bm=bm)
    M, K, N, E, r = _check_stacks("lora_grouped_dx", g, w0, a, b, gid, bm)
    _cols("lora_grouped_dx", "g", g, N)
    dh = _grouped_dh(g, b, gid, scale, bm=bm)
    dx = _launch_train("lora_grouped_dx", _GDX_ARGS, (_DTYPES[g.dtype],), g,
                       (g, w0, a, dh, gid), (M, K), (M, K, N, E, r, bm))
    lora_grouped_dx.launches += 1
    return dx


def lora_grouped_dab(x, g, a, b, gid, scale: float = 2.0, *, bm: int):
    """x [M,K], g [M,N] (M % bm == 0), a [E,K,r], b [E,r,N], gid int32
    [M // bm], each group's tiles contiguous -> (dA [E,K,r], dB [E,r,N]) in
    a's and b's dtype (which is x's)."""
    if not x.is_cuda:
        return lora_grouped_dab_ref(x, g, a, b, gid, scale, bm=bm)
    M, K, N, E, r = _check_stacks("lora_grouped_dab", x, None, a, b, gid, bm)
    _cols("lora_grouped_dab", "x", x, K)
    if g.dtype != x.dtype or g.device != x.device or not g.is_contiguous() \
            or g.shape != (M, N):
        raise ValueError(f"lora_grouped_dab: g must be a contiguous [{M}, "
                         f"{N}] {x.dtype} tensor on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    size = 0 if x.dtype == torch.bfloat16 else _build.function(
        "lora_grouped_train", "lora_grouped_dab_workspace", [_I] * 5,
        restype=_build.C_LONGLONG)(M, K, N, r, bm)
    ws = torch.empty(size, dtype=torch.float32, device=x.device)
    da = torch.empty((E, K, r), dtype=a.dtype, device=x.device)
    db = torch.empty((E, r, N), dtype=b.dtype, device=x.device)
    fn = _build.function("lora_grouped_train", "lora_grouped_dab",
                         _GDAB_ARGS)
    with torch.cuda.device(x.device):
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), a.data_ptr(),
                b.data_ptr(), gid.data_ptr(), ws.data_ptr(), da.data_ptr(),
                db.data_ptr(), M, K, N, E, r, bm, float(scale),
                torch.cuda.current_stream().cuda_stream)
    _build.check("lora_grouped_train", rc, "lora_grouped_dab launch")
    lora_grouped_dab.launches += 1
    return da, db


def dab_plan(M: int, K: int, N: int, E: int, r: int, *, bm: int) -> dict:
    """The bf16 :func:`lora_grouped_dab`'s plan for x [M, K], g [M, N] in
    tiles of ``bm`` rows over E groups at rank r
    (:func:`~repro_torch.kernels.lora_fused.dab_plan_of`; one sub-run, no
    workspace)."""
    return dab_plan_of("lora_grouped_train", "lora_grouped_dab_plan", M, K,
                       N, E, r, bm)


def lora_grouped_gemm_q(x, q, s, a, b, gid, scale: float = 2.0, *,
                        bm: int):
    """x [M,K] (M % bm == 0), q int8 [E,K,N], s f32 [E,1,N], a [E,K,r],
    b [E,r,N], gid int32 [M // bm] -> y [M,N] in x's dtype."""
    if not x.is_cuda:
        return lora_grouped_gemm_q_ref(x, q, s, a, b, gid, scale, bm=bm)
    what = "lora_grouped_gemm_q"
    M, K, N, E, r = _check_stacks(what, x, None, a, b, gid, bm)
    _cols(what, "x", x, K)
    validate_base(what, x, q, s, torch.int8, (E, K, N), N)
    y = _launch_train(what, _GQ_ARGS, (_DTYPES[x.dtype],), x,
                      (x, q, s, a, b, gid), (M, N), (M, K, N, E, r, bm),
                      scale)
    lora_grouped_gemm_q.launches += 1
    return y


def lora_grouped_gemm_q4(x, q4, s, a, b, gid, scale: float = 2.0, *,
                         bm: int, method: str = "int4"):
    """x [M,K] (M % bm == 0), q4 uint8 [E,ceil(K/2),N], s f32 [E,1,N],
    a [E,K,r], b [E,r,N], gid int32 [M // bm] -> y [M,N] in x's dtype. K
    comes from x and a: an odd K's pad nibble meets no column of x."""
    if method not in METHOD_CODES:
        raise ValueError(f"unknown packed method {method!r}; expected one "
                         f"of {tuple(METHOD_CODES)}")
    if not x.is_cuda:
        return lora_grouped_gemm_q4_ref(x, q4, s, a, b, gid, scale, bm=bm,
                                        method=method)
    what = "lora_grouped_gemm_q4"
    M, K, N, E, r = _check_stacks(what, x, None, a, b, gid, bm)
    _cols(what, "x", x, K)
    validate_base(what, x, q4, s, torch.uint8, (E, (K + 1) // 2, N), N)
    y = _launch_train(what, _GQ4_ARGS,
                      (_DTYPES[x.dtype], METHOD_CODES[method]), x,
                      (x, q4, s, a, b, gid), (M, N), (M, K, N, E, r, bm),
                      scale)
    lora_grouped_gemm_q4.launches += 1
    return y


def lora_grouped_dx_q(g, q, s, a, b, gid, scale: float = 2.0, *, bm: int):
    """g [M,N] (M % bm == 0), q int8 [E,K,N], s f32 [E,1,N], a [E,K,r],
    b [E,r,N], gid int32 [M // bm] -> dx [M,K] in g's dtype. The codes are
    read in place: no transposed copy is made."""
    if not g.is_cuda:
        return lora_grouped_dx_q_ref(g, q, s, a, b, gid, scale, bm=bm)
    what = "lora_grouped_dx_q"
    M, K, N, E, r = _check_stacks(what, g, None, a, b, gid, bm)
    _cols(what, "g", g, N)
    validate_base(what, g, q, s, torch.int8, (E, K, N), N)
    dh = _grouped_dh(g, b, gid, scale, bm=bm)
    dx = _launch_train(what, _GDXQ_ARGS, (_DTYPES[g.dtype],), g,
                       (g, q, s, a, dh, gid), (M, K), (M, K, N, E, r, bm))
    lora_grouped_dx_q.launches += 1
    return dx


def lora_grouped_dx_q4(g, q4, s, a, b, gid, scale: float = 2.0, *,
                       bm: int, method: str = "int4"):
    """g [M,N] (M % bm == 0), q4 uint8 [E,ceil(K/2),N], s f32 [E,1,N],
    a [E,K,r], b [E,r,N], gid int32 [M // bm] -> dx [M,K] in g's dtype (K
    from a; no row past K is written)."""
    if method not in METHOD_CODES:
        raise ValueError(f"unknown packed method {method!r}; expected one "
                         f"of {tuple(METHOD_CODES)}")
    if not g.is_cuda:
        return lora_grouped_dx_q4_ref(g, q4, s, a, b, gid, scale, bm=bm,
                                      method=method)
    what = "lora_grouped_dx_q4"
    M, K, N, E, r = _check_stacks(what, g, None, a, b, gid, bm)
    _cols(what, "g", g, N)
    validate_base(what, g, q4, s, torch.uint8, (E, (K + 1) // 2, N), N)
    dh = _grouped_dh(g, b, gid, scale, bm=bm)
    dx = _launch_train(what, _GDXQ4_ARGS,
                       (_DTYPES[g.dtype], METHOD_CODES[method]), g,
                       (g, q4, s, a, dh, gid), (M, K), (M, K, N, E, r, bm))
    lora_grouped_dx_q4.launches += 1
    return dx


#: the dx's W0 formats by their ``wfmt::WFmt`` values (``csrc/wfmt.cuh``)
_DX_FORMATS = {"none": 0, "int8": 1, "int4": 2, "nf4": 3}


def dx_plan(dtype, method: str = "none", *, bm: int) -> dict:
    """Which body the dx over ``method``'s stack (``none``: a float W0)
    runs on the card in ``dtype`` for tiles of ``bm`` rows:
    ``row_fragments``, its m16 row fragments on tensor cores (bf16), or 0
    (f32, the CUDA-core body); ``smem_bytes``, the dynamic shared memory
    the CUDA runtime holds for that instance (what its last launch set; 0
    for the CUDA-core body)."""
    import ctypes
    out = ctypes.POINTER(ctypes.c_int)
    fn = _build.function("lora_grouped_train", "lora_grouped_dx_plan",
                         [_I, _I, _I, out, out])
    mf, smem = ctypes.c_int(-1), ctypes.c_int(-1)
    _build.check("lora_grouped_train",
                 fn(_DTYPES[dtype], _DX_FORMATS[method], bm,
                    ctypes.byref(mf), ctypes.byref(smem)),
                 "lora_grouped_dx_plan")
    return {"tensor_cores": mf.value > 0, "row_fragments": mf.value,
            "smem_bytes": smem.value}


lora_grouped.launches = 0
lora_grouped_q.launches = 0
lora_grouped_q4.launches = 0
lora_grouped_gemm.launches = 0
lora_grouped_dx.launches = 0
lora_grouped_dab.launches = 0
lora_grouped_gemm_q.launches = 0
lora_grouped_gemm_q4.launches = 0
lora_grouped_dx_q.launches = 0
lora_grouped_dx_q4.launches = 0
