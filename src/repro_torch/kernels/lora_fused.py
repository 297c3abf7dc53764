"""The LoRA linear's three training kernels: the CUDA sources
``csrc/lora_fused_fwd.cu``, ``csrc/lora_dx.cu`` and ``csrc/lora_dab.cu``,
their wrappers, and their plain PyTorch versions.

Replace the TPU kernels of ``src/repro/kernels/lora_fused.py``:

* :func:`lora_fused` (``lora_fused``, ``_lora_fused_kernel``):
  ``y = x@W0 + s·round(x@A)@B``, h summed on chip and never stored;
* :func:`lora_dx` (``lora_dx``, ``_lora_dx_kernel``):
  ``dx = g@W0ᵀ + dh@Aᵀ`` with ``dh = round((s·g)@Bᵀ)``, the thin product
  the TPU wrapper computed outside its kernel: the bf16 kernel sums it in
  its own loop (one launch, no dh in device memory), the f32 wrapper
  computes it before its kernel; W0 is read in place;
* :func:`lora_dab` (``lora_dab``, ``_lora_dab_kernel``):
  ``dA = xᵀ·dh``, ``dB = hᵀ·round(s·g)`` with h and dh recomputed on chip:
  in bf16 one launch on tensor cores (``csrc/lora_dab_tc.cuh``), x and g
  read once, at most a few sub-run partials added in a fixed order; in f32
  per 8-row tile, reduced over tiles in a fixed order (no atomics).

"round" is a rounding to x's dtype, where the TPU kernels round; every sum
is f32. What bounds each kernel on the H100 and how its design answers it
is in its source's header.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; a tensor on the CPU gets the plain version
(``*_ref``). ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, autotune

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest LoRA rank the kernels take (``RMAX`` in the sources)
MAX_RANK = 32

_P, _I, _F = _build.C_PTR, _build.C_INT, _build.C_FLOAT
_FWD_ARGS = [_I] + [_P] * 5 + [_I] * 4 + [_F, _I, _P]
_DX_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_DX_TC_ARGS = [_P] * 5 + [_I] * 4 + [_F, _I, _P]
_DAB_ARGS = [_I] + [_P] * 8 + [_I] * 4 + [_F, _P]


# ------------------------------------------------------------ plain versions


def _dh(g, b, scale: float):
    """``dh = round((s·g)@Bᵀ)``: s·g rounded to g's dtype, f32 sum."""
    return ((scale * g).float() @ b.float().T).to(g.dtype)


def lora_fused_ref(x, w0, a, b, scale: float = 2.0):
    """Plain version of the forward, in the TPU kernel's roundings."""
    xf = x.float()
    h = (xf @ a.float()).to(x.dtype)
    return (xf @ w0.float() + scale * (h.float() @ b.float())).to(x.dtype)


def lora_dx_ref(g, w0, a, b, scale: float = 2.0):
    """Plain version of dx, in the TPU kernel's roundings."""
    dh = _dh(g, b, scale)
    return (g.float() @ w0.float().T + dh.float() @ a.float().T).to(g.dtype)


def lora_dab_ref(x, g, a, b, scale: float = 2.0):
    """Plain version of (dA, dB), in the TPU kernel's roundings."""
    sg = (scale * g.float()).to(x.dtype).float()
    h = (x.float() @ a.float()).to(x.dtype).float()
    dh = (sg @ b.float().T).to(x.dtype).float()
    return (x.float().T @ dh).to(a.dtype), (h.T @ sg).to(b.dtype)


# ------------------------------------------------------------------ wrappers


def _validate(what, x, mats, shapes):
    """x and ``mats`` ({name: tensor}) on one device, contiguous, of x's
    dtype (f32 or bf16), with the given shapes ({name: shape})."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16, not {x.dtype}")
    for name, t in mats.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            f"{x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[name])}")


def _dims(x, w0, a):
    if x.ndim != 2 or w0.ndim != 2 or a.ndim != 2:
        raise ValueError("expected 2-D operands")
    r = a.shape[1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside 1..{MAX_RANK}")
    return r


def _stream():
    return torch.cuda.current_stream().cuda_stream


def split_of(op: str, dtype, M: int, K: int, N: int, split=None) -> int:
    """The bf16 dense body's split for ``op`` at M x K -> N (dx: g [M, N]
    -> dx [M, K]): ``split`` when the caller gives one, else
    ``autotune.choose_blocks``'s (a measured plan, else the heuristic);
    the f32 bodies take none (1 is passed and ignored). Call it with the
    launch's device current."""
    if split is not None:
        return int(split)
    return int(autotune.choose_blocks(op, dtype, M=M, K=K, N=N
                                      ).get("split", 1))


def lora_fused(x, w0, a, b, scale: float = 2.0, *, split=None):
    """x [M,K], w0 [K,N], a [K,r], b [r,N] -> y [M,N] in x's dtype.
    ``split``: the bf16 body's K split (default: ``split_of``'s)."""
    if not x.is_cuda:
        return lora_fused_ref(x, w0, a, b, scale)
    r = _dims(x, w0, a)
    M, K = x.shape
    N = w0.shape[1]
    _validate("lora_fused_fwd", x,
              {"x": x, "w0": w0, "a": a, "b": b},
              {"x": (M, K), "w0": (K, N), "a": (K, r), "b": (r, N)})
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.function("lora_fused_fwd", "lora_fused_fwd", _FWD_ARGS)
    with torch.cuda.device(x.device):
        split = split_of("lora_fused", x.dtype, M, K, N, split)
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), w0.data_ptr(), a.data_ptr(),
                b.data_ptr(), y.data_ptr(), M, K, N, r, float(scale), split,
                _stream())
    _build.check("lora_fused_fwd", rc, f"lora_fused_fwd launch (split "
                 f"{split})")
    lora_fused.launches += 1
    return y


#: each base format's bf16 forward: (op, library, plan entry, leading args)
_PLANS = {"none": ("lora_fused", "lora_fused_fwd", "lora_fused_fwd_plan",
                   ()),
          "int8": ("lora_fused_q", "lora_quant", "lora_fused_q_plan", ()),
          "int4": ("lora_fused_q4", "lora_pack4", "lora_fused_q4_plan", (0,)),
          "nf4": ("lora_fused_q4", "lora_pack4", "lora_fused_q4_plan", (1,))}
#: each base format's bf16 dx: (op, library, plan entry, leading args)
_DX_PLANS = {"none": ("lora_dx", "lora_dx", "lora_dx_plan", ()),
             "int8": ("lora_dx_q", "lora_quant", "lora_dx_q_plan", ()),
             "int4": ("lora_dx_q4", "lora_pack4", "lora_dx_q4_plan", (0,)),
             "nf4": ("lora_dx_q4", "lora_pack4", "lora_dx_q4_plan", (1,))}


def _plan(op, lib, name, lead, M, K, N, split):
    fn = _build.function(lib, name, [_I] * (len(lead) + 4)
                         + [ctypes.POINTER(ctypes.c_int)])
    split = split_of(op, torch.bfloat16, M, K, N, split)
    smem = ctypes.c_int(-1)
    _build.check(lib, fn(*lead, M, K, N, split, ctypes.byref(smem)),
                 f"{name} (split {split})")
    return {"split": split, "smem_bytes": smem.value}


def forward_plan(M: int, K: int, N: int, method: str = "none",
                 split=None) -> dict:
    """The bf16 forward's launch plan on the card at M x K -> N over a W0
    in ``method``'s format (``none``: bf16): ``split``, the blocks of each
    output tile's cluster, which share K (the one given, else
    ``split_of``'s; the C entry checks its limits); ``smem_bytes``, the
    dynamic shared memory the CUDA runtime holds for the instance M
    selects (what that instance's last launch set)."""
    return _plan(*_PLANS[method], M, K, N, split)


def dx_plan(M: int, K: int, N: int, method: str = "none",
            split=None) -> dict:
    """The bf16 dx's launch plan on the card for g [M, N] -> dx [M, K] over
    a W0 [K, N] in ``method``'s format: ``split``, the blocks of each
    output tile's cluster, which share the contraction N; ``smem_bytes``
    as in :func:`forward_plan`."""
    return _plan(*_DX_PLANS[method], M, K, N, split)


def lora_dx(g, w0, a, b, scale: float = 2.0, *, split=None):
    """g [M,N], w0 [K,N], a [K,r], b [r,N] -> dx [M,K] in g's dtype.
    ``split``: the bf16 body's split of N (default: ``split_of``'s)."""
    if not g.is_cuda:
        return lora_dx_ref(g, w0, a, b, scale)
    r = _dims(g, w0, a)
    M, N = g.shape
    K = w0.shape[0]
    _validate("lora_dx", g, {"g": g, "w0": w0, "a": a, "b": b},
              {"g": (M, N), "w0": (K, N), "a": (K, r), "b": (r, N)})
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        split = split_of("lora_dx", g.dtype, M, K, N, split)
        if g.dtype == torch.bfloat16:
            fn = _build.function("lora_dx", "lora_dx_tc", _DX_TC_ARGS)
            rc = fn(g.data_ptr(), w0.data_ptr(), a.data_ptr(), b.data_ptr(),
                    dx.data_ptr(), M, K, N, r, float(scale), split,
                    _stream())
        else:
            dh = _dh(g, b, scale)
            fn = _build.function("lora_dx", "lora_dx", _DX_ARGS)
            rc = fn(g.data_ptr(), w0.data_ptr(), a.data_ptr(), dh.data_ptr(),
                    dx.data_ptr(), M, K, N, r, _stream())
    _build.check("lora_dx", rc, f"lora_dx launch (split {split})")
    lora_dx.launches += 1
    return dx


#: the keys of a bf16 dA/dB plan (``csrc/lora_dab_tc.cuh``)
DAB_PLAN_KEYS = ("members", "sub_runs", "passes", "row_fragments", "slabs",
                 "smem_bytes", "workspace", "counts")


def dab_plan_of(lib: str, entry: str, *dims) -> dict:
    """The bf16 dA/dB body's launch plan from ``lib``'s ``entry`` at
    ``dims``: ``members`` (C, the blocks of a cluster, which share K's and
    N's columns), ``sub_runs`` (S, the clusters of a dense launch's rows),
    ``passes`` (Q, over a member's columns), ``row_fragments`` (m16
    fragments a chunk of rows), ``slabs`` (1 or 2), ``smem_bytes``,
    ``workspace`` (f32 elements of the S partials) and ``counts`` (the
    zeroed int32 the launch needs)."""
    out = (ctypes.c_longlong * 8)()
    fn = _build.function(lib, entry, [_I] * len(dims) + [_P])
    _build.check(lib, fn(*dims, out), entry)
    return dict(zip(DAB_PLAN_KEYS, out))


@functools.lru_cache(maxsize=None)
def dab_plan(M: int, K: int, N: int, r: int) -> dict:
    """The bf16 :func:`lora_dab`'s plan at x [M, K], g [M, N], rank r
    (:func:`dab_plan_of`)."""
    return dab_plan_of("lora_dab", "lora_dab_plan", M, K, N, r)


#: per device index: int32 zeros, the counts of the bf16 dA/dB's last-block
#: sum; each launch leaves them zero (launches on one stream at a time)
_COUNTS = {}


def _zero_counts(device, n: int):
    t = _COUNTS.get(device.index)
    if t is None or t.numel() < n:
        t = _COUNTS[device.index] = torch.zeros(max(n, 64),
                                                dtype=torch.int32,
                                                device=device)
    return t


def lora_dab(x, g, a, b, scale: float = 2.0):
    """x [M,K], g [M,N], a [K,r], b [r,N] -> (dA [K,r], dB [r,N]) in a's
    and b's dtype (which is x's)."""
    if not x.is_cuda:
        return lora_dab_ref(x, g, a, b, scale)
    r = _dims(x, g, a)
    M, K = x.shape
    N = g.shape[1]
    _validate("lora_dab", x, {"x": x, "g": g, "a": a, "b": b},
              {"x": (M, K), "g": (M, N), "a": (K, r), "b": (r, N)})
    cnt = None
    with torch.cuda.device(x.device):
        # the plan is the shapes' (dab_plan): nothing for the cache to
        # choose, but the reference's dispatch asks here too
        autotune.choose_blocks("lora_dab", x.dtype, M=M, K=K, N=N)
        if x.dtype == torch.bfloat16:
            plan = dab_plan(M, K, N, r)
            size = plan["workspace"]
            if plan["counts"]:
                cnt = _zero_counts(x.device, plan["counts"])
        else:
            size = _build.function(
                "lora_dab", "lora_dab_workspace", [_I] * 4,
                restype=_build.C_LONGLONG)(M, K, N, r)
        ws = torch.empty(size, dtype=torch.float32, device=x.device)
        da = torch.empty((K, r), dtype=a.dtype, device=x.device)
        db = torch.empty((r, N), dtype=b.dtype, device=x.device)
        fn = _build.function("lora_dab", "lora_dab", _DAB_ARGS)
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), a.data_ptr(),
                b.data_ptr(), ws.data_ptr(),
                None if cnt is None else cnt.data_ptr(), da.data_ptr(),
                db.data_ptr(), M, K, N, r, float(scale), _stream())
    _build.check("lora_dab", rc, "lora_dab launch")
    lora_dab.launches += 1
    return da, db


lora_fused.launches = 0
lora_dx.launches = 0
lora_dab.launches = 0
