"""Flash attention (``repro.kernels.flash_attention``): the CUDA sources
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (shared pieces in
``csrc/flash_common.cuh``), their wrappers, and their plain PyTorch
versions.

Replace the TPU kernels of ``src/repro/kernels/flash_attention.py``:

* :func:`flash_attention_fwd` (``flash_attention_fwd``, ``_fwd_kernel``):
  online-softmax attention emitting out and the row logsumexp lse; the
  [Nq, Nk] probabilities never reach device memory;
* :func:`flash_bwd_dq` (``_bwd_dq_kernel``) and :func:`flash_bwd_dkv`
  (``_bwd_dkv_kernel``), the two bodies of ``flash_attention_bwd``: the
  probabilities are recomputed from lse; dk and dv are summed over each
  kv head's group of q heads. :func:`flash_attention_bwd` runs both.

Layouts are the reference's: q, g and out [B·H, Nq, D]; k and v
[B·Hkv, Nk, D], q head ``bh`` reading kv head ``bh // q_per_kv`` (K and V
are never repeated); lse [B·H, Nq] f32. ``rope=(cos, sin)`` ([N, D/2] f32,
Nq == Nk) rotates q and k inside the kernels and counter-rotates dq and dk.
Masks: causal ``q_pos >= k_pos``, a window ``q_pos - k_pos < window``,
positions counted from 0 on both sides; any Nq and Nk. A row that sees no
key gets out 0 and lse exactly -1e30, and zero gradients.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take (a D that is not a multiple of 8 up to 256, mixed
types, other than f32 or bf16, a bf16 q, k, v or g not 16-byte aligned);
bf16 runs on tensor cores, f32 on CUDA cores (tensor cores would round f32
operands to TF32). A tensor on the CPU gets the plain version
(``*_ref``), which computes the same function densely with the same
roundings. ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.rope import apply_rope_tables

NEG_INF = -1e30
#: widest head the kernels take (D a multiple of 8 up to this)
MAX_D = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = _build.C_PTR, _build.C_INT
_FWD_ARGS = [_I] + [_P] * 7 + [_I] * 7 + [_P]
_DQ_ARGS = [_I] + [_P] * 9 + [_I] * 7 + [_P]
_DKV_ARGS = [_I] + [_P] * 10 + [_I] * 7 + [_P]
#: what the bf16 kernels copy in 16-byte rows
_ALIGNED = ("q", "k", "v", "g")


# ------------------------------------------------------------ plain versions


def _scale(D: int) -> float:
    return float(1.0 / (D ** 0.5))


def _mask(nq: int, nk: int, causal: bool, window: int, device):
    """[nq, nk] bool: the (q, k) pairs the attention may use."""
    qp = torch.arange(nq, device=device)[:, None]
    kp = torch.arange(nk, device=device)[None, :]
    ok = torch.ones(nq, nk, dtype=torch.bool, device=device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    return ok


def _rotated(q, k, rope):
    if rope is None:
        return q, k
    return apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)


def _counter_rotated(x, rope):
    """R₋θ of an f32 gradient (the rotation is orthogonal)."""
    return x if rope is None else apply_rope_tables(x, rope[0], -rope[1])


def _grouped(x, G: int):
    """[B·H, N, D] -> [B·Hkv, G, N, D] (a view)."""
    return x.reshape(-1, G, *x.shape[1:])


def _scores(q, k, G: int):
    """s = (q kᵀ)·scale in f32: [B·Hkv, G, Nq, Nk]."""
    s = torch.einsum("bgqd,bkd->bgqk", _grouped(q.float(), G), k.float())
    return s * _scale(q.shape[-1])


def flash_attention_fwd_ref(q, k, v, rope=None, *, causal: bool = True,
                            window: int = 0, q_per_kv: int = 1,
                            return_lse: bool = False):
    """Plain version of the forward: p rounded to v's dtype before p@v, l
    summing the unrounded p, out = acc / max(l, 1e-30) in q's dtype."""
    BH, Nq, D = q.shape
    qr, kr = _rotated(q, k, rope)
    ok = _mask(Nq, k.shape[1], causal, window, q.device)
    s = _scores(qr, kr, q_per_kv).masked_fill(~ok, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~ok, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bgqk,bkd->bgqd", p.to(v.dtype).float(), v.float())
    never = ~ok.any(-1)                                        # [Nq]
    out = torch.where(never[:, None], 0.0, acc / l).to(q.dtype)
    lse = torch.where(never, NEG_INF, (m + torch.log(l))[..., 0])
    out, lse = out.reshape(BH, Nq, D), lse.reshape(BH, Nq)
    return (out, lse) if return_lse else out


def _probs(q, k, lse, rope, causal, window, G):
    """(rotated q, rotated k, p = exp(s - lse) with an explicit 0 on
    masked pairs) -- a fully masked row has lse = -1e30."""
    qr, kr = _rotated(q, k, rope)
    ok = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = _scores(qr, kr, G) - _grouped(lse, G)[..., None]
    return qr, kr, torch.exp(s.masked_fill(~ok, NEG_INF))


def _ds(p, g, v, delta, G: int):
    """ds = round(p·(dp − delta)·scale) with dp = g vᵀ in f32."""
    dp = torch.einsum("bgqd,bkd->bgqk", _grouped(g.float(), G), v.float())
    ds = p * (dp - _grouped(delta, G)[..., None]) * _scale(g.shape[-1])
    return ds.to(g.dtype).float()


def flash_bwd_dq_ref(q, k, v, g, lse, delta, rope=None, *,
                     causal: bool = True, window: int = 0,
                     q_per_kv: int = 1):
    """Plain version of ``_bwd_dq_kernel``: dq = ds k (k rotated), counter-
    rotated in f32, in q's dtype. g is in q's dtype."""
    G = q_per_kv
    _, kr, p = _probs(q, k, lse, rope, causal, window, G)
    dq = torch.einsum("bgqk,bkd->bgqd", _ds(p, g, v, delta, G), kr.float())
    return _counter_rotated(dq.reshape(q.shape), rope).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, g, lse, delta, rope=None, *,
                      causal: bool = True, window: int = 0,
                      q_per_kv: int = 1):
    """Plain version of ``_bwd_dkv_kernel``: dk = dsᵀ q (q rotated) and
    dv = round(p)ᵀ g, each summed over the group's q heads in f32 before
    one cast; dk counter-rotated in f32."""
    G = q_per_kv
    qr, _, p = _probs(q, k, lse, rope, causal, window, G)
    ds = _ds(p, g, v, delta, G)
    dk = torch.einsum("bgqk,bgqd->bkd", ds, _grouped(qr.float(), G))
    dv = torch.einsum("bgqk,bgqd->bkd", p.to(q.dtype).float(),
                      _grouped(g.float(), G))
    return _counter_rotated(dk, rope).to(k.dtype), dv.to(v.dtype)


def bwd_delta(g, out):
    """delta = Σ_d g·out in f32, from g as it arrives (the reference's
    tile-local form of Σ dprobs ⊙ probs)."""
    return (g.float() * out.float()).sum(-1)


def flash_attention_bwd_ref(q, k, v, out, lse, g, rope=None, *,
                            causal: bool = True, window: int = 0,
                            q_per_kv: int = 1):
    """Plain version of the backward: (dq, dk, dv)."""
    delta, gq = bwd_delta(g, out), g.to(q.dtype)
    kw = dict(causal=causal, window=window, q_per_kv=q_per_kv)
    dq = flash_bwd_dq_ref(q, k, v, gq, lse, delta, rope, **kw)
    return (dq, *flash_bwd_dkv_ref(q, k, v, gq, lse, delta, rope, **kw))


# ------------------------------------------------------------------ wrappers


def _shapes(q, k, v, rope, q_per_kv):
    """(B·H, B·Hkv, Nq, Nk, D) after checking the layouts."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q [B·H, Nq, D] and k, v [B·Hkv, Nk, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, Nq, D = q.shape
    BHkv, Nk = k.shape[0], k.shape[1]
    if k.shape[2] != D or q_per_kv < 1 or BH != BHkv * q_per_kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match with q_per_kv {q_per_kv}")
    if rope is not None:
        cos, sin = rope
        if Nq != Nk or cos.shape != (Nq, D // 2) or sin.shape != cos.shape:
            raise ValueError(f"rope tables {tuple(cos.shape)} need Nq == Nk "
                             f"and shape ({Nq}, {D // 2})")
    return BH, BHkv, Nq, Nk, D


def _validate(what, D, tensors):
    """Kernel-side checks: D a multiple of 8 up to MAX_D; every tensor of
    ``tensors`` ({name: tensor}) on one card, contiguous, and of q's dtype
    (f32 or bf16) unless named in the f32 set; in bf16, q, k, v and g
    16-byte aligned (the tensor-core kernels copy 16-byte rows)."""
    q = tensors["q"]
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"{what}: head dim {D} is not a multiple of 8 in "
                         f"8..{MAX_D}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what} takes f32 or bf16, not {q.dtype}")
    for name, t in tensors.items():
        if t is None:
            continue
        want = torch.float32 if name in ("lse", "delta", "cos", "sin") \
            else q.dtype
        if t.dtype != want:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {want}")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if q.dtype == torch.bfloat16 and name in _ALIGNED and \
                t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")


def _tables(rope):
    if rope is None:
        return None, None
    return tuple(t.float().contiguous() for t in rope)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _blocks(Nq, Nk, D, dtype, causal, window):
    """The kernels' fixed tiles (64 query and 64 key rows,
    ``csrc/flash_common.cuh``), asked of ``autotune`` where the reference's
    dispatch asks, once for the forward and once for the backward; the
    mask keys the cache, as there."""
    return autotune.choose_blocks("flash", dtype, Nq=Nq, Nk=Nk, D=D,
                                  causal=int(causal), window=window)


def flash_attention_fwd(q, k, v, rope=None, *, causal: bool = True,
                        window: int = 0, q_per_kv: int = 1,
                        return_lse: bool = False):
    """q [B·H, Nq, D], k/v [B·Hkv, Nk, D] -> out [B·H, Nq, D] in q's
    dtype, or (out, lse [B·H, Nq] f32) with ``return_lse``."""
    BH, _, Nq, Nk, D = _shapes(q, k, v, rope, q_per_kv)
    kw = dict(causal=causal, window=window, q_per_kv=q_per_kv)
    if not q.is_cuda:
        return flash_attention_fwd_ref(q, k, v, rope, return_lse=return_lse,
                                       **kw)
    cos, sin = _tables(rope)
    _validate("flash_fwd", D, {"q": q, "k": k, "v": v, "cos": cos,
                               "sin": sin})
    out = torch.empty_like(q)
    lse = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_fwd", "flash_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        _blocks(Nq, Nk, D, q.dtype, causal, window)
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _ptr(cos), _ptr(sin), out.data_ptr(), lse.data_ptr(), BH,
                q_per_kv, Nq, Nk, D, int(causal), int(window), _stream())
    _build.check("flash_fwd", rc, "flash_fwd launch")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def flash_bwd_dq(q, k, v, g, lse, delta, rope=None, *, causal: bool = True,
                 window: int = 0, q_per_kv: int = 1):
    """dq [B·H, Nq, D] in q's dtype; g in q's dtype, lse and delta f32."""
    BH, _, Nq, Nk, D = _shapes(q, k, v, rope, q_per_kv)
    kw = dict(causal=causal, window=window, q_per_kv=q_per_kv)
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, g, lse, delta, rope, **kw)
    cos, sin = _tables(rope)
    _validate("flash_bwd_dq", D, {"q": q, "k": k, "v": v, "g": g,
                                  "lse": lse, "delta": delta, "cos": cos,
                                  "sin": sin})
    dq = torch.empty_like(q)
    fn = _build.function("flash_bwd", "flash_bwd_dq", _DQ_ARGS)
    with torch.cuda.device(q.device):
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(cos),
                _ptr(sin), dq.data_ptr(), BH, q_per_kv, Nq, Nk, D,
                int(causal), int(window), _stream())
    _build.check("flash_bwd", rc, "flash_bwd_dq launch")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, rope=None, *, causal: bool = True,
                  window: int = 0, q_per_kv: int = 1):
    """(dk, dv) [B·Hkv, Nk, D], each summed over the group's q heads; g in
    q's dtype, lse and delta f32."""
    _, BHkv, Nq, Nk, D = _shapes(q, k, v, rope, q_per_kv)
    kw = dict(causal=causal, window=window, q_per_kv=q_per_kv)
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, g, lse, delta, rope, **kw)
    cos, sin = _tables(rope)
    _validate("flash_bwd_dkv", D, {"q": q, "k": k, "v": v, "g": g,
                                   "lse": lse, "delta": delta, "cos": cos,
                                   "sin": sin})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("flash_bwd", "flash_bwd_dkv", _DKV_ARGS)
    with torch.cuda.device(q.device):
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                g.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(cos),
                _ptr(sin), dk.data_ptr(), dv.data_ptr(), BHkv, q_per_kv, Nq,
                Nk, D, int(causal), int(window), _stream())
    _build.check("flash_bwd", rc, "flash_bwd_dkv launch")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, rope=None, *,
                        causal: bool = True, window: int = 0,
                        q_per_kv: int = 1):
    """(dq, dk, dv) from the saved (out, lse): delta = Σ_d g·out in f32 and
    g cast to q's dtype here, then :func:`flash_bwd_dq` and
    :func:`flash_bwd_dkv`."""
    delta, gq = bwd_delta(g, out), g.to(q.dtype).contiguous()
    kw = dict(causal=causal, window=window, q_per_kv=q_per_kv)
    if q.is_cuda:
        with torch.cuda.device(q.device):
            _blocks(q.shape[1], k.shape[1], q.shape[2], q.dtype, causal,
                    window)
    dq = flash_bwd_dq(q, k, v, gq, lse, delta, rope, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, gq, lse, delta, rope, **kw))


flash_attention_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
