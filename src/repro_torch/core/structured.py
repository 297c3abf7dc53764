"""Hand-derived structured backward passes (``repro.core.structured``), in
PyTorch.

Every op is a ``torch.autograd.Function`` whose ``save_for_backward`` set
is the tensor-lifecycle contract, as the reference's custom_vjp residuals
are: what is saved survives the forward pass, everything else is freed and
recomputed in the backward. :func:`lora_linear` saves x (needed for dA
anyway) and NOT ``h = x @ A``, which its backward recomputes (paper §4.1);
:func:`sdpa` saves q, k, v and not the probabilities. Each forward and
backward repeats the reference's arithmetic and dtype steps, so f32 results
agree to rounding. Frozen inputs (W0, bias, norm weights) get ``None``
gradients, and ``ctx.needs_input_grad`` skips work no one needs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _flat2(x):
    return x.reshape(-1, x.shape[-1])


# ---------------------------------------------------------------------------
# LoRA linear (Appendix A.1)
#
#   y = x @ W0 + s * (x @ A) @ B           h := x @ A   (NOT stored)
#   dB = hᵀ (s g),  dh = (s g) Bᵀ,  dA = xᵀ dh,  dx = dh Aᵀ + g W0ᵀ
# ---------------------------------------------------------------------------


def _lora_fwd(x, w0, a, b, bias, scale, h=None):
    if h is None:
        h = x @ a
    y = x @ w0 + scale * (h @ b)
    return y + bias if bias is not None else y


def _lora_bwd(ctx, x, w0, a, b, h, g):
    """A shared weight (w0 [K, N]) flattens x's leading dims into one
    contraction for dA/dB; per-expert stacks (x [E, C, K], w0 [E, K, N],
    a [E, K, r], b [E, r, N]) take batched per-expert products, as the
    reference branches on ``w0.ndim``."""
    gx = g.to(x.dtype)
    sg = ctx.scale * gx
    dh = sg @ b.mT                                   # (A.1 eq 11)
    dx = da = db = None
    if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
        if h is None:
            h = x @ a                                # recompute (paper §4.1)
        if w0.ndim == 2:
            db = _flat2(h).T @ _flat2(sg)            # (A.1 eq 10)
            da = _flat2(x).T @ _flat2(dh)            # (A.1 eq 12)
        else:
            db, da = h.mT @ sg, x.mT @ dh
        da, db = da.to(a.dtype), db.to(b.dtype)
    if ctx.needs_input_grad[0]:
        dx = dh @ a.mT + gx @ w0.mT                  # (A.1 eq 13)
    return dx, None, da, db, None, None


class _LoRALinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0, a, b, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(x, w0, a, b)           # h deliberately not
        return _lora_fwd(x, w0, a, b, bias, scale)

    @staticmethod
    def backward(ctx, g):
        x, w0, a, b = ctx.saved_tensors
        return _lora_bwd(ctx, x, w0, a, b, None, g)


class _LoRALinearStoreH(torch.autograd.Function):
    """Ablation (paper §5.7 / Table 5): identical math, but h IS saved."""

    @staticmethod
    def forward(ctx, x, w0, a, b, bias, scale):
        ctx.scale = scale
        h = x @ a
        ctx.save_for_backward(x, w0, a, b, h)
        return _lora_fwd(x, w0, a, b, bias, scale, h)

    @staticmethod
    def backward(ctx, g):
        x, w0, a, b, h = ctx.saved_tensors
        return _lora_bwd(ctx, x, w0, a, b, h, g)


def lora_linear(x, w0, a, b, bias, scale: float):
    """LoRA-adapted linear: ``x @ w0 + scale * (x @ a) @ b [+ bias]``;
    saves x, w0, a, b. w0 [K, N] is shared by every row of x; a stack
    w0 [E, K, N] (with a [E, K, r], b [E, r, N]) takes x [E, C, K]."""
    return _LoRALinear.apply(x, w0, a, b, bias, scale)


def lora_linear_store_h(x, w0, a, b, bias, scale: float):
    """:func:`lora_linear` that also saves ``h = x @ a``."""
    return _LoRALinearStoreH.apply(x, w0, a, b, bias, scale)


# ---------------------------------------------------------------------------
# RMSNorm (Appendix A.3)
#
#   rms = sqrt(mean(x^2) + eps);  xhat = x / rms;  y = xhat * w
#   dx = (g w - xhat * mean(g w ⊙ xhat)) / rms;    dw = sum_rows(g ⊙ xhat)
# ---------------------------------------------------------------------------


def _rms(xf, eps):
    return torch.sqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)      # rms / xhat recomputed in backward
        xf = x.float()
        return ((xf / _rms(xf, eps)) * w.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        rms = _rms(xf, ctx.eps)
        xhat = xf / rms
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxhat = gf * w.float()
            dx = ((dxhat - xhat * torch.mean(dxhat * xhat, -1, keepdim=True))
                  / rms).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (_flat2(gf) * _flat2(xhat)).sum(0).to(w.dtype)
        return dx, dw, None


def rmsnorm(x, w, eps: float = 1e-6):
    """``x / sqrt(mean(x²) + eps) * w`` in f32, cast back to x's dtype;
    saves x, w."""
    return _RMSNorm.apply(x, w, eps)


# ---------------------------------------------------------------------------
# SiLU (Appendix A.4): silu'(x) = σ(x)(1 + x(1 − σ(x))); saves x only
# ---------------------------------------------------------------------------


class _SiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * torch.sigmoid(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * s * (1 + x * (1 - s))


def silu(x):
    return _SiLU.apply(x)


# GeLU, tanh approximation (Griffin's gate): the same recompute-from-x
# discipline; saves x only
_GELU_C = 0.7978845608028654          # sqrt(2 / pi)


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)``, in its order of operations."""
    return x * (0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x ** 3))))


class _GeLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_tanh(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c = torch.tensor(_GELU_C, dtype=x.dtype, device=x.device)
        t = torch.tanh(c * (x + 0.044715 * x ** 3))
        dt = (1 - t * t) * c * (1 + 3 * 0.044715 * x * x)
        return g * (0.5 * (1 + t) + 0.5 * x * dt)


def gelu(x):
    return _GeLU.apply(x)


# ---------------------------------------------------------------------------
# Scaled-dot-product attention (Appendix A.2), GQA + causal/windowed masks.
# Saves q, k, v only: the [*, n, n] probabilities are recomputed.
# ---------------------------------------------------------------------------


def _attn_mask(n_q: int, n_k: int, window: int, causal: bool, q_offset,
               device) -> torch.Tensor:
    """[n_q, n_k] additive mask, or [B, n_q, n_k] when ``q_offset`` is a
    per-row vector [B] (continuous batching: every slot at its own
    position). q position i sits at absolute q_offset + i."""
    off = torch.as_tensor(q_offset, device=device)
    qpos = (off[..., None] if off.ndim else off) + torch.arange(n_q,
                                                                device=device)
    kpos = torch.arange(n_k, device=device)
    d = qpos[..., :, None] - kpos
    ok = torch.ones(d.shape, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (d >= 0)
    if window > 0:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, -math.inf).float()


def _sdpa_mask(Nq: int, Nk: int, window: int, causal: bool, q_offset,
               kv_len, device) -> torch.Tensor:
    """Positional + valid-length mask, broadcastable against
    [B, Hkv, G, Nq, Nk] scores; per-row vectors lift it to
    [B, 1, 1, Nq, Nk]."""
    mask = _attn_mask(Nq, Nk, window, causal, q_offset, device)
    if mask.ndim == 3:
        mask = mask[:, None, None]
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=device)
        km = torch.where(torch.arange(Nk, device=device) < kvl[..., None],
                         0.0, -math.inf).float()
        if km.ndim == 2:
            km = km[:, None, None, None]
        mask = mask + km
    return mask


def _probs(qg, k, window, causal, q_offset, kv_len):
    """Softmax probabilities [B, Hkv, G, Nq, Nk] in f32."""
    D, Nq = qg.shape[-1], qg.shape[-2]
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    scores = scores + _sdpa_mask(Nq, k.shape[2], window, causal, q_offset,
                                 kv_len, qg.device)
    return torch.softmax(scores, -1)


def _sdpa_ref(q, k, v, window: int, causal: bool, q_offset, kv_len):
    """Plain attention forward. q:[B,H,Nq,D] k,v:[B,Hkv,Nk,D] ->
    [B,H,Nq,D]. Products take the operands' values in f32 (the reference's
    f32 accumulation); the probabilities are rounded to v's dtype first,
    as in the reference."""
    B, H, Nq, D = q.shape
    G = H // k.shape[1]
    probs = _probs(q.reshape(B, -1, G, Nq, D), k, window, causal, q_offset,
                   kv_len)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, H, Nq, D).to(q.dtype)


class _SDPA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, causal, q_offset, kv_len):
        ctx.window, ctx.causal = window, causal
        ctx.q_offset, ctx.kv_len = q_offset, kv_len
        ctx.save_for_backward(q, k, v)   # probabilities NOT saved
        return _sdpa_ref(q, k, v, window, causal, q_offset, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        B, H, Nq, D = q.shape
        Hkv = k.shape[1]
        G = H // Hkv
        qg = q.reshape(B, Hkv, G, Nq, D)
        gg = g.reshape(B, Hkv, G, Nq, D).to(q.dtype).float()
        probs = _probs(qg, k, ctx.window, ctx.causal, ctx.q_offset,
                       ctx.kv_len)                             # recomputed
        pl = probs.to(q.dtype).float()
        dv = torch.einsum("bhgqk,bhgqd->bhkd", pl, gg)         # eq 17
        dprobs = torch.einsum("bhgqd,bhkd->bhgqk", gg, v.float())  # eq 18
        dscores = probs * (dprobs - torch.sum(dprobs * probs, -1,
                                              keepdim=True))   # eq 19
        dsl = dscores.to(q.dtype).float()
        dq = torch.einsum("bhgqk,bhkd->bhgqd", dsl,
                          k.float()) / math.sqrt(D)            # eq 20
        dk = torch.einsum("bhgqk,bhgqd->bhkd", dsl,
                          qg.float()) / math.sqrt(D)           # eq 21
        return (dq.reshape(B, H, Nq, D).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def sdpa(q, k, v, window: int = 0, causal: bool = True, q_offset=0,
         kv_len: Optional[torch.Tensor] = None):
    """Attention with the structured backward; saves q, k, v."""
    return _SDPA.apply(q, k, v, window, causal, q_offset, kv_len)


# ---------------------------------------------------------------------------
# Cross-entropy: saves the logits and labels, not the [B, N, V] softmax
# ---------------------------------------------------------------------------


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        lf = logits.float()
        valid = labels >= 0
        safe = torch.where(valid, labels, 0)
        lse = torch.logsumexp(lf, -1)
        ll = torch.gather(lf, -1, safe[..., None].long())[..., 0]
        n = valid.sum().clamp(min=1)
        return ((lse - ll) * valid).sum() / n

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        valid = labels >= 0
        safe = torch.where(valid, labels, 0)
        p = torch.softmax(logits.float(), -1)                  # recomputed
        p.scatter_add_(-1, safe[..., None].long(),
                       torch.full(safe.shape + (1,), -1.0, device=p.device))
        n = valid.sum().clamp(min=1)
        dlogits = (g / n) * p * valid[..., None]
        return dlogits.to(logits.dtype), None


class _VocabParallelXent(torch.autograd.Function):
    """The loss over vocab-parallel logits [B, N, V/mp]: the row max by an
    all-reduce MAX, then the sum of exps and the target's logit (from the
    rank whose shard holds it, zero elsewhere) by one all-reduce; saves
    the logits, labels and the log-sum-exp, and its backward is local."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        lf = logits.float()
        v = lf.shape[-1]
        valid = labels >= 0
        local = labels - tp.index * v
        inside = valid & (local >= 0) & (local < v)
        safe = torch.where(inside, local, 0)[..., None].long()
        m = tp.all_reduce(lf.amax(-1), "max")
        se = torch.exp(lf - m[..., None]).sum(-1)
        tl = torch.where(inside, torch.gather(lf, -1, safe)[..., 0], 0.0)
        se, ll = tp.all_reduce(torch.stack([se, tl]))
        lse = m + torch.log(se)
        ctx.save_for_backward(logits, lse, safe, inside, valid)
        n = valid.sum().clamp(min=1)
        return ((lse - ll) * valid).sum() / n

    @staticmethod
    def backward(ctx, g):
        logits, lse, safe, inside, valid = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])         # recomputed
        p.scatter_add_(-1, safe, -inside[..., None].float())
        n = valid.sum().clamp(min=1)
        dlogits = (g / n) * p * valid[..., None]
        return dlogits.to(logits.dtype), None, None


def softmax_xent(logits, labels, tp=None):
    """Mean token cross-entropy; positions with label == -1 are ignored.
    logits [B, N, V] (any dtype), labels [B, N] int. With ``tp`` (a model
    axis, ``runtime.elastic.ModelParallel``) the logits are this rank's
    vocab shard [B, N, V/mp] and the loss is the whole vocabulary's."""
    if tp is not None and tp.size > 1:
        return _VocabParallelXent.apply(logits, labels, tp)
    return _SoftmaxXent.apply(logits, labels)
