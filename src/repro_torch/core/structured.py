"""Forwards of the structured ops (``repro.core.structured``), in PyTorch.

Serving needs no gradients, so these are plain functions on tensors; the
``torch.autograd.Function``s with MeSP's residual contract (h = x@A never
saved) come with the training slice. Each forward repeats the reference's
arithmetic and dtype steps, so the f32 results agree to rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def lora_linear(x, w0, a, b, bias, scale: float):
    """LoRA-adapted linear: ``x @ w0 + scale * (x @ a) @ b [+ bias]``."""
    y = x @ w0 + scale * ((x @ a) @ b)
    if bias is not None:
        y = y + bias
    return y


def rmsnorm(x, w, eps: float = 1e-6):
    """``x / sqrt(mean(x²) + eps) * w`` in f32, cast back to x's dtype."""
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return ((xf / rms) * w.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


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


def _sdpa_ref(q, k, v, window: int, causal: bool, q_offset, kv_len):
    """Plain attention forward. q:[B,H,Nq,D] k,v:[B,Hkv,Nk,D] ->
    [B,H,Nq,D]. Products take the operands' values in f32 (the reference's
    f32 accumulation); the probabilities are rounded to v's dtype first,
    as in the reference."""
    B, H, Nq, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Nq, D).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    scores = scores + _sdpa_mask(Nq, k.shape[2], window, causal, q_offset,
                                 kv_len, q.device)
    probs = torch.softmax(scores, -1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, H, Nq, D).to(q.dtype)


def sdpa(q, k, v, window: int = 0, causal: bool = True, q_offset=0,
         kv_len: Optional[torch.Tensor] = None):
    return _sdpa_ref(q, k, v, window, causal, q_offset, kv_len)
