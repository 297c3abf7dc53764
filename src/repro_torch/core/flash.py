"""Chunked FlashAttention in plain PyTorch with a hand-derived backward
(``repro.core.flash``): the structured backend's attention from
``policy.flash_min_seq`` rows on.

* forward: online softmax over k chunks; the residuals are (q, k, v, out,
  logsumexp): the [Nq, Nk] probability matrix is never stored;
* backward: each (q chunk, k chunk) tile's probabilities are recomputed
  from the saved logsumexp, used and dropped (paper Appendix A.2 eqs
  17–21, tile by tile).

The q-chunk loop is a Python loop, so the causal and sliding-window chunk
ranges are static: a causal q chunk visits only k chunks up to its own, a
windowed one O(window / chunk) of them. Products take their operands in
their own dtype and sum in f32; the probabilities and dS are rounded to
the inputs' dtype before their products, as in the reference.

This is the counterpart of a ``jnp`` module, not of a Pallas kernel: the
``cuda`` backend's flash kernels are ``kernels/flash_attention.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # not -inf: a fully masked tile must not give NaNs


def _chunk_range(qc: int, n_kc: int, q_chunk: int, k_chunk: int,
                 window: int, causal: bool):
    """Static [lo, hi) k-chunk range visible to q chunk ``qc``."""
    q_lo, q_hi = qc * q_chunk, (qc + 1) * q_chunk - 1
    hi = n_kc
    if causal:
        hi = min(hi, q_hi // k_chunk + 1)
    lo = 0
    if window > 0:
        lo = max(0, (q_lo - window + 1) // k_chunk)
    return lo, hi


def _tile_ok(qs: int, qlen: int, ks: int, klen: int, nk: int, window: int,
             causal: bool, device):
    """[qlen, klen] bool: key visible to query (and inside the sequence)."""
    q_pos = torch.arange(qs, qs + qlen, device=device)
    k_pos = torch.arange(ks, ks + klen, device=device)
    d = q_pos[:, None] - k_pos[None, :]
    ok = (k_pos < nk)[None, :].expand(qlen, klen)
    if causal:
        ok = ok & (d >= 0)
    if window > 0:
        ok = ok & (d < window)
    return ok


def _mm(eq, a, b):
    """einsum of two operands in their own dtype, summed in f32."""
    return torch.einsum(eq, a.float(), b.float())


def _forward(qg, k, v, window, causal, q_chunk, k_chunk):
    """(out [B,Hkv,G,Nq,D] in q's dtype, lse [B,Hkv,G,Nq] f32)."""
    B, Hkv, G, Nq, D = qg.shape
    Nk = k.shape[2]
    scale = D ** -0.5
    n_qc, n_kc = -(-Nq // q_chunk), -(-Nk // k_chunk)
    outs, lses = [], []
    for qc in range(n_qc):
        qs = qc * q_chunk
        qlen = min(q_chunk, Nq - qs)
        qi = qg[:, :, :, qs:qs + qlen]
        m = qg.new_full((B, Hkv, G, qlen), NEG_INF, dtype=torch.float32)
        l = qg.new_zeros((B, Hkv, G, qlen), dtype=torch.float32)
        acc = qg.new_zeros((B, Hkv, G, qlen, D), dtype=torch.float32)
        lo, hi = _chunk_range(qc, n_kc, q_chunk, k_chunk, window, causal)
        for kc in range(lo, hi):
            ks = kc * k_chunk
            ki, vi = k[:, :, ks:ks + k_chunk], v[:, :, ks:ks + k_chunk]
            s = _mm("bhgqd,bhkd->bhgqk", qi, ki) * scale
            ok = _tile_ok(qs, qlen, ks, ki.shape[2], Nk, window, causal,
                          qg.device)
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _mm("bhgqk,bhkd->bhgqd",
                                              p.to(vi.dtype), vi)
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    return torch.cat(outs, 3).to(qg.dtype), torch.cat(lses, 3)


def _backward(qg, k, v, og, lse, gg, window, causal, q_chunk, k_chunk):
    """(dq [B,Hkv,G,Nq,D], dk, dv [B,Hkv,Nk,D]), f32."""
    B, Hkv, G, Nq, D = qg.shape
    Nk = k.shape[2]
    scale = D ** -0.5
    n_qc, n_kc = -(-Nq // q_chunk), -(-Nk // k_chunk)
    # delta_i = sum_d g_i * out_i: the tile-local form of A.2 eq 19's
    # sum(dprobs * probs)
    delta = (gg.float() * og.float()).sum(-1)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for qc in range(n_qc):
        qs = qc * q_chunk
        qlen = min(q_chunk, Nq - qs)
        sl = slice(qs, qs + qlen)
        qi, gi = qg[:, :, :, sl], gg[:, :, :, sl]
        lse_i, delta_i = lse[..., sl, None], delta[..., sl, None]
        lo, hi = _chunk_range(qc, n_kc, q_chunk, k_chunk, window, causal)
        for kc in range(lo, hi):
            ks = kc * k_chunk
            ksl = slice(ks, ks + k_chunk)
            ki, vi = k[:, :, ksl], v[:, :, ksl]
            s = _mm("bhgqd,bhkd->bhgqk", qi, ki) * scale
            ok = _tile_ok(qs, qlen, ks, ki.shape[2], Nk, window, causal,
                          qg.device)
            p = torch.exp(torch.where(ok, s, NEG_INF) - lse_i)  # recomputed
            dv[:, :, ksl] += _mm("bhgqk,bhgqd->bhkd", p.to(qg.dtype),
                                 gi)                             # eq 17
            dp = _mm("bhgqd,bhkd->bhgqk", gi, vi)                 # eq 18
            ds = (p * (dp - delta_i) * scale).to(qg.dtype)        # eq 19
            dq[:, :, :, sl] += _mm("bhgqk,bhkd->bhgqd", ds, ki)   # eq 20
            dk[:, :, ksl] += _mm("bhgqk,bhgqd->bhkd", ds, qi)     # eq 21
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, causal, q_chunk, k_chunk):
        B, H, Nq, D = q.shape
        Hkv = k.shape[1]
        qg = q.reshape(B, Hkv, H // Hkv, Nq, D)
        q_chunk, k_chunk = min(q_chunk, Nq), min(k_chunk, k.shape[2])
        out, lse = _forward(qg, k, v, window, causal, q_chunk, k_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (window, causal, q_chunk, k_chunk)
        return out.reshape(B, H, Nq, D)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        B, H, Nq, D = q.shape
        Hkv = k.shape[1]
        qg = q.reshape(B, Hkv, H // Hkv, Nq, D)
        gg = g.reshape(qg.shape).to(q.dtype)
        dq, dk, dv = _backward(qg, k, v, out, lse, gg, *ctx.cfg)
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def flash_attention(q, k, v, window: int = 0, causal: bool = True,
                    q_chunk: int = 1024, k_chunk: int = 1024):
    """FlashAttention. q: [B, H, Nq, D], k/v: [B, Hkv, Nk, D] (GQA) ->
    [B, H, Nq, D]."""
    return _FlashAttention.apply(q, k, v, window, causal, q_chunk, k_chunk)
