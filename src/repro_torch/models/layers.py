"""Shared model components (``repro.models.layers``) for the dense serving
path: LoRA-adapted linears (single and tenant-stacked), RMSNorm, RoPE,
GQA attention over a per-slot KV cache, the SwiGLU MLP and the tied
embedding.

Parameters are plain nested dicts of tensors with the reference's keys;
LoRA linears carry ``{"w", "a", "b"[, "bias"]}``. Layouts are the
reference's: q/k/v are ``[B, H, N, D]`` and a cache is ``[B, Hkv, S, D]``.
Unlike the reference, a decode step writes the cache in place (the
reference returns a new cache); the step returns the same dict.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import structured
from repro_torch.kernels import ops as kops


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------


def linear_params(gen, d_in: int, d_out: int, cfg: ArchConfig, *,
                  lora: bool, bias: bool = False, lead: Tuple[int, ...] = ()):
    """A linear at the reference's scales (W0 ~ N(0, 1/d_in), A ~ N(0, 1/r),
    B = 0, bias 0). ``lead``: leading stack dims, e.g. ``(n_layers,)``."""
    dtype = _dtype(cfg)
    p = {"w": _randn(gen, (*lead, d_in, d_out), dtype) * (d_in ** -0.5)}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    if lora:
        r = cfg.lora.rank
        p["a"] = _randn(gen, (*lead, d_in, r), dtype) * (r ** -0.5)
        p["b"] = torch.zeros((*lead, r, d_out), dtype=dtype, device=gen.device)
    return p


def apply_linear(p, x, cfg: ArchConfig, *,
                 policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    """LoRA linear. When ``p["a"]``/``p["b"]`` are tenant-stacked resident
    sets ([R, d_in, r] / [R, r, d_out], from the AdapterStore), the int32
    device tensor ``adapter_tiles`` routes each slot tile to its adapter
    through ``kernels/ops.lora_grouped_decode``. Decode only: x is
    [B, 1, d]."""
    bias = p.get("bias")
    if "a" in p and p["a"].ndim == 3:
        if adapter_tiles is None:
            raise ValueError("stacked adapters need adapter_tiles routing")
        if x.ndim != 2 and x.shape[-2] != 1:
            raise ValueError("grouped adapter routing is decode-only "
                             f"(got x {tuple(x.shape)})")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        bm = x2.shape[0] // adapter_tiles.shape[0]
        y = kops.lora_grouped_decode(x2, p["w"], p["a"], p["b"],
                                     adapter_tiles, bias, cfg.lora.scale,
                                     bm=bm, policy=policy)
        return y.reshape(*lead, y.shape[-1])
    if "a" in p:
        if policy.backend == "cuda" and x.is_cuda:
            raise NotImplementedError(
                "single-adapter LoRA linears run the lora_fused kernel, "
                "which the port has not written yet")
        return structured.lora_linear(x, p["w"], p["a"], p["b"], bias,
                                      cfg.lora.scale)
    y = x @ p["w"]
    return y + bias if bias is not None else y


def norm(p, x, cfg: ArchConfig, *, policy: ExecutionPolicy = STRUCTURED):
    """RMSNorm: the CUDA kernel (``cuda``) or the structured forward."""
    if policy.backend == "cuda":
        return kops.rmsnorm(x, p, cfg.norm_eps)
    return structured.rmsnorm(x, p, cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: [B, N, H, D] (D even), positions: [N] or [B, N]."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    if ang.ndim == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + KV cache)
# ---------------------------------------------------------------------------


def attention_params(gen, cfg: ArchConfig, *, lead: Tuple[int, ...] = ()):
    hd = cfg.resolved_head_dim
    tg = cfg.lora.targets
    lin = functools.partial(linear_params, gen, cfg=cfg, lead=lead)
    return {
        "q": lin(cfg.d_model, cfg.n_heads * hd, lora="q" in tg,
                 bias=cfg.qkv_bias),
        "k": lin(cfg.d_model, cfg.n_kv_heads * hd, lora="k" in tg,
                 bias=cfg.qkv_bias),
        "v": lin(cfg.d_model, cfg.n_kv_heads * hd, lora="v" in tg,
                 bias=cfg.qkv_bias),
        "o": lin(cfg.n_heads * hd, cfg.d_model, lora="o" in tg),
    }


def attention(p, x, cfg: ArchConfig, *, cache: dict,
              policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    """Causal GQA attention over a per-slot KV cache (decode): ``cache`` is
    {"k": [B,Hkv,S,D], "v": ..., "len": int32 [B]}. New k/v are written at
    each slot's ``len`` in place, and ``len`` advances by N in place."""
    B, N, _ = x.shape
    hd = cfg.resolved_head_dim
    lin = functools.partial(apply_linear, cfg=cfg, policy=policy,
                            adapter_tiles=adapter_tiles)
    q = lin(p["q"], x).reshape(B, N, cfg.n_heads, hd)
    k = lin(p["k"], x).reshape(B, N, cfg.n_kv_heads, hd)
    v = lin(p["v"], x).reshape(B, N, cfg.n_kv_heads, hd)

    ln = cache["len"]
    qpos = torch.arange(N, device=x.device) + ln[:, None]
    q = rope(q, qpos, cfg.rope_theta)
    k = rope(k, qpos, cfg.rope_theta)

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B,H,N,D]
    kc = _cache_write(cache["k"], k, ln)
    vc = _cache_write(cache["v"], v, ln)
    out = structured.sdpa(q, kc, vc, 0, True, ln, ln + N)
    cache["len"] += N

    out = out.transpose(1, 2).reshape(B, N, cfg.n_heads * hd)
    return lin(p["o"], out), cache


def _cache_write(c, u, ln):
    """Write ``u`` [B,Hkv,N,D] into cache ``c`` [B,Hkv,S,D] in place, each
    slot b at its own offset ``ln[b]`` (continuous batching)."""
    rows = torch.arange(c.shape[0], device=c.device)
    for n in range(u.shape[2]):
        c[rows, :, ln + n] = u[:, :, n]
    return c


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *,
                  lead: Tuple[int, ...] = (), device="cpu") -> dict:
    """Zeroed per-slot KV cache: a [B] length vector holds every slot at
    its own position (the reference's ``per_slot=True``)."""
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, cfg.n_kv_heads, max_len, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((*lead, batch), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU) with LoRA on gate/up/down
# ---------------------------------------------------------------------------


def mlp_params(gen, cfg: ArchConfig, *, lead: Tuple[int, ...] = ()):
    tg = cfg.lora.targets
    lin = functools.partial(linear_params, gen, cfg=cfg, lead=lead)
    return {
        "gate": lin(cfg.d_model, cfg.d_ff, lora="gate" in tg),
        "up": lin(cfg.d_model, cfg.d_ff, lora="up" in tg),
        "down": lin(cfg.d_ff, cfg.d_model, lora="down" in tg),
    }


def mlp(p, x, cfg: ArchConfig, *, policy: ExecutionPolicy = STRUCTURED,
        adapter_tiles=None):
    lin = functools.partial(apply_linear, cfg=cfg, policy=policy,
                            adapter_tiles=adapter_tiles)
    g = lin(p["gate"], x)
    u = lin(p["up"], x)
    return lin(p["down"], structured.silu(g) * u)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_params(gen, cfg: ArchConfig):
    return {"tok": _randn(gen, (cfg.vocab, cfg.d_model), _dtype(cfg)) * 0.02}


def embed(p, tokens, cfg: ArchConfig):
    return p["tok"][tokens]


def unembed(p, x, cfg: ArchConfig):
    """Tied head: logits = x @ tokᵀ, in f32."""
    return (x @ p["tok"].T).float()
