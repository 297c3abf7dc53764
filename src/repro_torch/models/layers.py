"""Shared model components (``repro.models.layers``): LoRA-adapted
linears (single and tenant-stacked), RMSNorm, RoPE, GQA attention, causal
or not, with an optional sliding window, with or without RoPE, as self- or
cross-attention (full-sequence for training, or over a per-slot KV cache
for decode: a ring buffer of ``window`` slots for a local layer whose
window is shorter than the cache), the SwiGLU MLP and Whisper's plain GeLU
MLP, and the embedding with a tied or untied head.

Every trainable-path op takes an :class:`ExecutionPolicy` whose backend
selects the backward regime: ``structured`` (the hand-derived autograd
Functions of ``core/structured.py``), ``cuda`` (the same rules through the
CUDA kernels, ``kernels/ops.py``), ``plain`` (autograd of plain forwards,
MeBP) or ``store_h`` (Table 5 ablation).

Parameters are plain nested dicts of tensors with the reference's keys;
LoRA linears carry ``{"w", "a", "b"[, "bias"]}``, where ``w`` may be a
quantized leaf (``core/quant.py``). Layouts are the
reference's: q/k/v are ``[B, H, N, D]`` and a cache is ``[B, Hkv, S, D]``.
Unlike the reference, a decode step writes the cache in place (the
reference returns a new cache); the step returns the same dict.

Under a model axis (``policy.tp``, the dense family) every function takes
this rank's shards (``launch/sharding.py``): the attention runs its q
heads and the KV heads they map to, the MLP its columns of d_ff, the
embedding and the head its rows of the vocabulary, each with the Megatron
collectives of ``models/parallel.py`` around the linears; the norms run
on whatever rows they are given (this rank's part of the sequence under
``policy.sp``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import flash, quant, structured
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rope as krope
from repro_torch.models import parallel


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def wide(t):
    """t in f32, or as it is in f64: the precision of the paths that
    compute in f32, which a whole run in f64 keeps in f64."""
    return t if t.dtype == torch.float64 else t.float()


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------


def linear_params(gen, d_in: int, d_out: int, cfg: ArchConfig, *,
                  lora: bool, bias: bool = False, lead: Tuple[int, ...] = (),
                  quantize: Optional[str] = None):
    """A linear at the reference's scales (W0 ~ N(0, 1/d_in), A ~ N(0, 1/r),
    B = 0, bias 0). ``lead``: leading stack dims, e.g. ``(n_layers,)``.
    ``quantize`` ("int8", "int4" or "nf4") turns W0 into that format as
    soon as it is drawn, so no dense copy of it outlives this call."""
    dtype = _dtype(cfg)
    p = {"w": _frozen_w(gen, d_in, d_out, dtype, lead, quantize)}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    if lora:
        r = cfg.lora.rank
        p["a"] = _randn(gen, (*lead, d_in, r), dtype) * (r ** -0.5)
        p["b"] = torch.zeros((*lead, r, d_out), dtype=dtype, device=gen.device)
    return p


def _frozen_w(gen, d_in: int, d_out: int, dtype, lead, quantize):
    """W0 ~ N(0, 1/d_in) [*lead, d_in, d_out], in ``quantize``'s format if
    one is given. A quantized stack with two or more leading dims (MoE's
    expert stacks [L, E], a window pattern's [n_groups, period]) is drawn
    one [d_in, d_out] matrix at a time, each quantized as it is drawn into
    outputs made once, so no dense stack beyond one matrix is held. The CPU generator gives those draws
    the values of one draw of the whole stack (its normal fill works in
    chunks of 16 values, and a matrix holds a multiple of 16), so there a
    quantized init is the dense init quantized, bit for bit; a CUDA
    generator's values depend on the size of each draw, so on the card
    such quantized stacks hold other draws of the same distribution."""
    def draw(shape):
        return _randn(gen, (*shape, d_in, d_out), dtype).mul_(d_in ** -0.5)

    if quantize is None:
        return draw(lead)
    if len(lead) < 2:
        return quant.quantize_leaf(draw(lead), quantize)
    n, out = math.prod(lead), None
    for i in range(n):
        part = quant.quantize_leaf(draw(()), quantize)
        if out is None:
            out = {k: v.new_empty((n, *v.shape)) for k, v in part.items()}
        for k, v in part.items():
            out[k][i] = v
    return {k: v.view(*lead, *v.shape[1:]) for k, v in out.items()}


def apply_linear(p, x, cfg: ArchConfig, *,
                 policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    """LoRA linear. ``policy.backend``: "structured" (MeSP: h recomputed),
    "cuda" (MeSP through the LoRA kernels), "store_h" (h saved), "plain"
    (MeBP: autograd).

    ``p["w"]`` is a dense frozen matrix, an int8 ``{"q", "scale"}`` leaf or
    a packed 4-bit ``{"q4", "scale", ...}`` leaf. The ``cuda`` backend hands
    a quantized leaf to the quantized kernels, which never write a dense W0;
    the other backends dequantize it first (``quant.maybe_dequant``): the
    same values, with W0 materialised, as in the reference.

    When ``p["a"]``/``p["b"]`` are tenant-stacked resident sets
    ([R, d_in, r] / [R, r, d_out], from the AdapterStore), the int32 device
    tensor ``adapter_tiles`` routes each slot tile to its adapter through
    ``kernels/ops.lora_grouped_decode``. Decode only: x is [B, 1, d]."""
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
        backend, s = policy.backend, cfg.lora.scale
        if backend == "cuda":
            return kops.lora_linear(x, p["w"], p["a"], p["b"], bias, s)
        w = quant.maybe_dequant(p["w"], x.dtype)
        if backend == "plain":
            y = x @ w + s * ((x @ p["a"]) @ p["b"])
            return y + bias if bias is not None else y
        fn = structured.lora_linear_store_h if backend == "store_h" \
            else structured.lora_linear
        return fn(x, w, p["a"], p["b"], bias, s)
    y = x @ quant.maybe_dequant(p["w"], x.dtype)
    return y + bias if bias is not None else y


def norm(p, x, cfg: ArchConfig, *, policy: ExecutionPolicy = STRUCTURED):
    """RMSNorm: the CUDA kernels (``cuda``), plain autograd (``plain``) or
    the structured Function (saves x; rms recomputed)."""
    if policy.backend == "plain":
        xf = wide(x)
        rms = torch.sqrt(torch.mean(xf * xf, -1, keepdim=True)
                         + cfg.norm_eps)
        return ((xf / rms) * wide(p)).to(x.dtype)
    if policy.backend == "cuda":
        return kops.rmsnorm(x, p, cfg.norm_eps)
    return structured.rmsnorm(x, p, cfg.norm_eps)


def act_silu(x, policy: ExecutionPolicy):
    return x * torch.sigmoid(x) if policy.backend == "plain" \
        else structured.silu(x)


def act_gelu(x, policy: ExecutionPolicy):
    """GeLU, tanh approximation: autograd of the plain form (``plain``) or
    the structured Function (saves x)."""
    return structured.gelu_tanh(x) if policy.backend == "plain" \
        else structured.gelu(x)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: [B, N, H, D] (D even), positions: [N] or [B, N]."""
    cos, sin = krope.rope_tables(positions, theta, x.shape[-1])
    return krope.apply_rope_tables(x, cos[..., None, :], sin[..., None, :])


# ---------------------------------------------------------------------------
# attention (GQA + KV cache)
# ---------------------------------------------------------------------------


def attention_params(gen, cfg: ArchConfig, *, lead: Tuple[int, ...] = (),
                     quantize: Optional[str] = None):
    hd = cfg.resolved_head_dim
    tg = cfg.lora.targets
    lin = functools.partial(linear_params, gen, cfg=cfg, lead=lead,
                            quantize=quantize)
    return {
        "q": lin(cfg.d_model, cfg.n_heads * hd, lora="q" in tg,
                 bias=cfg.qkv_bias),
        "k": lin(cfg.d_model, cfg.n_kv_heads * hd, lora="k" in tg,
                 bias=cfg.qkv_bias),
        "v": lin(cfg.d_model, cfg.n_kv_heads * hd, lora="v" in tg,
                 bias=cfg.qkv_bias),
        "o": lin(cfg.n_heads * hd, cfg.d_model, lora="o" in tg),
    }


def attention(p, x, cfg: ArchConfig, *, window: int = 0, causal: bool = True,
              cache=None, kv_x=None, use_rope: bool = True,
              policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    """GQA attention, causal unless ``causal`` is False, over keys less
    than ``window`` positions back when ``window`` > 0. k and v come from
    ``kv_x`` [B, Nk, d] when it is given (cross-attention), else from x;
    ``use_rope`` False applies no rotation (Whisper's sinusoid positions
    are added to the activations instead). Without ``cache`` (training, or
    a decode step's cross-attention) over the whole sequence x [B, N, d]
    at positions 0..N-1 (kv_x's keys at 0..Nk-1). With one (decode):
    ``cache`` is {"k": [B,Hkv,S,D], "v": ..., "len": int32 [B]}; new k/v
    are written at each slot's ``len`` in place (at ``len % window`` when
    the cache is a ring of S == window slots), and ``len`` advances by N
    in place.

    Attention without a cache: ``plain`` autograd of the plain forward,
    ``cuda`` the kernel dispatch (``kops.sdpa``: the flash kernels from 64
    query rows, the structured Function below), else (``structured``,
    ``store_h``) the chunked flash Function of ``core/flash.py`` from
    ``policy.flash_min_seq`` query rows in chunks of ``policy.flash_chunk``,
    the structured sdpa Function below that, as in the reference. Under
    ``cuda`` with ``policy.fuse_rope`` (self-attention with RoPE only, as
    in the reference) q and k reach ``kops.sdpa`` unrotated, with the RoPE
    tables, and the flash kernels rotate them on load.

    Under a model axis (``policy.tp``, self-attention without a cache) x
    is replicated, or this rank's part of the sequence under ``policy.sp``
    (gathered first); the rank runs its ``n_heads / mp`` q heads over its
    ``n_kv_heads / mp`` KV heads, and its part of o's output is summed over
    the axis (reduce-scattered under SP)."""
    tp = policy.tp
    if tp is not None and (cache is not None or kv_x is not None):
        raise ValueError("a model axis runs self-attention without a cache "
                         "only (decode under a mesh: ROADMAP.md §1, item 3)")
    x = parallel.enter(x, policy)
    B, N, _ = x.shape
    hd = cfg.resolved_head_dim
    mp = 1 if tp is None else tp.size
    n_heads, n_kv = cfg.n_heads // mp, cfg.n_kv_heads // mp
    src = x if kv_x is None else kv_x
    Nk = src.shape[1]
    lin = functools.partial(apply_linear, cfg=cfg, policy=policy,
                            adapter_tiles=adapter_tiles)
    q = lin(p["q"], x).reshape(B, N, n_heads, hd)
    k = lin(p["k"], src).reshape(B, Nk, n_kv, hd)
    v = lin(p["v"], src).reshape(B, Nk, n_kv, hd)

    if cache is None:
        qpos = torch.arange(N, device=x.device)
        fuse = policy.backend == "cuda" and policy.fuse_rope and use_rope \
            and kv_x is None
        if use_rope and not fuse:
            q = rope(q, qpos, cfg.rope_theta)
            k = rope(k, torch.arange(Nk, device=x.device), cfg.rope_theta)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [B,H,N,D]
        if policy.backend == "plain":
            out = structured._sdpa_ref(q, k, v, window, causal, 0, None)
        elif policy.backend == "cuda":
            tabs = krope.rope_tables(qpos, cfg.rope_theta, hd) if fuse \
                else None
            out = kops.sdpa(q, k, v, causal=causal, window=window, rope=tabs)
        elif N >= policy.flash_min_seq:
            out = flash.flash_attention(q, k, v, window, causal,
                                        policy.flash_chunk, policy.flash_chunk)
        else:
            out = structured.sdpa(q, k, v, window, causal)
        out = out.transpose(1, 2).reshape(B, N, n_heads * hd)
        return _row_linear(p["o"], out, cfg, policy), None

    ln = cache["len"]
    if use_rope:
        qpos = torch.arange(N, device=x.device) + ln[:, None]
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B,H,N,D]
    ring = window if 0 < window == cache["k"].shape[2] else 0
    kc = _cache_write(cache["k"], k, ln, ring)
    vc = _cache_write(cache["v"], v, ln, ring)
    if ring:
        out = _ring_attend(q, kc, vc, ln, ring)
    else:
        out = structured.sdpa(q, kc, vc, window, causal, ln, ln + N)
    cache["len"] += N

    out = out.transpose(1, 2).reshape(B, N, cfg.n_heads * hd)
    return lin(p["o"], out), cache


def _cache_write(c, u, ln, ring: int = 0):
    """Write ``u`` [B,Hkv,N,D] into cache ``c`` [B,Hkv,S,D] in place, each
    slot b at its own offset ``ln[b]`` (continuous batching); into a ring
    of ``ring`` slots at ``(ln[b] + n) % ring``. A linear cache's offset is
    clamped to S - N, as the reference's ``dynamic_update_slice`` clamps
    it: a batcher's idle rows decode on past the end, and nothing reads
    what they write."""
    rows = torch.arange(c.shape[0], device=c.device)
    start = ln if ring else ln.clamp(max=c.shape[2] - u.shape[2])
    for n in range(u.shape[2]):
        at = start + n
        c[rows, :, at % ring if ring else at] = u[:, :, n]
    return c


def _ring_attend(q, kc, vc, qpos, window: int):
    """Decode attention over a ring-buffer cache (keys roped at write time),
    as the reference's: q [B,H,1,D]; kc/vc [B,Hkv,W,D]; slot s holds
    absolute position p(s) = qpos − ((qpos − s) mod W), valid when
    0 ≤ p(s) ≤ qpos and p(s) > qpos − W; ``qpos`` [B], per slot."""
    B, H, _, D = q.shape
    Hkv, W = kc.shape[1], kc.shape[2]
    G = H // Hkv
    qp = qpos.long()[:, None]
    pos = qp - torch.remainder(qp - torch.arange(W, device=q.device), W)
    valid = (pos >= 0) & (pos > qp - W) & (pos <= qp)          # [B, W]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.reshape(B, Hkv, G, 1, D).float(),
                     kc.float()) / math.sqrt(D)
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, -1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(vc.dtype).float(),
                       vc.float())
    return out.reshape(B, H, 1, D).to(q.dtype)


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, *,
                  window: int = 0, lead: Tuple[int, ...] = (),
                  device="cpu") -> dict:
    """Zeroed per-slot KV cache: a [B] length vector holds every slot at
    its own position (the reference's ``per_slot=True``). A sliding-window
    layer whose window is shorter than ``max_len`` gets a ring buffer of
    ``window`` slots."""
    hd = cfg.resolved_head_dim
    slots = window if 0 < window < max_len else max_len
    shape = (*lead, batch, cfg.n_kv_heads, slots, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((*lead, batch), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs with LoRA: gated (SwiGLU) on gate/up/down, or plain GeLU on up/down
# ---------------------------------------------------------------------------


def mlp_params(gen, cfg: ArchConfig, *, d_ff: Optional[int] = None,
               act: str = "silu", lead: Tuple[int, ...] = (),
               quantize: Optional[str] = None):
    """The MLP's linears, ``d_ff`` wide (``cfg.d_ff`` unless given: MoE's
    shared experts and DeepSeek's dense layer 0 differ): the gated MLP's
    gate, up and down, or with ``act`` "gelu" (Whisper) the plain MLP's up
    and down only."""
    tg = cfg.lora.targets
    f = d_ff or cfg.d_ff
    lin = functools.partial(linear_params, gen, cfg=cfg, lead=lead,
                            quantize=quantize)
    p = {} if act == "gelu" else {"gate": lin(cfg.d_model, f,
                                               lora="gate" in tg)}
    p["up"] = lin(cfg.d_model, f, lora="up" in tg)
    p["down"] = lin(f, cfg.d_model, lora="down" in tg)
    return p


def mlp(p, x, cfg: ArchConfig, *, policy: ExecutionPolicy = STRUCTURED,
        adapter_tiles=None):
    """down(silu(gate(x)) * up(x)), or down(gelu(up(x))) for an MLP
    without a gate."""
    lin = functools.partial(apply_linear, cfg=cfg, policy=policy,
                            adapter_tiles=adapter_tiles)
    if policy.tp is not None:
        x = parallel.enter(x, policy)
        down = functools.partial(_row_linear, p["down"], cfg=cfg,
                                 policy=policy)
    else:
        down = functools.partial(lin, p["down"])
    if "gate" not in p:
        return down(act_gelu(lin(p["up"], x), policy))
    g = lin(p["gate"], x)
    u = lin(p["up"], x)
    return down(act_silu(g, policy) * u)


def _row_linear(p, x, cfg: ArchConfig, policy: ExecutionPolicy):
    """A row-parallel linear (o, down): under a model axis this rank's
    partial output, summed over it (``parallel.leave``), then the bias,
    once."""
    if policy.tp is None:
        return apply_linear(p, x, cfg, policy=policy)
    y = parallel.leave(apply_linear({k: v for k, v in p.items()
                                     if k != "bias"}, x, cfg, policy=policy),
                       policy)
    return y + p["bias"] if "bias" in p else y


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_params(gen, cfg: ArchConfig):
    """The token table (N(0, 0.02²)) and, for an untied config, the head
    [d, vocab] at the reference's d^-0.5."""
    dtype = _dtype(cfg)
    p = {"tok": _randn(gen, (cfg.vocab, cfg.d_model), dtype) * 0.02}
    if not cfg.tie_embeddings:
        p["head"] = _randn(gen, (cfg.d_model, cfg.vocab), dtype).mul_(
            cfg.d_model ** -0.5)
    return p


def embed(p, tokens, cfg: ArchConfig, *,
          policy: ExecutionPolicy = STRUCTURED):
    """Token rows, times ``cfg.embed_scale`` where there is one (rounded to
    the table's type first, as the reference does). Under a model axis
    ``tok`` is this rank's vocab shard (``parallel.vocab_embed``)."""
    x = p["tok"][tokens] if policy.tp is None \
        else parallel.vocab_embed(p["tok"], tokens, policy)
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    return x


def unembed(p, x, cfg: ArchConfig, *,
            policy: ExecutionPolicy = STRUCTURED):
    """logits = x @ tokᵀ (tied) or x @ head (untied), in f32 (f64 in an
    f64 run). Under a model axis the logits of this rank's vocab shard,
    [B, N, vocab / mp], from x gathered along the sequence (SP) or copied
    (``parallel.enter``)."""
    x = parallel.enter(x, policy)
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return wide(x @ w)
