"""RWKV6 "Finch" time-mix and channel-mix (``repro.models.rwkv6``),
attention-free [arXiv:2404.05892].

The WKV recurrence  S_t = Diag(w_t)·S_{t-1} + k_tᵀ v_t,  y_t = r_t·S_{t-1}
+ (r_t·(u⊙k_t))·v_t  runs in chunkwise-parallel form, as the reference
runs it: matmuls inside a chunk of :data:`WKV_CHUNK` tokens and an
[H, D, D] state carried from chunk to chunk, in f32 (in f64 when the
model runs in f64, a witness of the f32 runs), in the reference's order
of operations (``exp(-b)`` grows along a chunk, so another chunking
or order gives other values and, with large decays, other infinities).
Each chunk runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): the backward recomputes a chunk's tensors from its
boundary state, so only chunk-boundary states are stored, the paper's
block-sequential memory discipline applied along time.

Every LoRA linear (r, k, v, g, o and the channel mix's k, v, r) goes
through ``layers.apply_linear``, so under the ``cuda`` backend it runs the
LoRA kernels; the decay projection ``w`` has no LoRA and is a plain
product, as in the reference. The per-head group norm is an RMSNorm over
rows of the head dimension (the RMSNorm kernels under ``cuda``).

Parameters are made stacked over ``lead`` (``(n_layers,)`` for the
model's ``blocks``). Decode states are updated by the caller in place
(``models/model.decode_step``); the block itself returns the new state.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers

WKV_CHUNK = 64


def rwkv_block_params(gen, cfg: ArchConfig, *, lead=(), quantize=None):
    """One RWKV6 block at the reference's scales, stacked over ``lead``."""
    d = cfg.d_model
    tg = cfg.lora.targets
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device
    full = lambda *s, v: torch.full((*lead, *s), v, dtype=dtype, device=dev)
    lin = functools.partial(layers.linear_params, gen, cfg=cfg, lead=lead,
                            quantize=quantize)
    return {
        "ln1": full(d, v=1.0),
        "tm": {  # time mix
            "mu": full(5, d, v=0.5),             # r, k, v, g, w shift mixes
            "r": lin(d, d, lora="q" in tg),
            "k": lin(d, d, lora="k" in tg),
            "v": lin(d, d, lora="v" in tg),
            "g": lin(d, d, lora="gate" in tg),
            "w": lin(d, d, lora=False),          # decay projection
            "w0": full(d, v=-6.0),               # decay bias: slow decay
            "u": torch.randn((*lead, d), generator=gen, device=dev,
                             dtype=dtype) * 0.1,  # bonus
            "gn": full(d, v=1.0),                # per-head group norm weight
            "o": lin(d, d, lora="o" in tg),
        },
        "ln2": full(d, v=1.0),
        "cm": {  # channel mix
            "mu": full(2, d, v=0.5),
            "k": lin(d, cfg.d_ff, lora="up" in tg),
            "v": lin(cfg.d_ff, d, lora="down" in tg),
            "r": lin(d, d, lora="gate" in tg),
        },
    }


def _token_shift(x, last):
    """x [B, N, d] -> the previous token's rows; ``last`` [B, d] (decode)
    stands before the first."""
    if last is None:
        return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    return last[:, None, :]


def _chunk(state, ri, ki, vi, wi, u, mask):
    """One chunk of the WKV recurrence in f32 (f64 in an f64 run): [B, H,
    C, D] inputs and the [B, H, D, D] state in -> (state out, y [B, H, C,
    D])."""
    ri, ki, vi, wi = map(layers.wide, (ri, ki, vi, wi))
    b = torch.cumsum(wi, dim=2)                      # b_i = Σ_{j<=i} logw_j
    q_dec = ri * torch.exp(b - wi)                   # r_i ⊙ exp(b_{i-1})
    k_dec = ki * torch.exp(-b)                       # k_j ⊙ exp(-b_j)
    # inside the chunk: A_ij = q_dec_i · k_dec_j for j < i, plus u's bonus
    A = torch.einsum("bhid,bhjd->bhij", q_dec, k_dec) * mask
    diag = torch.einsum("bhid,hd,bhid->bhi", ri, u, ki)
    y = torch.einsum("bhij,bhjd->bhid", A, vi) + diag[..., None] * vi
    # across chunks: y_i += (r_i ⊙ exp(b_{i-1})) · S
    y = y + torch.einsum("bhid,bhdv->bhiv", q_dec, state)
    # S' = Diag(exp(b_C)) S + Σ_j (k_j ⊙ exp(b_C − b_j))ᵀ v_j
    bC = b[:, :, -1:, :]
    state = state * torch.exp(bC.squeeze(2))[..., None] + \
        torch.einsum("bhjd,bhjv->bhdv", ki * torch.exp(bC - b), vi)
    return state, y


def wkv_chunked(r, k, v, logw, u, state):
    """Chunkwise-parallel WKV. r/k/v/logw: [B, N, H, D] (logw the log
    decay, negative), u: [H, D], state: [B, H, D, D] (key dim × value dim).
    Returns (y [B, N, H, D] f32, new state)."""
    B, N, H, D = r.shape
    C = min(WKV_CHUNK, N)
    pad = (-N) % C
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    T = r.shape[1]
    nc = T // C

    def to_chunks(t):                                # [nc, B, H, C, D]
        return t.reshape(B, nc, C, H, D).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    acc = torch.promote_types(r.dtype, torch.float32)
    mask = torch.tril(torch.ones((C, C), dtype=acc, device=r.device),
                      -1)                                 # j < i
    uf = u.to(acc)
    state = state.to(acc)
    ys = []
    for i in range(nc):
        state, y = checkpoint(_chunk, state, rc[i], kc[i], vc[i], wc[i], uf,
                              mask, use_reentrant=False)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, D)[:, :N]
    return y, state


def wkv_step(r, k, v, logw, u, state):
    """One token of the recurrence (decode). r/k/v/logw: [B, H, D]; u:
    [H, D]; state [B, H, D, D] f32. Returns (y [B, H, D] f32, state)."""
    rf, kf, vf = map(layers.wide, (r, k, v))
    y = torch.einsum("bhd,bhdv->bhv", rf, state) + \
        torch.einsum("bhd,hd->bh", rf * kf, layers.wide(u))[..., None] * vf
    state = state * torch.exp(layers.wide(logw))[..., None] + \
        torch.einsum("bhd,bhv->bhdv", kf, vf)
    return y, state


def time_mix(p, x, cfg: ArchConfig, *, state=None,
             policy: ExecutionPolicy = STRUCTURED):
    """x: [B, N, d]. state (decode): {"shift": [B, d], "wkv": [B, H, D, D]}.
    Returns (out, new state or None)."""
    B, N, d = x.shape
    H, D = cfg.n_heads, cfg.resolved_head_dim
    xx = _token_shift(x, None if state is None else state["shift"])
    mu = p["mu"]
    mix = lambda i: x + (xx - x) * mu[i]
    lin = functools.partial(layers.apply_linear, cfg=cfg, policy=policy)
    r = lin(p["r"], mix(0))
    k = lin(p["k"], mix(1))
    v = lin(p["v"], mix(2))
    g = layers.act_silu(lin(p["g"], mix(3)), policy)
    logw = -torch.exp(layers.wide(lin(p["w"], mix(4)) + p["w0"]))

    hd = lambda t: t.reshape(B, N, H, D)
    u = p["u"].reshape(H, D)
    if state is None:
        y, _ = wkv_chunked(hd(r), hd(k), hd(v), hd(logw), u,
                           x.new_zeros((B, H, D, D), dtype=torch.promote_types(
                               x.dtype, torch.float32)))
        new_state = None
    else:
        y1, wkv = wkv_step(hd(r)[:, 0], hd(k)[:, 0], hd(v)[:, 0],
                           hd(logw)[:, 0], u, state["wkv"])
        y = y1[:, None].reshape(B, N, H, D)
        new_state = {"shift": x[:, -1], "wkv": wkv}
    # per-head group norm (rows of D), then the gate
    ones = torch.ones(D, dtype=x.dtype, device=x.device)
    yn = layers.norm(ones, y.to(x.dtype), cfg, policy=policy)
    yn = (yn.reshape(B, N, d) * p["gn"]) * g
    return lin(p["o"], yn), new_state


def channel_mix(p, x, cfg: ArchConfig, *, state=None,
                policy: ExecutionPolicy = STRUCTURED):
    """x: [B, N, d]; state (decode): the previous token [B, d]."""
    xx = _token_shift(x, state)
    mu = p["mu"]
    xk = x + (xx - x) * mu[0]
    xr = x + (xx - x) * mu[1]
    lin = functools.partial(layers.apply_linear, cfg=cfg, policy=policy)
    kk = torch.square(torch.relu(lin(p["k"], xk)))
    vv = lin(p["v"], kk)
    rr = torch.sigmoid(lin(p["r"], xr))
    return rr * vv, None if state is None else x[:, -1]


def rwkv_block(p, x, cfg: ArchConfig, *, state=None,
               policy: ExecutionPolicy = STRUCTURED):
    """Returns (x_out, new state or None). state: {"shift_tm", "wkv",
    "shift_cm"}."""
    tm_state = None if state is None else {"shift": state["shift_tm"],
                                           "wkv": state["wkv"]}
    h, tm_new = time_mix(p["tm"], layers.norm(p["ln1"], x, cfg, policy=policy),
                         cfg, state=tm_state, policy=policy)
    x = x + h
    h, cm_new = channel_mix(
        p["cm"], layers.norm(p["ln2"], x, cfg, policy=policy), cfg,
        state=None if state is None else state["shift_cm"], policy=policy)
    x = x + h
    if state is None:
        return x, None
    return x, {"shift_tm": tm_new["shift"], "wkv": tm_new["wkv"],
               "shift_cm": cm_new}


def make_rwkv_state(cfg: ArchConfig, batch: int, dtype, *, lead=(),
                    device="cpu") -> dict:
    """Zeroed decode state, stacked over ``lead``: the two token shifts in
    ``dtype`` and the WKV state in f32 (f64 in an f64 run)."""
    H, D = cfg.n_heads, cfg.resolved_head_dim
    z = lambda *s, dt=dtype: torch.zeros((*lead, batch, *s), dtype=dt,
                                         device=device)
    return {"shift_tm": z(cfg.d_model),
            "wkv": z(H, D, D, dt=torch.promote_types(dtype,
                                                      torch.float32)),
            "shift_cm": z(cfg.d_model)}
