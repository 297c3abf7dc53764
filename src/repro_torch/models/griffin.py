"""Griffin / RecurrentGemma recurrent block (``repro.models.griffin``):
the RG-LRU recurrence behind a depthwise causal convolution
[arXiv:2402.19427]. The model interleaves it with local-attention blocks
in the pattern R, R, A (``models/model.py``).

The RG-LRU diagonal recurrence  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙
x_t)  runs over the whole sequence as a log-depth doubling scan in f32
(the reference's ``jax.lax.associative_scan``): ceil(log2 N) passes of
whole-tensor products, 8 at N 256, in place of a loop that would launch a
few kernels a token. The linears ``x_proj``, ``gate_proj`` and
``out_proj`` carry LoRA (the LoRA kernels under ``cuda``); the gate
projections ``rg_w`` and ``in_w`` have none and are plain products, as in
the reference. The block has no MLP.

Parameters are made stacked over ``lead`` (``(n_groups,)`` inside the
model's ``groups``, ``()`` for a ``tail`` block).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers

CONV_WIDTH = 4
LRU_C = 8.0  # RG-LRU decay sharpness constant


def lru_width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def recurrent_block_params(gen, cfg: ArchConfig, *, lead=(), quantize=None):
    """One recurrent block at the reference's scales, stacked over
    ``lead``."""
    d, w = cfg.d_model, lru_width(cfg)
    tg = cfg.lora.targets
    dtype = getattr(torch, cfg.dtype)
    dev = gen.device
    full = lambda *s, v: torch.full((*lead, *s), v, dtype=dtype, device=dev)
    lin = functools.partial(layers.linear_params, gen, cfg=cfg, lead=lead,
                            quantize=quantize)
    return {
        "ln": full(d, v=1.0),
        "x_proj": lin(d, w, lora="q" in tg),
        "gate_proj": lin(d, w, lora="gate" in tg),
        "conv_w": torch.randn((*lead, CONV_WIDTH, w), generator=gen,
                              device=dev, dtype=dtype) * 0.1,
        "conv_b": full(w, v=0.0),
        # RG-LRU gates
        "rg_w": lin(w, w, lora=False),
        "in_w": lin(w, w, lora=False),
        "lam": full(w, v=2.0),  # Λ: softplus -> decay rates
        "out_proj": lin(w, d, lora="o" in tg),
    }


def _causal_conv(x, w, b, state):
    """Depthwise causal conv of width CONV_WIDTH over x [B, N, W].
    ``state``: [B, CONV_WIDTH - 1, W], the trailing inputs (decode).
    Returns (y, new state or None)."""
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, CONV_WIDTH - 1, 0))
        new_state = None
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(CONV_WIDTH - 1):]
    n = x.shape[1]
    y = sum(xp[:, i:i + n] * w[i] for i in range(CONV_WIDTH))
    return y + b, new_state


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, by doubling:
    after the pass of stride s every (a_t, b_t) is the composition of the
    min(2s, t + 1) steps ending at t, combined as the reference's
    ``(a, b) ∘ (a', b') = (a·a', a'·b + b')``."""
    n, s = a.shape[1], 1
    while s < n:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rg_lru(x, gates_r, gates_i, lam, state):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t²) (i_t ⊙ x_t),  log a_t =
    -c·softplus(Λ)·r_t. x / gates: [B, N, W] (training) or [B, 1, W] with
    ``state`` [B, W] f32 (decode). Returns (h in x's dtype, new state or
    None)."""
    xf = x.float()
    r = torch.sigmoid(gates_r.float())
    i = torch.sigmoid(gates_i.float())
    log_a = -LRU_C * torch.nn.functional.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    if state is not None:
        h = a[:, 0] * state + gated[:, 0]
        return h[:, None].to(x.dtype), h
    return linear_scan(a, gated).to(x.dtype), None


def recurrent_block(p, x, cfg: ArchConfig, *, state=None,
                    policy: ExecutionPolicy = STRUCTURED):
    """Griffin recurrent block. state (decode): {"conv": [B, 3, W], "lru":
    [B, W]}. Returns (x_out, new state or None)."""
    lin = functools.partial(layers.apply_linear, cfg=cfg, policy=policy)
    xin = layers.norm(p["ln"], x, cfg, policy=policy)
    main = lin(p["x_proj"], xin)
    gate = layers.act_gelu(lin(p["gate_proj"], xin), policy)
    main, conv_new = _causal_conv(main, p["conv_w"], p["conv_b"],
                                  None if state is None else state["conv"])
    gr = lin(p["rg_w"], main)
    gi = lin(p["in_w"], main)
    h, lru_new = rg_lru(main, gr, gi, p["lam"],
                        None if state is None else state["lru"])
    y = lin(p["out_proj"], h * gate)
    new_state = None if state is None else {"conv": conv_new, "lru": lru_new}
    return x + y, new_state


def make_recurrent_state(cfg: ArchConfig, batch: int, dtype, *, lead=(),
                         device="cpu") -> dict:
    """Zeroed decode state, stacked over ``lead``: the convolution's last
    inputs in ``dtype`` and the LRU state in f32."""
    w = lru_width(cfg)
    return {"conv": torch.zeros((*lead, batch, CONV_WIDTH - 1, w),
                                dtype=dtype, device=device),
            "lru": torch.zeros((*lead, batch, w), dtype=torch.float32,
                               device=device)}
