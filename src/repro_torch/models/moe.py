"""Mixture-of-Experts MLP (``repro.models.moe``): token-choice routing with
per-expert capacity, the experts' LoRA MLP over ``[E, B·C, d]`` stacks,
and the Switch-style load-balance loss.

Routing is per batch row, as in the reference: the router's product in the
model's dtype, a softmax in f32, the top-k experts of each token, and an
exclusive cumsum over the token-major ``[N·k]`` choices that gives each
choice its slot in its expert's buffer of capacity ``C``. A choice past
``C`` is dropped: its value is zeroed before the scatter and its weight
after the gather, so the token's residual passes through (Switch style).

The top-k is a descending *stable* sort, not ``torch.topk``: the
reference's ``jax.lax.top_k`` takes the lower expert index on a tie, and
bf16-rounded router logits tie often. The order matters as well as the
set, because the slots follow the order of the choices.

The reference's sharding (``shard``, ``sp`` sequence groups and its
sharding constraints) is left out: the port has no mesh, so a group is one
batch row.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant, structured
from repro_torch.kernels import ops as kops
from repro_torch.models import layers

CAPACITY_FACTOR = 1.25


def moe_params(gen, cfg: ArchConfig, *, lead=(), quantize=None):
    """The router [d, E] (frozen), the expert stacks gate/up [E, d, f] and
    down [E, f, d] with LoRA factors per expert, and the shared experts
    fused into one gated MLP of width ``n_shared · f``; ``lead``: leading
    stack dims, e.g. ``(n_layers,)``. Scales are the reference's.
    ``quantize`` ("int8", "int4" or "nf4") puts every ``w`` (the expert
    stacks, one expert matrix at a time, and the shared experts) in that
    format as it is drawn (``layers.linear_params``); the router is no
    ``w`` and stays in ``cfg.dtype``, as ``quant.quantize_frozen`` leaves
    it."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    tg = cfg.lora.targets
    router = torch.randn((*lead, d, E), generator=gen, device=gen.device,
                         dtype=getattr(torch, cfg.dtype)).mul_(d ** -0.5)
    stack = lambda d_in, d_out, name: layers.linear_params(
        gen, d_in, d_out, cfg, lora=name in tg, lead=(*lead, E),
        quantize=quantize)
    p = {"router": router, "gate": stack(d, f, "gate"),
         "up": stack(d, f, "up"), "down": stack(f, d, "down")}
    if m.n_shared:
        p["shared"] = layers.mlp_params(gen, cfg, d_ff=m.n_shared * f,
                                        lead=lead, quantize=quantize)
    return p


def _capacity(n_per_group: int, m) -> int:
    c = int(n_per_group * m.top_k / m.n_experts * CAPACITY_FACTOR)
    return max(8, -(-c // 8) * 8)


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, the lower index first on a tie (``jax.lax.top_k``'s
    order). Differentiable in ``probs`` as ``lax.top_k`` is."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x, cfg: ArchConfig):
    """Routing of x [B, N, d]: (weights [B, N, k] in x's dtype, expert ids
    [B, N, k], slots [B, N, k] clipped to C - 1, keep [B, N, k] bool, C)."""
    m = cfg.moe
    B, N, _ = x.shape
    k, E = m.top_k, m.n_experts
    C = _capacity(N, m)
    logits = (x @ p["router"]).float()                      # [B, N, E]
    weights, idx = top_k(torch.softmax(logits, -1), k)
    weights = (weights / weights.sum(-1, keepdim=True)).to(x.dtype)
    # per-row capacity slots: exclusive cumsum over the token-major choices
    # (laid out [B, E, N·k], so the scan runs along contiguous memory)
    flat = torch.nn.functional.one_hot(idx, E).reshape(B, N * k, E)
    flat = flat.transpose(1, 2).contiguous()
    pos = ((torch.cumsum(flat, -1) - flat) * flat).sum(1).reshape(B, N, k)
    keep = pos < C
    return weights, idx, pos.clamp(0, C - 1), keep, C


def _expert_linear(q, z, cfg: ArchConfig, policy: ExecutionPolicy):
    """One expert linear over z [E, C, d_in] with the stacks of ``q``: the
    grouped kernels (``cuda``; over a quantized stack those of its format,
    which read the codes), autograd of the plain product (``plain``), or
    the structured Functions over the [E, ·, ·] stacks; the last two over
    the stack dequantized first, as in the reference."""
    if "a" not in q:
        return z @ quant.maybe_dequant(q["w"], z.dtype)
    s = cfg.lora.scale
    if policy.backend == "cuda":
        return kops.lora_grouped_linear(z, q["w"], q["a"], q["b"], s)
    w = quant.maybe_dequant(q["w"], z.dtype)
    if policy.backend == "plain":
        return z @ w + s * ((z @ q["a"]) @ q["b"])
    fn = structured.lora_linear_store_h if policy.backend == "store_h" \
        else structured.lora_linear
    return fn(z, w, q["a"], q["b"], None, s)


def moe_mlp(p, x, cfg: ArchConfig, *, policy: ExecutionPolicy = STRUCTURED):
    """x [B, N, d] -> [B, N, d]: route, scatter into [B·E·C, d], the
    experts' MLP over [E, B·C, d], gather, weight, sum over k, add the
    shared experts."""
    B, N, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    weights, idx, slot, keep, C = route(p, x, cfg)
    # each choice's row in the [B·E·C, d] buffers. The scatter sends a
    # dropped choice's zeros to one spare row past them, so every row it
    # writes is written once and no sum is needed; the gather reads a
    # dropped choice at slot C - 1 and weights it by zero, so the sums of
    # its backward hold one nonzero term a row, exact in any order.
    # index_put and index_select keep only the rows for their backward
    rows = ((torch.arange(B, device=x.device)[:, None, None] * E + idx) * C
            + slot).reshape(-1)
    spare = torch.where(keep.reshape(-1), rows, B * E * C)
    vals = (x[:, :, None, :] * keep[..., None].to(x.dtype)).reshape(-1, d)
    buf = x.new_zeros((B * E * C + 1, d)).index_put((spare,), vals)
    ebuf = buf[:-1].view(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    lin = lambda q, z: _expert_linear(q, z, cfg, policy)
    hidden = layers.act_silu(lin(p["gate"], ebuf), policy) * lin(p["up"],
                                                                  ebuf)
    y_buf = lin(p["down"], hidden).reshape(E, B, C, d).transpose(0, 1)
    out = y_buf.reshape(-1, d).index_select(0, rows).reshape(B, N, k, d) \
        * (weights * keep.to(x.dtype))[..., None]
    out = out.sum(2)
    if "shared" in p:
        out = out + layers.mlp(p["shared"], x, cfg, policy=policy)
    return out


def aux_load_balance_loss(p, x, cfg: ArchConfig):
    """Switch-style load-balance auxiliary: E · Σ_e (share of the top-k
    choices routed to e) · (mean router probability of e)."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax((x.reshape(T, -1) @ p["router"]).float(), -1)
    _, idx = top_k(probs, m.top_k)
    frac = torch.bincount(idx.reshape(-1), minlength=m.n_experts) / (
        T * m.top_k)
    return m.n_experts * torch.sum(frac * probs.mean(0))
