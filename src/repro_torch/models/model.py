"""Model assembly (``repro.models.model``) for the dense and MoE
families: init, the full-sequence forward and loss for training, and, for
the dense family, the per-slot decode cache and the multi-tenant decode
step.

Block parameters are stacked ``[L, ...]`` as in the reference's tree (the
weight bridge relies on it). An MoE model stacks ``moe_block``s; a config
with ``first_layer_dense`` (DeepSeekMoE) puts a dense block of MLP width
``d_expert · (top_k + n_shared)`` first, unstacked, as ``block0``. A
config with a ``window_pattern`` (Gemma3: 5 local layers, then a global
one) stacks its blocks per pattern period, ``groups`` leaves
``[n_groups, period, ...]``, as the reference does, so each position of
the period keeps its own window. The forward and the decode step walk the
layers in a Python loop where the reference scans; in training each
stacked block (each group of a patterned model) runs under
``torch.utils.checkpoint`` when ``policy.remat`` is set, so only block (or
group) inputs are stored across the forward (the reference's
``jax.checkpoint`` around its scan body, paper §4.3); ``block0`` runs
outside it, as in the reference. The cache is written in place; a
patterned model's cache is keyed per position of the period (``l{i}``:
a ring of ``window`` slots for a local layer whose window is shorter than
the cache, else linear), stacked over groups.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant, structured
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib


def _require(cfg: ArchConfig, families) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"the port runs the {'/'.join(families)} family here so far, "
            f"not {cfg.name!r} ({cfg.family})")


def dense_block(bp, x, cfg: ArchConfig, *, cache, window: int = 0,
                policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    h, new_cache = layers.attention(
        bp["attn"], layers.norm(bp["ln1"], x, cfg, policy=policy), cfg,
        window=window, cache=cache, policy=policy,
        adapter_tiles=adapter_tiles)
    x = x + h
    x = x + layers.mlp(bp["mlp"],
                       layers.norm(bp["ln2"], x, cfg, policy=policy),
                       cfg, policy=policy, adapter_tiles=adapter_tiles)
    return x, new_cache


def moe_block(bp, x, cfg: ArchConfig, *,
              policy: ExecutionPolicy = STRUCTURED):
    """Attention, then the MoE MLP (``models/moe.py``) in place of the
    dense one; training only."""
    h, _ = layers.attention(
        bp["attn"], layers.norm(bp["ln1"], x, cfg, policy=policy), cfg,
        policy=policy)
    x = x + h
    return x + moe_lib.moe_mlp(bp["moe"],
                               layers.norm(bp["ln2"], x, cfg, policy=policy),
                               cfg, policy=policy)


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                quantize=None):
    """Random parameters at the reference's scales, made on the generator's
    device in ``cfg.dtype``. The values differ from ``jax.random``'s; tests
    that compare the two packages bridge the reference's parameters.
    ``quantize`` ("int8", or packed "int4"/"nf4") turns every frozen ``w``
    leaf into its ``core/quant`` format as it is drawn (the same values as
    ``quant.quantize_params`` over the dense tree, without ever holding
    that tree; an MoE model's expert stacks are drawn one matrix at a
    time, which on the card gives other values of the same distribution,
    ``layers.linear_params``); LoRA factors, biases, norms, the router and
    the embedding stay in ``cfg.dtype``."""
    _require(cfg, ("dense", "moe"))
    gen = generator
    dtype = getattr(torch, cfg.dtype)
    L, d = cfg.n_layers, cfg.d_model
    method = None if quantize in (None, "none") else quantize
    if method is not None and method not in quant.METHODS:
        raise ValueError(f"unknown quantize method {quantize!r}; "
                         f"expected one of {quant.METHODS}")
    ones = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    p = {"embed": layers.embed_params(gen, cfg), "final_norm": ones(d)}
    if cfg.family == "moe":
        m = cfg.moe
        if m.first_layer_dense:
            p["block0"] = {
                "ln1": ones(d),
                "attn": layers.attention_params(gen, cfg, quantize=method),
                "ln2": ones(d), "mlp": layers.mlp_params(
                    gen, cfg, d_ff=m.d_expert * (m.top_k + m.n_shared),
                    quantize=method)}
            L -= 1
        p["blocks"] = {"ln1": ones(L, d),
                       "attn": layers.attention_params(gen, cfg, lead=(L,),
                                                       quantize=method),
                       "ln2": ones(L, d),
                       "moe": moe_lib.moe_params(gen, cfg, lead=(L,),
                                                 quantize=method)}
        return p
    lead = (L,)
    if cfg.window_pattern:
        gsz = len(cfg.window_pattern)
        if L % gsz:
            raise ValueError(f"{cfg.name}: {L} layers are not whole periods "
                             f"of the window pattern {cfg.window_pattern}")
        lead = (L // gsz, gsz)
    stack = {"ln1": ones(*lead, d),
             "attn": layers.attention_params(gen, cfg, lead=lead,
                                             quantize=method),
             "ln2": ones(*lead, d),
             "mlp": layers.mlp_params(gen, cfg, lead=lead, quantize=method)}
    p["groups" if cfg.window_pattern else "blocks"] = stack
    return p


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cpu"):
    """Stacked per-layer, per-slot KV caches (the reference's
    ``init_cache(per_slot=True)``): {"blocks": {"k", "v": [L,B,Hkv,S,D],
    "len": [L,B]}}; with a window pattern {"groups": {"l{i}": {"k", "v":
    [n_groups,B,Hkv,S_i,D], "len": [n_groups,B]}}}, S_i the window of
    position i where that is shorter than ``max_len`` (a ring), else
    ``max_len``."""
    _require(cfg, ("dense",))
    kv = functools.partial(layers.make_kv_cache, cfg, batch, max_len,
                           getattr(torch, cfg.dtype), device=device)
    if cfg.window_pattern:
        lead = (cfg.n_layers // len(cfg.window_pattern),)
        return {"groups": {f"l{i}": kv(window=w, lead=lead)
                           for i, w in enumerate(cfg.window_pattern)}}
    return {"blocks": kv(lead=(cfg.n_layers,))}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int, lead: int = 1):
    """Stacked [L, ...] leaves (``lead`` 2: [n_groups, period, ...], taken
    as one [L, ...]) -> n per-layer trees of views. ``unbind`` gives all n
    views one autograd node, so the gradient of a stacked trainable leaf is
    assembled once, not summed from n zero-padded copies."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n, lead) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return tree.flatten(0, lead - 1).unbind(0)


def _layer_list(params, cfg: ArchConfig):
    """[(block params, window)] for every stacked layer, in order."""
    if "groups" in params:
        return list(zip(_unstack(params["groups"], cfg.n_layers, 2),
                        (cfg.layer_window(i) for i in range(cfg.n_layers))))
    blocks = params["blocks"]
    return [(bp, 0) for bp in _unstack(blocks, blocks["ln1"].shape[0])]


def forward(params, cfg: ArchConfig, tokens, *,
            policy: ExecutionPolicy = STRUCTURED):
    """Full-sequence forward -> logits [B, N, vocab] in f32."""
    _require(cfg, ("dense", "moe"))
    x = layers.embed(params["embed"], tokens, cfg)
    if "block0" in params:
        x = dense_block(params["block0"], x, cfg, cache=None,
                        policy=policy)[0]

    def body(x, group):
        for bp, window in group:
            if cfg.family == "moe":
                x = moe_block(bp, x, cfg, policy=policy)
            else:
                x = dense_block(bp, x, cfg, cache=None, window=window,
                                policy=policy)[0]
        return x

    # one checkpointed unit a block, or a pattern period (the reference's
    # scan body: its group inputs are all that is stored)
    per = len(cfg.window_pattern) or 1
    layer_list = _layer_list(params, cfg)
    for g in range(0, len(layer_list), per):
        group = layer_list[g:g + per]
        if policy.remat:
            x = checkpoint(body, x, group, use_reentrant=False)
        else:
            x = body(x, group)
    x = layers.norm(params["final_norm"], x, cfg, policy=policy)
    return layers.unembed(params["embed"], x, cfg)


def loss_fn(params, cfg: ArchConfig, batch: dict, *,
            policy: ExecutionPolicy = STRUCTURED):
    """Mean next-token cross-entropy. batch: tokens / labels [B, N]
    (label -1 is ignored)."""
    logits = forward(params, cfg, batch["tokens"], policy=policy)
    return structured.softmax_xent(logits, batch["labels"])


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, cache, tokens, *,
                policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    """One decode step. tokens: [B, 1] -> (logits [B, 1, V] f32, cache),
    the cache advanced in place.

    ``adapter_tiles``: int32 device tensor [B // bm] routing each slot tile
    to its resident adapter for tenant-stacked LoRA params.
    """
    _require(cfg, ("dense",))
    x = layers.embed(params["embed"], tokens, cfg)
    per = len(cfg.window_pattern) or 1
    for i, (bp, window) in enumerate(_layer_list(params, cfg)):
        lc = _layer(cache["groups"][f"l{i % per}"], i // per) \
            if cfg.window_pattern else _layer(cache["blocks"], i)
        x, _ = dense_block(bp, x, cfg, cache=lc, window=window,
                           policy=policy, adapter_tiles=adapter_tiles)
    x = layers.norm(params["final_norm"], x, cfg, policy=policy)
    return layers.unembed(params["embed"], x, cfg), cache


def trainable_mask(params):
    """Same nesting as ``params``: True for LoRA factors ('a'/'b')."""
    def mark(tree, key=None):
        if isinstance(tree, dict):
            return {k: mark(v, k) for k, v in tree.items()}
        return key in ("a", "b")

    return mark(params)


def split_params(params):
    """(trainable, frozen): two trees with the params' nesting, the LoRA
    leaves in the first and the others in the second, ``None`` elsewhere."""
    mask = trainable_mask(params)

    def part(tree, m, keep):
        if isinstance(tree, dict):
            return {k: part(tree[k], m[k], keep) for k in tree}
        return tree if m == keep else None

    return part(params, mask, True), part(params, mask, False)


def merge_params(train, frozen):
    """Inverse of :func:`split_params`."""
    if isinstance(frozen, dict):
        return {k: merge_params(train[k], frozen[k]) for k in frozen}
    return train if frozen is None else frozen
