"""Model assembly (``repro.models.model``) for the dense family: init,
the full-sequence forward and loss for training, the per-slot decode cache
and the multi-tenant decode step.

Block parameters are stacked ``[L, ...]`` as in the reference's tree (the
weight bridge relies on it). The forward and the decode step walk the
layers in a Python loop where the reference scans; in training each block
runs under ``torch.utils.checkpoint`` when ``policy.remat`` is set, so only
block inputs are stored across the forward (the reference's
``jax.checkpoint`` around its scan body, paper §4.3). The cache is written
in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant, structured
from repro_torch.models import layers


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or not cfg.tie_embeddings:
        raise NotImplementedError(
            "the port runs dense models with tied embeddings so far, not "
            f"{cfg.name!r}")


def dense_block(bp, x, cfg: ArchConfig, *, cache,
                policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    h, new_cache = layers.attention(
        bp["attn"], layers.norm(bp["ln1"], x, cfg, policy=policy), cfg,
        cache=cache, policy=policy, adapter_tiles=adapter_tiles)
    x = x + h
    x = x + layers.mlp(bp["mlp"],
                       layers.norm(bp["ln2"], x, cfg, policy=policy),
                       cfg, policy=policy, adapter_tiles=adapter_tiles)
    return x, new_cache


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                quantize=None):
    """Random parameters at the reference's scales, made on the generator's
    device in ``cfg.dtype``. The values differ from ``jax.random``'s; tests
    that compare the two packages bridge the reference's parameters.
    ``quantize`` ("int8", or packed "int4"/"nf4") turns every frozen ``w``
    leaf into its ``core/quant`` format as it is drawn (the same values as
    ``quant.quantize_params`` over the dense tree, without ever holding
    that tree); LoRA factors, biases, norms and the embedding stay in
    ``cfg.dtype``."""
    _require_dense(cfg)
    gen = generator
    dtype = getattr(torch, cfg.dtype)
    L, d = cfg.n_layers, cfg.d_model
    method = None if quantize in (None, "none") else quantize
    if method is not None and method not in quant.METHODS:
        raise ValueError(f"unknown quantize method {quantize!r}; "
                         f"expected one of {quant.METHODS}")
    ones = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    return {
        "embed": layers.embed_params(gen, cfg),
        "final_norm": ones(d),
        "blocks": {"ln1": ones(L, d),
                   "attn": layers.attention_params(gen, cfg, lead=(L,),
                                                   quantize=method),
                   "ln2": ones(L, d),
                   "mlp": layers.mlp_params(gen, cfg, lead=(L,),
                                            quantize=method)},
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cpu"):
    """Stacked per-layer, per-slot KV caches (the reference's
    ``init_cache(per_slot=True)``): {"blocks": {"k", "v": [L,B,Hkv,S,D],
    "len": [L,B]}}."""
    _require_dense(cfg)
    return {"blocks": layers.make_kv_cache(
        cfg, batch, max_len, getattr(torch, cfg.dtype),
        lead=(cfg.n_layers,), device=device)}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int):
    """Stacked [L, ...] leaves -> n per-layer trees of views. ``unbind``
    gives all n views one autograd node, so the gradient of a stacked
    trainable leaf is assembled once, not summed from n zero-padded
    copies."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return tree.unbind(0)


def forward(params, cfg: ArchConfig, tokens, *,
            policy: ExecutionPolicy = STRUCTURED):
    """Full-sequence forward -> logits [B, N, vocab] in f32."""
    _require_dense(cfg)
    x = layers.embed(params["embed"], tokens, cfg)

    def body(x, bp):
        return dense_block(bp, x, cfg, cache=None, policy=policy)[0]

    for bp in _unstack(params["blocks"], cfg.n_layers):
        if policy.remat:
            x = checkpoint(body, x, bp, use_reentrant=False)
        else:
            x = body(x, bp)
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
    _require_dense(cfg)
    x = layers.embed(params["embed"], tokens, cfg)
    blocks, cblocks = params["blocks"], cache["blocks"]
    for i in range(cfg.n_layers):
        lc = _layer(cblocks, i)
        x, _ = dense_block(_layer(blocks, i), x, cfg, cache=lc,
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
