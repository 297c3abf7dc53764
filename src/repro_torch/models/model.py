"""Model assembly (``repro.models.model``) for the dense family: init,
per-slot decode cache, and the multi-tenant decode step.

Block parameters are stacked ``[L, ...]`` as in the reference's tree (the
weight bridge relies on it); the decode step walks the layers in a Python
loop where the reference scans. The cache is written in place.
"""
from __future__ import annotations

import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
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


def init_params(cfg: ArchConfig, *, generator: torch.Generator):
    """Random parameters at the reference's scales, made on the generator's
    device in ``cfg.dtype``. The values differ from ``jax.random``'s; tests
    that compare the two packages bridge the reference's parameters."""
    _require_dense(cfg)
    gen = generator
    dtype = getattr(torch, cfg.dtype)
    L, d = cfg.n_layers, cfg.d_model
    ones = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    return {
        "embed": layers.embed_params(gen, cfg),
        "final_norm": ones(d),
        "blocks": {"ln1": ones(L, d),
                   "attn": layers.attention_params(gen, cfg, lead=(L,)),
                   "ln2": ones(L, d),
                   "mlp": layers.mlp_params(gen, cfg, lead=(L,))},
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
