"""Model assembly (``repro.models.model``) for all six families of the
reference's catalog: dense, MoE, ``vlm`` (InternVL2), ``audio``
(Whisper), ``ssm`` (RWKV6) and ``hybrid`` (RecurrentGemma): init, the
full-sequence forward and loss for training, the decode caches and the
decode step.

Block parameters are stacked ``[L, ...]`` as in the reference's tree (the
weight bridge relies on it). An MoE model stacks ``moe_block``s; a config
with ``first_layer_dense`` (DeepSeekMoE) puts a dense block of MLP width
``d_expert · (top_k + n_shared)`` first, unstacked, as ``block0``. A
config with a ``window_pattern`` (Gemma3: 5 local layers, then a global
one) stacks its blocks per pattern period, ``groups`` leaves
``[n_groups, period, ...]``, as the reference does, so each position of
the period keeps its own window. An ``ssm`` model stacks RWKV6 blocks
(``models/rwkv6.py``) as ``blocks``. A ``hybrid`` model keeps one
``groups`` entry per position of its pattern (``l0``, ``l1``, ``l2`` for
R, R, A: recurrent blocks of ``models/griffin.py`` and local-attention
dense blocks), each stacked ``[n_groups, ...]``, and the layers past the
last whole period as ``tail``, a *list* of unstacked blocks (the
reference's layout; ``repro_torch/tree.py`` walks lists as it walks
dicts). A ``vlm`` model is a dense model whose forward takes
``frontend_embeds`` [B, P, d], precomputed patch embeddings prepended to
the text, whose labels the loss pads with -1. An ``audio`` model stacks
its encoder's blocks (non-causal attention without RoPE, a GeLU MLP) as
``enc_blocks`` with ``enc_norm`` after them, and its decoder's as
``blocks`` (causal self-attention, cross-attention over the encoder's
output ``xattn`` after its norm ``lnx``, a GeLU MLP); both add sinusoid
positions, and its forward needs ``enc_frames`` [B, T, d], precomputed
frame embeddings.

The forward and the decode step walk the layers in a Python loop where
the reference scans; in training each stacked block (each group of a
patterned or hybrid model) runs under ``torch.utils.checkpoint`` when
``policy.remat`` is set, so only block (or group) inputs are stored
across the forward (the reference's ``jax.checkpoint`` around its scan
body, paper §4.3); ``block0`` and a hybrid's ``tail`` run outside it, as
in the reference. The cache is written in place: a KV cache per
attention layer (a patterned model's keyed per position of the period,
``l{i}``: a ring of ``window`` slots for a local layer whose window is
shorter than the cache, else linear, stacked over groups) and, for the
recurrent families, the recurrent states, which each step overwrites.
Every cache carries a ``[B]`` length vector: per slot for continuous
batching, all equal for single-stream decode (the reference's scalar
length, which ``ssm`` and ``hybrid`` caches always have).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant, structured
from repro_torch.models import griffin, layers, rwkv6
from repro_torch.models import moe as moe_lib
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

#: families with a KV cache only: these take a per-slot cache
_KV_FAMILIES = ("dense", "vlm", "moe")
#: families whose decode takes adapter routing (tenant-stacked LoRA)
_ROUTED_FAMILIES = ("dense", "vlm")


#: the families the port runs: the reference's six
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def _require(cfg: ArchConfig, families=FAMILIES) -> None:
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


def moe_block(bp, x, cfg: ArchConfig, *, cache=None,
              policy: ExecutionPolicy = STRUCTURED):
    """Attention, then the MoE MLP (``models/moe.py``) in place of the
    dense one. With ``cache`` (decode) the attention reads and advances it
    in place."""
    h, _ = layers.attention(
        bp["attn"], layers.norm(bp["ln1"], x, cfg, policy=policy), cfg,
        cache=cache, policy=policy)
    x = x + h
    return x + moe_lib.moe_mlp(bp["moe"],
                               layers.norm(bp["ln2"], x, cfg, policy=policy),
                               cfg, policy=policy)


def enc_block(bp, x, cfg: ArchConfig, *,
              policy: ExecutionPolicy = STRUCTURED):
    """A Whisper encoder block: non-causal attention without RoPE, then
    the GeLU MLP."""
    h, _ = layers.attention(
        bp["attn"], layers.norm(bp["ln1"], x, cfg, policy=policy), cfg,
        causal=False, use_rope=False, policy=policy)
    x = x + h
    return x + layers.mlp(bp["mlp"],
                          layers.norm(bp["ln2"], x, cfg, policy=policy),
                          cfg, policy=policy)


def dec_block(bp, x, cfg: ArchConfig, *, enc_out, cache=None,
              policy: ExecutionPolicy = STRUCTURED):
    """A Whisper decoder block: causal self-attention without RoPE (over
    ``cache`` in decode), cross-attention over ``enc_out`` [B, T, d]
    (non-causal, no RoPE, no cache: its k/v are recomputed from
    ``enc_out`` every call, as in the reference), then the GeLU MLP."""
    h, _ = layers.attention(
        bp["attn"], layers.norm(bp["ln1"], x, cfg, policy=policy), cfg,
        cache=cache, use_rope=False, policy=policy)
    x = x + h
    h, _ = layers.attention(
        bp["xattn"], layers.norm(bp["lnx"], x, cfg, policy=policy), cfg,
        causal=False, kv_x=enc_out, use_rope=False, policy=policy)
    x = x + h
    return x + layers.mlp(bp["mlp"],
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
    _require(cfg)
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
    if cfg.family == "ssm":
        p["blocks"] = rwkv6.rwkv_block_params(gen, cfg, lead=(L,),
                                              quantize=method)
        return p
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        n_groups = L // len(pat)
        p["groups"] = {f"l{i}": _hybrid_params(gen, cfg, kind, (n_groups,),
                                               method)
                       for i, kind in enumerate(pat)}
        p["tail"] = [_hybrid_params(gen, cfg, pat[i % len(pat)], (), method)
                     for i in range(n_groups * len(pat), L)]
        return p
    if cfg.family == "audio":
        p["enc_blocks"] = _dense_params(
            gen, cfg, (cfg.encdec.encoder_layers,), method, act="gelu")
        p["enc_norm"] = ones(d)
        p["blocks"] = _dec_params(gen, cfg, (L,), method)
        return p
    lead = (L,)
    if cfg.window_pattern:
        gsz = len(cfg.window_pattern)
        if L % gsz:
            raise ValueError(f"{cfg.name}: {L} layers are not whole periods "
                             f"of the window pattern {cfg.window_pattern}")
        lead = (L // gsz, gsz)
    p["groups" if cfg.window_pattern else "blocks"] = _dense_params(
        gen, cfg, lead, method)
    return p


def _dense_params(gen, cfg: ArchConfig, lead, method, act="silu"):
    """A dense block's params (with ``act`` "gelu", Whisper's encoder
    block: the MLP without a gate)."""
    ones = lambda *s: torch.ones(s, dtype=getattr(torch, cfg.dtype),
                                 device=gen.device)
    d = cfg.d_model
    return {"ln1": ones(*lead, d),
            "attn": layers.attention_params(gen, cfg, lead=lead,
                                            quantize=method),
            "ln2": ones(*lead, d),
            "mlp": layers.mlp_params(gen, cfg, act=act, lead=lead,
                                     quantize=method)}


def _dec_params(gen, cfg: ArchConfig, lead, method):
    """A Whisper decoder block's params: ``attn``, the cross-attention
    ``xattn`` with its norm ``lnx``, and the MLP without a gate."""
    ones = lambda *s: torch.ones(s, dtype=getattr(torch, cfg.dtype),
                                 device=gen.device)
    d = cfg.d_model
    att = functools.partial(layers.attention_params, gen, cfg, lead=lead,
                            quantize=method)
    return {"ln1": ones(*lead, d), "attn": att(), "lnx": ones(*lead, d),
            "xattn": att(), "ln2": ones(*lead, d),
            "mlp": layers.mlp_params(gen, cfg, act="gelu", lead=lead,
                                     quantize=method)}


def _hybrid_params(gen, cfg: ArchConfig, kind: str, lead, method):
    """A hybrid's block of pattern letter ``kind``: "R" recurrent, "A" a
    dense block with local attention."""
    if kind == "R":
        return griffin.recurrent_block_params(gen, cfg, lead=lead,
                                              quantize=method)
    return _dense_params(gen, cfg, lead, method)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cpu",
               per_slot: bool = True):
    """Stacked per-layer decode caches. KV caches are {"k", "v":
    [L,B,Hkv,S,D], "len": [L,B]} under "blocks" (with a window pattern
    {"groups": {"l{i}": {"k", "v": [n_groups,B,Hkv,S_i,D], "len":
    [n_groups,B]}}}, S_i the window of position i where that is shorter
    than ``max_len`` (a ring), else ``max_len``); an MoE model's ``block0``
    has its own, unstacked. An ``ssm`` model's "blocks" hold RWKV6 states
    (``rwkv6.make_rwkv_state``); a ``hybrid`` model's "groups" hold, per
    pattern position, recurrent states or local-attention KV caches
    stacked over groups, and "tail" a list of them. An ``audio`` model's
    "blocks" hold its decoder's self-attention caches, and "enc_out" [B,
    encoder_seq, d] the encoder's output its cross-attention reads, zeros
    until the caller sets it (the reference's ``DecodeServer`` decodes
    against those zeros).

    ``per_slot`` (the default: continuous batching) lets every slot sit at
    its own position; the recurrent and ``audio`` families have no such
    cache, and ask for ``per_slot=False`` (single-stream decode: the whole
    batch at one position), as the reference's ``init_cache`` does."""
    _require(cfg)
    if per_slot and cfg.family not in _KV_FAMILIES:
        raise ValueError(f"per_slot decode caches unsupported for "
                         f"{cfg.family!r}")
    dtype = getattr(torch, cfg.dtype)
    kv = functools.partial(layers.make_kv_cache, cfg, batch, max_len, dtype,
                           device=device)
    if cfg.family == "ssm":
        return {"blocks": rwkv6.make_rwkv_state(
            cfg, batch, dtype, lead=(cfg.n_layers,), device=device)}
    if cfg.family == "hybrid":
        pat, window = cfg.hybrid.pattern, cfg.hybrid.window
        n_groups = cfg.n_layers // len(pat)

        def state(kind, lead):
            if kind == "R":
                return griffin.make_recurrent_state(cfg, batch, dtype,
                                                    lead=lead, device=device)
            return kv(window=window, lead=lead)

        return {"groups": {f"l{i}": state(kind, (n_groups,))
                           for i, kind in enumerate(pat)},
                "tail": [state(pat[i % len(pat)], ())
                         for i in range(n_groups * len(pat), cfg.n_layers)]}
    if cfg.window_pattern:
        lead = (cfg.n_layers // len(cfg.window_pattern),)
        return {"groups": {f"l{i}": kv(window=w, lead=lead)
                           for i, w in enumerate(cfg.window_pattern)}}
    if cfg.family == "audio":
        return {"blocks": kv(lead=(cfg.n_layers,)),
                "enc_out": torch.zeros(
                    (batch, cfg.encdec.encoder_seq, cfg.d_model),
                    dtype=dtype, device=device)}
    dense0 = cfg.moe is not None and cfg.moe.first_layer_dense
    c = {"blocks": kv(lead=(cfg.n_layers - dense0,))}
    if dense0:
        c["block0"] = kv()
    return c


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


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
    """[(kind, block params, window)] for every layer past ``block0`` and
    before a hybrid's ``tail``, in order. kind: "dense", "moe", "rwkv",
    "dec" (a Whisper decoder block), or "R" (a hybrid's recurrent block;
    its "A" blocks are dense blocks with the local window)."""
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        n_groups = cfg.n_layers // len(pat)
        per = [_unstack(params["groups"][f"l{i}"], n_groups)
               for i in range(len(pat))]
        return [_hybrid_layer(cfg, pat[i], per[i][g]) for g in range(n_groups)
                for i in range(len(pat))]
    if "groups" in params:
        return [("dense", bp, cfg.layer_window(i)) for i, bp in enumerate(
            _unstack(params["groups"], cfg.n_layers, 2))]
    kind = {"moe": "moe", "ssm": "rwkv", "audio": "dec"}.get(cfg.family,
                                                            "dense")
    blocks = params["blocks"]
    return [(kind, bp, 0)
            for bp in _unstack(blocks, blocks["ln1"].shape[0])]


def _hybrid_layer(cfg: ArchConfig, letter: str, bp):
    return ("R", bp, 0) if letter == "R" else ("dense", bp, cfg.hybrid.window)


def _tail_list(params, cfg: ArchConfig):
    """:func:`_layer_list`'s entries for a hybrid's ``tail`` (the layers
    past the last whole pattern period, unstacked)."""
    tail = params.get("tail", ())
    if not tail:
        return []
    pat = cfg.hybrid.pattern
    start = cfg.n_layers - len(tail)
    return [_hybrid_layer(cfg, pat[(start + i) % len(pat)], bp)
            for i, bp in enumerate(tail)]


def _period(cfg: ArchConfig) -> int:
    """Layers a checkpointed unit holds: one pattern period (the
    reference's scan body), else one block."""
    if cfg.family == "hybrid":
        return len(cfg.hybrid.pattern)
    return len(cfg.window_pattern) or 1


def _run_block(kind, bp, x, cfg: ArchConfig, window: int, policy,
               state=None, adapter_tiles=None, enc_out=None):
    """One layer of any kind; (x, new recurrent state or None).
    ``state``: the layer's cache (decode) or None (training); ``enc_out``:
    the encoder's output a decoder block cross-attends to."""
    if kind == "dec":
        return dec_block(bp, x, cfg, enc_out=enc_out, cache=state,
                         policy=policy), None
    if kind == "moe":
        return moe_block(bp, x, cfg, cache=state, policy=policy), None
    if kind == "rwkv":
        return rwkv6.rwkv_block(bp, x, cfg, state=state, policy=policy)
    if kind == "R":
        return griffin.recurrent_block(bp, x, cfg, state=state,
                                       policy=policy)
    return dense_block(bp, x, cfg, cache=state, window=window, policy=policy,
                       adapter_tiles=adapter_tiles)[0], None


def _sinusoid(n: int, d: int, device):
    """Sinusoid positions [1, n, d] in f32 (sin then cos over d/2
    frequencies), as the reference's ``_sinusoid``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    return _sinusoid_angles(pos, d)[None]


def _sinusoid_at(pos, d: int):
    """The sinusoid row of each position of ``pos`` [B] -> [B, 1, d], f32
    (the reference's ``_sinusoid_at``, per slot)."""
    return _sinusoid_angles(pos.float()[:, None], d)[:, None]


def _sinusoid_angles(pos, d: int):
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None]
    ang = pos / (10000 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _encoder_forward(params, cfg: ArchConfig, frames, policy):
    """Whisper's encoder over precomputed frame embeddings [B, T, d], in
    the activations' type (the embedding table's, as the vlm prefix is
    cast): sinusoid positions (rounded to that type before the add, as the
    reference rounds them), the ``enc_blocks``, each under
    torch.utils.checkpoint when ``policy.remat`` is set, then
    ``enc_norm``."""
    frames = frames.to(params["embed"]["tok"].dtype)
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    body = functools.partial(enc_block, cfg=cfg, policy=policy)
    blocks = params["enc_blocks"]
    for bp in _unstack(blocks, blocks["ln1"].shape[0]):
        x = checkpoint(body, bp, x, use_reentrant=False) if policy.remat \
            else body(bp, x)
    return layers.norm(params["enc_norm"], x, cfg, policy=policy)


def forward(params, cfg: ArchConfig, tokens, *,
            policy: ExecutionPolicy = STRUCTURED, frontend_embeds=None,
            enc_frames=None):
    """Full-sequence forward -> logits [B, N, vocab] in f32; with
    ``frontend_embeds`` [B, P, d] (vlm) the patch embeddings go ahead of
    the text, and the logits are [B, P + N, vocab]. An ``audio`` model
    needs ``enc_frames`` [B, T, d]."""
    _require(cfg)
    _check_model_axis(cfg, policy, tokens.shape[1])
    x = layers.embed(params["embed"], tokens, cfg, policy=policy)
    if frontend_embeds is not None:   # vlm: precomputed patch embeddings
        x = torch.cat([frontend_embeds.to(x.dtype), x], 1)
    if "block0" in params:
        x = dense_block(params["block0"], x, cfg, cache=None,
                        policy=policy)[0]
    enc_out = None
    if cfg.family == "audio":
        if enc_frames is None:
            raise ValueError(f"{cfg.name} (audio) needs enc_frames: the "
                             "encoder's frame embeddings [B, T, d]")
        enc_out = _encoder_forward(params, cfg, enc_frames, policy)
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)

    # enc_out is an input of every checkpointed unit, so that its gradient
    # (the cross-attention's dk/dv) reaches the encoder's LoRA leaves
    def body(x, enc_out, group):
        for kind, bp, window in group:
            x = _run_block(kind, bp, x, cfg, window, policy,
                           enc_out=enc_out)[0]
        return x

    # one checkpointed unit a block, or a pattern period (the reference's
    # scan body: its group inputs are all that is stored)
    per = _period(cfg)
    layer_list = _layer_list(params, cfg)
    for g in range(0, len(layer_list), per):
        group = layer_list[g:g + per]
        if policy.remat:
            x = checkpoint(body, x, enc_out, group, use_reentrant=False)
        else:
            x = body(x, enc_out, group)
    # a hybrid's tail runs outside the checkpoint, as in the reference
    for kind, bp, window in _tail_list(params, cfg):
        x = _run_block(kind, bp, x, cfg, window, policy)[0]
    x = layers.norm(params["final_norm"], x, cfg, policy=policy)
    return layers.unembed(params["embed"], x, cfg, policy=policy)


def _check_model_axis(cfg: ArchConfig, policy: ExecutionPolicy, n: int):
    """Under a model axis: the dense family only, and under SP a sequence
    that divides over the axis."""
    tp = policy.tp
    if tp is None:
        return
    if cfg.family != "dense":
        raise ValueError(f"the model axis runs the dense family only, not "
                         f"{cfg.name!r} ({cfg.family}; ROADMAP.md §1, "
                         "item 3)")
    if policy.sp and n % tp.size:
        raise ValueError(f"sequence parallelism needs the sequence ({n}) "
                         f"to divide over the model axis ({tp.size})")


def loss_fn(params, cfg: ArchConfig, batch: dict, *,
            policy: ExecutionPolicy = STRUCTURED):
    """Mean next-token cross-entropy. batch: tokens / labels [B, N]
    (label -1 is ignored), and ``frontend_embeds`` (vlm: the prefix's
    labels are -1) or ``enc_frames`` (audio) where the model takes them.
    Under a model axis the logits are vocab-parallel and so is the loss
    (``structured.softmax_xent``'s ``tp``)."""
    fe = batch.get("frontend_embeds")
    logits = forward(params, cfg, batch["tokens"], policy=policy,
                     frontend_embeds=fe,
                     enc_frames=batch.get("enc_frames"))
    labels = batch["labels"]
    if cfg.frontend_tokens and fe is not None:   # the prefix has no labels
        labels = torch.cat([labels.new_full((labels.shape[0], fe.shape[1]),
                                            -1), labels], 1)
    return structured.softmax_xent(logits, labels, tp=policy.tp)


def _overwrite(dst, src) -> None:
    """Copy a block's new recurrent state into its cache views, in
    place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _layer_caches(cache, cfg: ArchConfig):
    """The per-layer cache views, in :func:`_layer_list`'s order."""
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        return [_layer(cache["groups"][f"l{i}"], g)
                for g in range(cfg.n_layers // len(pat))
                for i in range(len(pat))]
    if cfg.window_pattern:
        per = len(cfg.window_pattern)
        return [_layer(cache["groups"][f"l{i % per}"], i // per)
                for i in range(cfg.n_layers)]
    blocks = cache["blocks"]
    n = tree_leaves(blocks)[0].shape[0]
    return [_layer(blocks, i) for i in range(n)]


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, cache, tokens, *,
                policy: ExecutionPolicy = STRUCTURED, adapter_tiles=None):
    """One decode step. tokens: [B, 1] -> (logits [B, 1, V] f32, cache),
    the cache advanced in place.

    ``adapter_tiles``: int32 device tensor [B // bm] routing each slot tile
    to its resident adapter for tenant-stacked LoRA params (dense and vlm
    families only: an MoE's expert stacks already take the group axis, and
    the recurrent and audio families serve one adapter set).

    An ``audio`` model adds the sinusoid row of each slot's position and
    cross-attends to ``cache["enc_out"]``, its k/v recomputed every step
    (as the reference does).
    """
    _require(cfg)
    if policy.tp is not None:
        raise ValueError("decode under a model axis is not ported "
                         "(ROADMAP.md §1, item 3)")
    if adapter_tiles is not None and cfg.family not in _ROUTED_FAMILIES:
        raise ValueError(f"adapter routing unsupported for {cfg.family!r}")
    x = layers.embed(params["embed"], tokens, cfg)
    enc_out = cache.get("enc_out")
    if cfg.family == "audio":
        x = x + _sinusoid_at(cache["blocks"]["len"][0],
                             cfg.d_model).to(x.dtype)
    if "block0" in params:
        x = dense_block(params["block0"], x, cfg, cache=cache["block0"],
                        policy=policy)[0]
    blocks = _layer_list(params, cfg) + _tail_list(params, cfg)
    states = _layer_caches(cache, cfg) + list(cache.get("tail", ()))
    for (kind, bp, window), st in zip(blocks, states):
        x, ns = _run_block(kind, bp, x, cfg, window, policy, state=st,
                           adapter_tiles=adapter_tiles, enc_out=enc_out)
        if ns is not None:
            _overwrite(st, ns)
    x = layers.norm(params["final_norm"], x, cfg, policy=policy)
    return layers.unembed(params["embed"], x, cfg), cache


def trainable_mask(params):
    """Same nesting as ``params``: True for LoRA factors ('a'/'b')."""
    return tree_map_with_path(
        lambda path, _: bool(path) and path[-1] in ("a", "b"), params)


def split_params(params):
    """(trainable, frozen): two trees with the params' nesting, the LoRA
    leaves in the first and the others in the second, ``None`` elsewhere."""
    mask = trainable_mask(params)
    part = lambda keep: tree_map(lambda t, m: t if m == keep else None,
                                 params, mask)
    return part(True), part(False)


def merge_params(train, frozen):
    """Inverse of :func:`split_params`."""
    return tree_map(lambda f, t: t if f is None else f, frozen, train)
