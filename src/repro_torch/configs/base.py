"""Architecture configuration (the port's own copy of ``repro.configs.base``).

Only what the ported families read is kept: :class:`LoRAConfig`,
:class:`MoEConfig`, :class:`HybridConfig`, :class:`EncDecConfig` and the
fields of :class:`ArchConfig` that the six families (dense, MoE, ``vlm``,
``audio``, ``ssm``, ``hybrid``) read (with the per-layer sliding windows,
``window_pattern``, and the frontend stub's ``frontend_tokens``), with the
same ``reduced()`` cut to size as the reference, so a reduced config names
the same shapes in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LoRAConfig:
    """Paper setup: rank 8, alpha 16, applied to q,k,v,o,gate,up,down."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_layer_dense: bool = False  # deepseek-moe: layer 0 is a dense FFN


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style block pattern."""

    pattern: Tuple[str, ...] = ("R", "R", "A")  # repeated; truncated to n_layers
    lru_width: int = 0  # defaults to d_model when 0
    window: int = 2048  # local attention window for 'A' blocks


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder."""

    encoder_layers: int = 4
    encoder_seq: int = 1500  # precomputed mel-frame embeddings (stub frontend)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # d_model // n_heads unless overridden
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # attention layout: per-layer sliding window sizes, repeated over the
    # layers; () => all-global. gemma3 uses 5 local : 1 global.
    window_pattern: Tuple[int, ...] = ()  # 0 = global, >0 = local window
    moe: Optional[MoEConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    # frontend stub for vlm: this many precomputed patch embeddings are
    # prepended to the text
    frontend_tokens: int = 0
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_size(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_size(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def embed_scale(self) -> Optional[float]:
        """What the token rows are scaled by: sqrt(d_model) for the Gemma
        families, as the reference's embed does; None for the others."""
        if self.name.startswith(("gemma", "recurrentgemma")):
            return self.d_model ** 0.5
        return None

    def layer_window(self, i: int) -> int:
        """Layer i's sliding window (0: global attention)."""
        if not self.window_pattern:
            return 0
        return self.window_pattern[i % len(self.window_pattern)]

    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        return 2 * self.d_model * self.n_heads * hd \
            + 2 * self.d_model * self.n_kv_heads * hd

    def _emb_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    def n_params(self) -> int:
        """Approximate parameter count, as the reference counts it (every
        layer an MoE layer for the MoE family; RWKV6's time and channel
        mix for ``ssm``; a hybrid's layers all counted as attention and MLP;
        an encoder's layers as 4 d² of attention and 2 d·d_ff of MLP, a
        decoder's cross-attention not at all; no biases or norms)."""
        d = self.d_model
        if self.family == "ssm":
            return self._emb_params() + self.n_layers * (
                5 * d * d + 3 * d * self.d_ff)
        if self.moe is not None:
            m = self.moe
            ff = 3 * d * m.d_expert * (m.n_experts + m.n_shared) \
                + d * m.n_experts                    # + the router
        else:
            ff = 3 * d * self.d_ff
        total = self._emb_params() + self.n_layers * (self._attn_params()
                                                      + ff)
        if self.encdec is not None:
            total += self.encdec.encoder_layers * (4 * d * d
                                                   + 2 * d * self.d_ff)
        return total

    def n_active_params(self) -> int:
        """Parameters a token meets (MoE: its top-k and the shared
        experts)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        ff = 3 * self.d_model * m.d_expert * (m.top_k + m.n_shared)
        return self._emb_params() + self.n_layers * (self._attn_params() + ff)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config (the reference's cut: for MoE, 4
        experts, top-2, d_expert 32, at most one shared expert, and a dense
        layer 0 kept where the full config has one; a window pattern cut to
        a 2-layer (local 8, global) period; a hybrid to 3 layers, an RG-LRU
        64 wide and a local window of 8; at most 4 frontend tokens; an
        encoder to 2 layers over 8 frames)."""
        moe = self.moe
        if moe is not None:
            moe = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                            n_shared=min(moe.n_shared, 1),
                            first_layer_dense=moe.first_layer_dense)
        pattern = {"window_pattern": (8, 0)} if self.window_pattern else {}
        encdec = None if self.encdec is None else EncDecConfig(
            encoder_layers=2, encoder_seq=8)
        hybrid = self.hybrid
        if hybrid is not None:
            hybrid = HybridConfig(pattern=hybrid.pattern, lru_width=64,
                                  window=8)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 3 if hybrid else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            dtype="float32",
            moe=moe,
            hybrid=hybrid,
            encdec=encdec,
            frontend_tokens=min(self.frontend_tokens, 4),
            lora=LoRAConfig(rank=4, alpha=8.0, targets=self.lora.targets),
            **pattern,
        )
