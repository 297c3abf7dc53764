"""Serve-side resident-memory accounting: the port's own copy of the part of
``benchmarks/memsim.py`` that ``serve_residency`` needs, with the same
formulas and constants.

This is a model, not a measurement: every term is computed from shapes and
byte widths (bf16 activations, adapters and KV; the frozen base in its
``weights_fmt``), plus a fixed runtime floor. The continuous batcher's
admission headroom gate (``ContinuousBatcher(mem_budget_mb=)``) charges it,
as the reference's batcher does; what the card really holds is
``torch.cuda.memory_allocated``, which ``chip_smoke.py`` prints beside it.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig

BF16 = 2
F32 = 4
W4 = 0.5          # packed 4-bit frozen weights
INT8 = 1          # int8 frozen weights
RUNTIME_MB = 40.0  # process/runtime floor

#: weights formats :func:`resident_weight_mb` charges
#: (``core.quant.weights_format`` maps a ``--quantize`` method onto one)
WEIGHTS_FORMATS = ("bf16", "int8", "int4", "nf4")


def _block_linear_params(cfg: ArchConfig) -> float:
    d, f = cfg.d_model, cfg.d_ff
    return (d * cfg.q_size + 2 * d * cfg.kv_size + cfg.q_size * d
            + 3 * d * f)


def _lora_params(cfg: ArchConfig, rank: int) -> float:
    d, f = cfg.d_model, cfg.d_ff
    per_block = rank * (
        (d + cfg.q_size) + 2 * (d + cfg.kv_size) + (cfg.q_size + d)
        + 2 * (d + f) + (f + d))
    return per_block * cfg.n_layers


def _scale_count(cfg: ArchConfig) -> float:
    """Per-output-channel f32 scales of a quantized base: one per linear
    output column (q/k/v/o, gate/up/down) per block."""
    return (cfg.q_size + 2 * cfg.kv_size + cfg.d_model
            + 2 * cfg.d_ff + cfg.d_model) * cfg.n_layers


def resident_weight_mb(cfg: ArchConfig, fmt: str = "bf16") -> float:
    """Device-resident frozen weights in MB (2^20 bytes).

    * ``bf16``: dense W0 at 2 B a weight.
    * ``int8``: 1 B a weight plus the f32 per-output-channel scale rows; no
      dequantization workspace, since the grouped kernels read the codes.
    * ``int4`` / ``nf4``: 0.5 B a weight (two codes a byte) plus the same
      scale rows; nf4's 16-entry codebook is not charged.

    Embeddings stay bf16 in every format (only ``w`` leaves quantize)."""
    lin = _block_linear_params(cfg) * cfg.n_layers
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if fmt == "bf16":
        return (lin + emb) * BF16 / 2**20
    if fmt == "int8":
        return (lin * INT8 + _scale_count(cfg) * F32 + emb * BF16) / 2**20
    if fmt in ("int4", "nf4"):
        return (lin * W4 + _scale_count(cfg) * F32 + emb * BF16) / 2**20
    raise ValueError(f"unknown weights format {fmt!r}; expected one of "
                     f"{WEIGHTS_FORMATS}")


def _per_block_intermediates(cfg: ArchConfig, B: int, N: int,
                             rank: int) -> float:
    """Bytes of one block's transient intermediates (fused attention)."""
    d, f = cfg.d_model, cfg.d_ff
    t = 0.0
    t += 2 * B * N * d * BF16            # ln1/ln2 outputs
    t += B * N * (cfg.q_size + 2 * cfg.kv_size) * BF16   # q,k,v
    t += B * N * (cfg.q_size + 2 * cfg.kv_size) * BF16   # rope'd copies
    t += B * N * cfg.q_size * BF16       # attention output
    t += B * N * d * BF16                # o-proj output
    t += 3 * B * N * f * BF16            # gate, up, silu(gate)
    t += B * N * f * BF16                # gated product
    t += 2 * B * N * d * BF16            # down out + residual
    t += 7 * B * N * rank * BF16         # LoRA h per projection
    return t


def _head_working_set(cfg: ArchConfig, B: int, N: int) -> float:
    """One bf16 logits tensor."""
    return B * N * cfg.vocab * BF16


def kv_page_mb(cfg: ArchConfig, page_size: int) -> float:
    """One KV page (``page_size`` positions, k and v, every layer) in MB."""
    hd = cfg.resolved_head_dim
    return (2 * cfg.n_layers * cfg.n_kv_heads * hd * page_size * BF16) / 2**20


def adapter_slot_mb(cfg: ArchConfig, rank: int) -> float:
    """One resident tenant's (A, B) leaves in MB (AdapterStore)."""
    return _lora_params(cfg, rank) * BF16 / 2**20


def serve_residency(cfg, *, rank: int, resident_adapters: int,
                    kv_pages: int, page_size: int, batch: int = 1,
                    weights_fmt: str = "bf16") -> dict:
    """Modelled resident set of a serving process, MB by term and total:
    the frozen base in ``weights_fmt`` (:func:`resident_weight_mb`),
    ``resident_adapters`` stacked (A, B) sets at ``rank``, ``kv_pages``
    live KV pages, the decode working set (one block's intermediates at one
    position plus the logits, for ``batch`` rows) and :data:`RUNTIME_MB`.
    ``cfg``: an :class:`ArchConfig` or a registry name."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    weights_mb = resident_weight_mb(cfg, weights_fmt)
    adapters_mb = resident_adapters * adapter_slot_mb(cfg, rank)
    kv_mb = kv_pages * kv_page_mb(cfg, page_size)
    decode_mb = (_per_block_intermediates(cfg, batch, 1, rank)
                 + _head_working_set(cfg, batch, 1)) / 2**20
    total = weights_mb + adapters_mb + kv_mb + decode_mb + RUNTIME_MB
    return {"weights_mb": weights_mb, "adapters_mb": adapters_mb,
            "kv_mb": kv_mb, "decode_mb": decode_mb,
            "runtime_mb": RUNTIME_MB, "total_mb": total}
