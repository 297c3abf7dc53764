"""PyTorch/CUDA port of the MeSP reproduction (``src/repro`` is the JAX
reference and stays as it is).

This package imports ``torch``, numpy and the standard library only: never
``jax`` and nothing of ``repro``. The module layout mirrors ``repro/``, so
each module's counterpart sits at the same path there.

Ported so far: the multi-tenant LoRA serving path of a dense model
(``repro_torch.launch.serve``) and the MeSP training step of that model
(``repro_torch.launch.train``) at any sequence length, over a bf16 or a
quantized (int8, packed int4 / nf4) frozen base, with the grouped-LoRA,
LoRA forward / dx / dA-dB (dense and quantized), RMSNorm forward / backward
and flash-attention kernels written by hand in CUDA for Hopper
(``repro_torch/csrc``). The training launcher runs through the
reference's runtime: ``TrainSpec`` and the ``Trainer`` (``api/``), atomic
checkpoints (``checkpoint/``), fault injection, the step guard, the
degradation ladder and the resilient loop (``runtime/``), and telemetry
(``telemetry/``).
"""
