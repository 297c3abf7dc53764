"""PyTorch/CUDA port of the MeSP reproduction (``src/repro`` is the JAX
reference and stays as it is).

This package imports ``torch``, numpy and the standard library only: never
``jax`` and nothing of ``repro``. The module layout mirrors ``repro/``, so
each module's counterpart sits at the same path there.

Ported so far: the multi-tenant LoRA serving path of a dense model
(``repro_torch.launch.serve``), with the grouped-LoRA and RMSNorm forward
kernels written by hand in CUDA for Hopper (``repro_torch/csrc``).
"""
