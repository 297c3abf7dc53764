"""The port's engines (``repro.api.engines``): each is MeSP's
``value_and_grad`` under one :class:`~repro_torch.api.ExecutionPolicy`
backend.

* ``mesp``: the hand-derived structured backward (paper §4);
* ``mesp_cuda``: the same rules through the CUDA kernels (the reference's
  ``mesp_pallas``);
* ``mebp``: autograd of the plain forwards (paper §3.3 baseline);
* ``store_h``: MeSP with ``h = x @ A`` saved (paper Table 5 ablation).
"""
from __future__ import annotations

#: engine -> ExecutionPolicy backend
ENGINES = {"mesp": "structured", "mesp_cuda": "cuda", "mebp": "plain",
           "store_h": "store_h"}
