"""ExecutionPolicy: which implementation the model's ops run on, and where.

* ``backend``:
    - ``structured``: the hand-derived autograd Functions of
      ``core/structured.py`` (MeSP: h recomputed; the counterpart of the
      reference's ``structured`` backend);
    - ``cuda``: the same rules through the kernels written by hand for
      Hopper in ``kernels/`` (the counterpart of ``pallas``). A tensor on
      the CPU takes each kernel's plain version; a CUDA tensor launches the
      kernel or raises;
    - ``plain``: autograd of plain forwards (the MeBP baseline);
    - ``store_h``: MeSP with ``h = x @ A`` saved (paper Table 5 ablation).
* ``quantize``: the frozen base's format, one of ``core.quant.METHODS``
  ("none", "int8", "int4", "nf4"), as ``init_params(quantize=)`` made it.
  The ops dispatch on the weight leaves themselves; ``mesp.value_and_grad``
  raises when the params' leaves hold another format, so a run cannot
  train a base other than the one it asked for.
* ``device``: where parameters, caches and inputs are made.
* ``flash_min_seq``: the sequence length from which the ``structured``
  and ``store_h`` backends take the chunked flash path (``core/flash.py``)
  in place of the dense sdpa; ``flash_chunk``: its q/k chunk. The ``cuda``
  backend runs the flash kernels from 64 query rows whatever these say.
* ``remat``: recompute each block in the backward from its stored input
  (``torch.utils.checkpoint`` per block, the paper's §4.3 schedule).
* ``fuse_rope``: ``cuda`` backend only: rotate q and k inside the flash
  kernels (the [N, D/2] cos/sin tables are read per tile; the rotated q
  and k never reach device memory) instead of a separate RoPE pass. The
  gradients are the same; other backends ignore it, as the reference's
  backends other than ``pallas`` do.
* ``dp``: the data axis of a mesh (``runtime.elastic.DataParallel``) or
  None: each engine's step all-reduces its LoRA gradients and loss over
  it (``api/engines.py``, ``core/mesp.sequential_train_step``, the MeZO
  engines' two losses). The Trainer sets it; the model stack ignores it.
* ``tp``: the model axis of a mesh (``runtime.elastic.ModelParallel``) or
  None: the dense family's linears run on this rank's shards, with the
  Megatron collectives of ``models/parallel.py`` around them, and
  ``core/mesp.value_and_grad`` sums the partial LoRA gradients over it.
* ``sp``: with ``tp``, Megatron sequence parallelism: the activations
  between blocks (and every norm) hold this rank's part of the sequence.
  The Trainer derives it (the sequence divides over the model axis).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import METHODS

#: valid ``backend`` values
BACKENDS = ("structured", "cuda", "plain", "store_h")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    backend: str = "structured"
    quantize: str = "none"
    device: torch.device = torch.device("cpu")
    flash_min_seq: int = 1024
    flash_chunk: int = 1024
    remat: bool = True
    fuse_rope: bool = False
    dp: Optional[object] = None
    tp: Optional[object] = None
    sp: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.quantize not in METHODS:
            raise ValueError(f"unknown quantize method {self.quantize!r}; "
                             f"expected one of {METHODS}")
        object.__setattr__(self, "device", torch.device(self.device))
        if self.sp and self.tp is None:
            raise ValueError("sequence parallelism (sp) needs a model axis "
                             "(tp)")


STRUCTURED = ExecutionPolicy()
PLAIN = ExecutionPolicy(backend="plain")
