"""ExecutionPolicy: which implementation the model's ops run on, and where.

* ``backend``:
    - ``structured``: plain PyTorch, the forwards of ``core/structured.py``
      (the counterpart of the reference's ``structured`` backend);
    - ``cuda``: the kernels written by hand for Hopper in ``kernels/``
      (the counterpart of ``pallas``). A tensor on the CPU takes each
      kernel's plain version; a CUDA tensor launches the kernel or raises.
* ``device``: where parameters, caches and inputs are made.
"""
from __future__ import annotations

import dataclasses

import torch

#: valid ``backend`` values
BACKENDS = ("structured", "cuda")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    backend: str = "structured"
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        object.__setattr__(self, "device", torch.device(self.device))


STRUCTURED = ExecutionPolicy()
