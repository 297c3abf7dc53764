"""Bounded multi-tenant adapter residency (the port of
``repro.serve.store``).

An :class:`AdapterStore` owns the stacked serving parameter tree: every
LoRA pair of the base model is widened to ``a: [..., R, d_in, r]`` /
``b: [..., R, r, d_out]`` for ``R = capacity`` resident slots, with the
tenant axis inserted just before the trailing matrix dims (after the layer
axis), while the frozen leaves (``w``, biases, norms, embeddings) are the
base model's own tensors, shared by all tenants. Residency is LRU with
pinning: a slot in use by a running request is never evicted.

Slot writes copy into the stacked tensors in place (under
``torch.no_grad``), so the decode step reads new adapters through the same
tensors and nothing is re-made on admission.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.telemetry.metrics import CounterGroup
from repro_torch.tree import leaves_with_paths, path_str, tree_map_with_path


class StoreFull(RuntimeError):
    """Insert needed but every resident slot is pinned by a live request."""


def _adapter_leaves(tree) -> Dict[str, torch.Tensor]:
    """Path-keyed LoRA leaves (final key 'a' or 'b') of a parameter tree."""
    return {path_str(p): leaf for p, leaf in leaves_with_paths(tree)
            if p and p[-1] in ("a", "b")}


def synthetic_adapters(params, seed: int, scale: float = 0.05):
    """Deterministic per-tenant (A, B) tree for demos and benchmarks: every
    LoRA leaf redrawn as ``scale · N(0, 1)`` from
    ``np.random.default_rng(seed)`` in path-sorted order (B nonzero, so
    tenants give different deltas); other leaves pass through. The numbers
    differ from the reference's ``jax.random`` draws."""
    rng = np.random.default_rng(seed)
    leaves = _adapter_leaves(params)
    drawn = {p: torch.from_numpy(
        (scale * rng.standard_normal(tuple(leaves[p].shape))
         ).astype(np.float32)).to(leaves[p].device, leaves[p].dtype)
        for p in sorted(leaves)}
    return tree_map_with_path(lambda p, leaf: drawn.get(path_str(p), leaf),
                              params)


class AdapterStore:
    """LRU-bounded resident set of per-tenant LoRA (A, B) pairs.

    ``params``: the base model tree (its own a/b values are not served:
    slots start zeroed, i.e. identity deltas). ``capacity``: resident
    tenants R.
    """

    def __init__(self, params, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._paths = set(_adapter_leaves(params))
        if not self._paths:
            raise ValueError("base params carry no LoRA (a, b) leaves")
        if any("moe" in p for p in self._paths):
            raise ValueError(
                "multi-tenant AdapterStore does not support per-expert MoE "
                "adapters; serve dense/vlm archs")

        def widen(path, p):
            if path and path[-1] in ("a", "b"):
                return torch.zeros((*p.shape[:-2], capacity, *p.shape[-2:]),
                                   dtype=p.dtype, device=p.device)
            return p

        self.params = tree_map_with_path(widen, params)
        self._stacked = _adapter_leaves(self.params)
        self._slot_of: "OrderedDict[str, int]" = OrderedDict()  # LRU order
        self._free = list(range(capacity - 1, -1, -1))          # pop() -> 0,1,..
        self._pins: Dict[str, int] = {}
        self.counters = CounterGroup(
            "store", ("hits", "misses", "evictions", "inserts"))

    # -- byte accounting ----------------------------------------------------

    @property
    def slot_bytes(self) -> int:
        """Bytes one resident adapter occupies (its a/b leaves)."""
        return sum(t.numel() // self.capacity * t.element_size()
                   for t in self._stacked.values())

    @property
    def allocated_bytes(self) -> int:
        return self.slot_bytes * self.capacity

    @property
    def resident(self) -> int:
        return len(self._slot_of)

    def pinned(self, uid: str) -> bool:
        return self._pins.get(uid, 0) > 0

    # -- residency ----------------------------------------------------------

    def lookup(self, uid: str) -> Optional[int]:
        return self._slot_of.get(uid)

    def can_admit(self, uid: str) -> bool:
        """Would :meth:`acquire` succeed without raising StoreFull?"""
        return (uid in self._slot_of or bool(self._free)
                or any(not self.pinned(u) for u in self._slot_of))

    def acquire(self, uid: str, adapters=None, *, pin: bool = True) -> int:
        """Slot of ``uid``, inserting (and LRU-evicting) on a miss.
        ``adapters``: a tree holding the tenant's a/b leaves at the base
        model's paths (a full parameter tree works); needed on a miss."""
        slot = self._slot_of.get(uid)
        if slot is not None:
            self.counters["hits"] += 1
            self._slot_of.move_to_end(uid)
        else:
            self.counters["misses"] += 1
            if adapters is None:
                raise KeyError(f"adapter {uid!r} not resident and no "
                               "adapter tree supplied")
            slot = self._insert(uid, adapters)
        if pin:
            self._pins[uid] = self._pins.get(uid, 0) + 1
        return slot

    def release(self, uid: str) -> None:
        n = self._pins.get(uid, 0)
        if n <= 1:
            self._pins.pop(uid, None)
        else:
            self._pins[uid] = n - 1

    @torch.no_grad()
    def _insert(self, uid: str, adapters) -> int:
        leaves = _adapter_leaves(adapters)
        missing = self._paths - set(leaves)
        if missing:
            raise ValueError(f"adapter {uid!r} missing LoRA leaves: "
                             f"{sorted(missing)}")
        if self._free:
            slot = self._free.pop()
        else:
            victim = next((u for u in self._slot_of if not self.pinned(u)),
                          None)
            if victim is None:
                raise StoreFull(
                    f"all {self.capacity} resident adapters are pinned")
            slot = self._slot_of.pop(victim)
            self.counters["evictions"] += 1
        for path, stacked in self._stacked.items():
            stacked[..., slot, :, :].copy_(leaves[path])
        self._slot_of[uid] = slot
        self.counters["inserts"] += 1
        return slot
