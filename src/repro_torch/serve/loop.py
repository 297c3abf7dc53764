"""Continuous-batching multi-tenant decode loop (the port of
``repro.serve.loop``).

Batch layout: ``slots`` decode rows in tiles of ``tile`` consecutive rows.
Each tile is bound to at most one resident adapter slot; the int32
``[n_tiles]`` routing vector lives on the device and the grouped LoRA
kernel reads each tile's slot there, so admission, recycling and re-binding
change data only: the host never reads it back and nothing is specialised
on its values (the counterpart of the reference's scalar prefetch, where
re-routing never recompiles).

Scheduling is step-granular: at each step the admission pass (FIFO with
skip-ahead) places queued requests into compatible tiles, then one decode
step advances every active row. Prompt rows consume their next prompt
token (prefill-as-decode), generation rows feed back their last sampled
token. Finished rows recycle at once: pages go back to the allocator, the
adapter pin drops, and an emptied tile unbinds.

Admission gates, in the reference's order: a compatible tile, room in the
adapter store, KV pages for ``len(prompt) + max_new``. The reference's
optional memory-headroom gate (``mem_budget_mb``) needs its memory
simulator and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.models import model as model_lib
from repro_torch.serve.paged import PagedKVAllocator
from repro_torch.serve.store import AdapterStore, StoreFull
from repro_torch.telemetry.metrics import CounterGroup, MetricRegistry


@dataclasses.dataclass(frozen=True)
class Request:
    rid: str                  #: unique request id
    adapter: str              #: tenant/adapter uid (AdapterStore key)
    prompt: Tuple[int, ...]   #: prompt token ids (fed prefill-as-decode)
    max_new: int              #: tokens to generate after the prompt


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pending: List[int] = dataclasses.field(default_factory=list)
    last: int = 0
    out: List[int] = dataclasses.field(default_factory=list)


@torch.no_grad()
def _reset_slot(cache, b: int) -> None:
    """Zero slot ``b``'s rows in every stacked ``[L, B, ...]`` cache leaf,
    in place, so nothing leaks from the row's previous occupant."""
    for leaf in cache["blocks"].values():
        leaf[:, b].zero_()


class ContinuousBatcher:
    """Multi-tenant continuous-batching decoder over an AdapterStore.

    ``register_adapter`` publishes a tenant's (A, B) tree to the host-side
    registry; the store pulls it into residency on first admission and
    LRU-evicts it when unpinned and cold.
    """

    def __init__(self, cfg, store: AdapterStore, *, slots: int = 8,
                 tile: int = 2, max_len: int = 128, page_size: int = 16,
                 policy: ExecutionPolicy = STRUCTURED,
                 mem_budget_mb: Optional[float] = None):
        if slots % tile:
            raise ValueError(f"slots ({slots}) must be a multiple of the "
                             f"tile size ({tile})")
        if mem_budget_mb is not None:
            raise NotImplementedError(
                "the mem_budget_mb headroom gate needs the memory simulator, "
                "which the port has not ported yet")
        self.cfg = cfg
        self.store = store
        self.slots = slots
        self.tile = tile
        self.n_tiles = slots // tile
        self.max_len = max_len
        self.policy = policy
        self.device = policy.device
        self.cache = model_lib.init_cache(cfg, slots, max_len,
                                          device=self.device)
        self.alloc = PagedKVAllocator(slots * max_len // page_size, page_size)
        self.tile_adapter: List[Optional[str]] = [None] * self.n_tiles
        self.tile_gid = np.zeros(self.n_tiles, np.int32)
        self._tile_gid_dev = torch.zeros(self.n_tiles, dtype=torch.int32,
                                         device=self.device)
        self._rows = [_Slot() for _ in range(slots)]
        self._registry: Dict[str, object] = {}
        self.queue: List[Request] = []
        self.results: Dict[str, List[int]] = {}
        #: logits [slots, 1, V] of the latest decode step
        self.last_logits: Optional[torch.Tensor] = None
        self.counters = CounterGroup(
            "serve", ("admitted", "completed", "steps", "prefill_tokens",
                      "decoded_tokens", "rejected_pages",
                      "rejected_headroom", "rejected_tiles",
                      "rejected_store"))
        self.registry = MetricRegistry()
        self.registry.register_group(self.counters)
        self.registry.register_group(self.store.counters)
        self.registry.register_group(self.alloc.counters)

    # -- tenant registry ----------------------------------------------------

    def register_adapter(self, uid: str, adapters) -> None:
        self._registry[uid] = adapters

    def metrics(self) -> Dict[str, int]:
        """Namespaced snapshot: serve.* / store.* / pages.*."""
        return self.registry.snapshot()

    def _reject(self, req: Request, reason: str) -> bool:
        self.counters[f"rejected_{reason}"] += 1
        return False

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(f"request {req.rid!r} needs "
                             f"{len(req.prompt) + req.max_new} tokens but "
                             f"max_len is {self.max_len}")
        if req.adapter not in self._registry:
            raise KeyError(f"adapter {req.adapter!r} not registered")
        self.queue.append(req)

    def _tile_rows(self, t: int) -> range:
        return range(t * self.tile, (t + 1) * self.tile)

    def _find_tile(self, uid: str) -> Optional[int]:
        for t, bound in enumerate(self.tile_adapter):
            if bound == uid and any(self._rows[b].req is None
                                    for b in self._tile_rows(t)):
                return t
        for t, bound in enumerate(self.tile_adapter):
            if bound is None:
                return t
        return None

    def _try_place(self, req: Request) -> bool:
        t = self._find_tile(req.adapter)
        if t is None:
            return self._reject(req, "tiles")
        if not self.store.can_admit(req.adapter):
            return self._reject(req, "store")
        total = len(req.prompt) + req.max_new
        if not self.alloc.reserve(req.rid, total):
            return self._reject(req, "pages")
        try:
            slot = self.store.acquire(req.adapter,
                                      self._registry[req.adapter])
        except StoreFull:
            self.alloc.free(req.rid)
            return self._reject(req, "store")
        if self.tile_adapter[t] is None:
            self.tile_adapter[t] = req.adapter
        self.tile_gid[t] = slot
        b = next(i for i in self._tile_rows(t) if self._rows[i].req is None)
        _reset_slot(self.cache, b)
        self._rows[b] = _Slot(req=req, pending=list(req.prompt))
        self.counters["admitted"] += 1
        return True

    def _admit(self) -> None:
        still = []
        for req in self.queue:          # FIFO with skip-ahead
            if not self._try_place(req):
                still.append(req)
        self.queue = still

    def _recycle(self, b: int) -> None:
        row = self._rows[b]
        self.alloc.free(row.req.rid)
        self.store.release(row.req.adapter)
        self.results[row.req.rid] = row.out
        self._rows[b] = _Slot()
        t = b // self.tile
        if all(self._rows[i].req is None for i in self._tile_rows(t)):
            self.tile_adapter[t] = None   # adapter now evictable
        self.counters["completed"] += 1

    # -- decode -------------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(r.req is not None for r in self._rows)

    def step(self) -> bool:
        """Admit, then advance every active row by one token. Returns False
        when there is nothing to do (no active rows, empty queue)."""
        self._admit()
        if self.active == 0:
            return False
        toks = np.zeros((self.slots, 1), np.int64)
        for b, row in enumerate(self._rows):
            if row.req is not None:
                toks[b, 0] = row.pending[0] if row.pending else row.last
        self._tile_gid_dev.copy_(torch.from_numpy(self.tile_gid))
        logits, self.cache = model_lib.decode_step(
            self.store.params, self.cfg, self.cache,
            torch.from_numpy(toks).to(self.device), policy=self.policy,
            adapter_tiles=self._tile_gid_dev)
        self.last_logits = logits
        nxt = logits[:, 0].argmax(-1).cpu().numpy()
        self.counters["steps"] += 1
        done = []
        for b, row in enumerate(self._rows):
            if row.req is None:
                continue
            if row.pending:
                row.pending.pop(0)
                self.counters["prefill_tokens"] += 1
                if row.pending:
                    continue          # still prefilling; logits unused
            row.last = int(nxt[b])
            row.out.append(row.last)
            self.counters["decoded_tokens"] += 1
            if len(row.out) >= row.req.max_new:
                done.append(b)
        for b in done:
            self._recycle(b)
        return True

    def run(self, requests: Sequence[Request] = (),
            max_steps: int = 100_000) -> Dict[str, List[int]]:
        """Drain ``requests`` (plus anything already queued or active);
        returns {rid: generated tokens} of all completions so far."""
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            if not self.step():
                break
        if self.queue or self.active:
            raise RuntimeError(
                f"serve loop stalled: {len(self.queue)} queued, "
                f"{self.active} active after {self.counters['steps']} steps "
                f"(requests too large for the slot/page budget?)")
        return self.results
