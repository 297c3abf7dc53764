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
adapter store, the optional memory headroom (``mem_budget_mb`` against
``serve/residency.serve_residency``: the base in its own format, the
resident adapters, the live KV pages and the decode working set, a model
and not a measurement), KV pages for ``len(prompt) + max_new``.

With a ``telemetry`` object (``repro_torch.telemetry.Telemetry``) the
batcher registers its counters in the telemetry's registry, emits an
``AdmissionEvent`` on every admit, reject and completion, and wraps the
admission pass and each step in spans ("admission", and "prefill" or
"decode" by what the step mostly served), as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.policy import STRUCTURED, ExecutionPolicy
from repro_torch.core import quant
from repro_torch.models import model as model_lib
from repro_torch.serve.paged import PagedKVAllocator
from repro_torch.serve.residency import serve_residency
from repro_torch.serve.store import AdapterStore, StoreFull
from repro_torch.telemetry import DISABLED as _NO_TELEMETRY
from repro_torch.telemetry import AdmissionEvent
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
    """Zero slot ``b``'s rows in every cache leaf, in place, so nothing
    leaks from the row's previous occupant. Stacked leaves (``[L, B, ...]``
    blocks, ``[n_groups, B, ...]`` per position of a window pattern's
    period) carry the slot axis at 1, an unstacked ``block0`` at 0, as in
    the reference."""
    def zero(tree, ax):
        if isinstance(tree, dict):
            for leaf in tree.values():
                zero(leaf, ax)
        else:
            tree.select(ax, b).zero_()

    for key, sub in cache.items():
        zero(sub, 0 if key == "block0" else 1)


class ContinuousBatcher:
    """Multi-tenant continuous-batching decoder over an AdapterStore.

    ``register_adapter`` publishes a tenant's (A, B) tree to the host-side
    registry; the store pulls it into residency on first admission and
    LRU-evicts it when unpinned and cold.

    ``mem_budget_mb``: admit only while the modelled resident set
    (``serve_residency`` with the base in ``policy.quantize``'s format and
    adapters of the config's rank) stays within it; None admits without
    the check. ``policy.quantize`` must be the store's base format
    (``quant.tree_method``), as ``mesp.value_and_grad`` holds it.
    """

    def __init__(self, cfg, store: AdapterStore, *, slots: int = 8,
                 tile: int = 2, max_len: int = 128, page_size: int = 16,
                 policy: ExecutionPolicy = STRUCTURED,
                 mem_budget_mb: Optional[float] = None, telemetry=None):
        if slots % tile:
            raise ValueError(f"slots ({slots}) must be a multiple of the "
                             f"tile size ({tile})")
        found = quant.tree_method(store.params)
        if found != policy.quantize:
            raise ValueError(f"the frozen base is {found!r} but "
                             f"policy.quantize is {policy.quantize!r}")
        self.cfg = cfg
        self.store = store
        self.slots = slots
        self.tile = tile
        self.n_tiles = slots // tile
        self.max_len = max_len
        self.policy = policy
        self.device = policy.device
        self.mem_budget_mb = mem_budget_mb
        self.weights_fmt = quant.weights_format(policy.quantize)
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
        self._tel = telemetry if telemetry is not None else _NO_TELEMETRY
        self.registry = (telemetry.registry if telemetry is not None
                         else MetricRegistry())
        self.registry.register_group(self.counters)
        self.registry.register_group(self.store.counters)
        self.registry.register_group(self.alloc.counters)

    # -- tenant registry ----------------------------------------------------

    def register_adapter(self, uid: str, adapters) -> None:
        self._registry[uid] = adapters

    def metrics(self) -> Dict[str, int]:
        """Namespaced snapshot: serve.* / store.* / pages.*."""
        return self.registry.snapshot()

    def _event(self, action: str, req: Request, reason: str = "") -> None:
        if self._tel.enabled:
            self._tel.emit(AdmissionEvent(
                action=action, rid=req.rid, adapter=req.adapter,
                reason=reason, step=self.counters["steps"]))

    def _reject(self, req: Request, reason: str) -> bool:
        self.counters[f"rejected_{reason}"] += 1
        self._event("reject", req, reason)
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

    def _headroom_ok(self, extra_adapter: bool, extra_tokens: int) -> bool:
        """Would the modelled resident set, with one more adapter (if it is
        not resident) and the pages of ``extra_tokens``, fit the budget?"""
        if self.mem_budget_mb is None:
            return True
        resident = min(self.store.resident + (1 if extra_adapter else 0),
                       self.store.capacity)
        pages = self.alloc.used_pages + self.alloc.pages_for(extra_tokens)
        r = serve_residency(
            self.cfg, rank=self.cfg.lora.rank, resident_adapters=resident,
            kv_pages=pages, page_size=self.alloc.page_size,
            batch=self.slots, weights_fmt=self.weights_fmt)
        return r["total_mb"] <= self.mem_budget_mb

    def _try_place(self, req: Request) -> bool:
        t = self._find_tile(req.adapter)
        if t is None:
            return self._reject(req, "tiles")
        if not self.store.can_admit(req.adapter):
            return self._reject(req, "store")
        total = len(req.prompt) + req.max_new
        if not self._headroom_ok(
                self.store.lookup(req.adapter) is None, total):
            return self._reject(req, "headroom")
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
        self._event("admit", req)
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
        self._event("complete", row.req)

    # -- decode -------------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(r.req is not None for r in self._rows)

    def _decode(self, toks):
        """One decode step over every slot: the logits; the cache kept."""
        logits, self.cache = model_lib.decode_step(
            self.store.params, self.cfg, self.cache,
            torch.from_numpy(toks).to(self.device), policy=self.policy,
            adapter_tiles=self._tile_gid_dev)
        return logits

    def step(self) -> bool:
        """Admit, then advance every active row by one token. Returns False
        when there is nothing to do (no active rows, empty queue)."""
        tel = self._tel
        if tel.enabled:
            with tel.span("admission"):
                self._admit()
        else:
            self._admit()
        if self.active == 0:
            return False
        toks = np.zeros((self.slots, 1), np.int64)
        for b, row in enumerate(self._rows):
            if row.req is not None:
                toks[b, 0] = row.pending[0] if row.pending else row.last
        self._tile_gid_dev.copy_(torch.from_numpy(self.tile_gid))
        if tel.enabled:
            # prefill runs through the same step (prefill-as-decode); the
            # span name records which phase this step mostly served
            prefilling = any(r.req is not None and r.pending
                             for r in self._rows)
            with tel.span("prefill" if prefilling else "decode"):
                logits = self._decode(toks)
        else:
            logits = self._decode(toks)
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
