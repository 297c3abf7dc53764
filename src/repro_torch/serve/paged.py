"""Paged KV-cache accounting for the continuous-batching serve loop (the
port of ``repro.serve.paged``).

The physical decode cache is slot-dense (``model.init_cache(per_slot=True)``:
one ``[B, Hkv, S, D]`` buffer per layer and a per-slot length vector). This
allocator keeps the page ledger over it: a fixed pool of fixed-size token
pages, reserved per request at admission (prompt + max_new, so a running
request never runs out mid-decode) and returned at recycle. The dense
attention path reads only the ledger's counts; ``pages_of`` is the table a
gather-based paged-attention kernel would read.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.telemetry.metrics import CounterGroup


class PagedKVAllocator:
    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._owned: Dict[str, List[int]] = {}
        self.counters = CounterGroup(
            "pages", ("reserved", "freed", "peak_pages", "rejected"))

    def pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 0) // self.page_size)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def free_tokens(self) -> int:
        return len(self._free) * self.page_size

    def can_reserve(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= len(self._free)

    def reserve(self, owner: str, tokens: int) -> bool:
        """Reserve pages for ``tokens`` KV entries; False (and a
        ``rejected`` count) when the pool cannot cover them."""
        if owner in self._owned:
            raise KeyError(f"owner {owner!r} already holds pages")
        n = self.pages_for(tokens)
        if n > len(self._free):
            self.counters["rejected"] += 1
            return False
        self._owned[owner] = [self._free.pop() for _ in range(n)]
        self.counters["reserved"] += n
        self.counters["peak_pages"] = max(self.counters["peak_pages"],
                                          self.used_pages)
        return True

    def free(self, owner: str) -> int:
        """Return ``owner``'s pages to the pool; count them as freed."""
        pages = self._owned.pop(owner, [])
        self._free.extend(reversed(pages))
        self.counters["freed"] += len(pages)
        return len(pages)

    def pages_of(self, owner: str) -> List[int]:
        return list(self._owned.get(owner, ()))
