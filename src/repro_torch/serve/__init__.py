"""Multi-tenant LoRA serving: adapter store, KV page ledger, continuous
batcher."""
from .loop import ContinuousBatcher, Request
from .paged import PagedKVAllocator
from .store import AdapterStore, StoreFull, synthetic_adapters

__all__ = ["AdapterStore", "ContinuousBatcher", "PagedKVAllocator",
           "Request", "StoreFull", "synthetic_adapters"]
