"""Counters of the serve loop (the port's copy of the parts of
``repro.telemetry.metrics`` that serving reads).

A :class:`CounterGroup` is an ordered, dict-compatible bundle of counters
under one namespace ("serve", "store", "pages"); a :class:`MetricRegistry`
joins groups into one flat ``snapshot()`` such as
``{"serve.admitted": 3, "store.hits": 7}``.
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import Dict, Iterable, Iterator


class Counter:
    """Integer counter (reset via ``value = 0``)."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value


class CounterGroup(MutableMapping):
    """Ordered dict-compatible view over a namespace of :class:`Counter`:
    ``c["admitted"] += 1``, ``dict(c)`` and ``c.update(...)`` all work."""

    __slots__ = ("name", "_counters")

    def __init__(self, name: str, keys: Iterable[str] = ()):
        self.name = name
        self._counters: Dict[str, Counter] = {k: Counter() for k in keys}

    def counter(self, key: str) -> Counter:
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self.counter(key).value = value

    def __delitem__(self, key: str) -> None:
        del self._counters[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self):
        return f"CounterGroup({self.name!r}, {dict(self)})"

    def namespaced(self) -> Dict[str, int]:
        return {f"{self.name}.{k}": c.value for k, c in self._counters.items()}


class MetricRegistry:
    """One flat dotted namespace over registered groups."""

    def __init__(self):
        self._groups: Dict[str, CounterGroup] = {}

    def register_group(self, group: CounterGroup) -> CounterGroup:
        """Adopt an externally created group (idempotent; keyed by name)."""
        self._groups[group.name] = group
        return group

    def snapshot(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for g in self._groups.values():
            out.update(g.namespaced())
        return out
