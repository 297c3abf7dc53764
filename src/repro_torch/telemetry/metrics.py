"""Metric primitives: counters, gauges, histograms, and the registry
(``repro.telemetry.metrics``, the port's own copy).

This module is dependency-free (no torch, nothing of the port) so every
layer can keep counters here without import cycles.

Two organizing ideas:

* A :class:`CounterGroup` is an *ordered, dict-compatible* bundle of counters
  under one namespace ("serve", "store", "pages"); call sites use it as the
  plain dict it stands for (``dict(x.counters)``, ``c.update({k: 0 for k in
  c})``, ``c["admitted"] += 1``).

* A :class:`MetricRegistry` unifies groups plus free-standing namespaced
  counters/gauges/histograms into one flat ``snapshot()`` — e.g.
  ``{"serve.admitted": 3, "store.hits": 7, "guard.loss_ewma": 2.1}``.
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import Dict, Iterable, Iterator


class Counter:
    """Monotonic-by-convention integer counter (reset via ``value = 0``)."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Counter({self.value})"


class Gauge:
    """Last-write-wins scalar (EWMAs, watermarks, queue depths)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Gauge({self.value})"


class Histogram:
    """Bounded-memory streaming summary: count/sum/min/max plus log2 buckets.

    ``record`` is O(1) and allocation-free after construction; ``summary()``
    is what lands in snapshots and the JSONL run footer.
    """

    __slots__ = ("count", "total", "min", "max", "_buckets")

    #: bucket upper bounds (seconds-ish scale); last bucket is +inf
    BOUNDS = (0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 16.0, 64.0)

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._buckets = [0] * (len(self.BOUNDS) + 1)

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for i, bound in enumerate(self.BOUNDS):
            if v <= bound:
                self._buckets[i] += 1
                return
        self._buckets[-1] += 1

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "mean": None}
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max,
                "mean": self.total / self.count,
                "buckets": dict(zip([str(b) for b in self.BOUNDS] + ["inf"],
                                    self._buckets))}


class CounterGroup(MutableMapping):
    """Ordered dict-compatible view over a namespace of :class:`Counter`.

    Behaves like the plain ``dict`` counters it replaces — iteration order is
    insertion order, values are ints, ``update``/``dict()``/``+=`` all work —
    while the underlying Counter objects can be shared with a registry.
    """

    __slots__ = ("name", "_counters")

    def __init__(self, name: str, keys: Iterable[str] = ()):
        self.name = name
        self._counters: Dict[str, Counter] = {}
        for k in keys:
            self._counters[k] = Counter()

    def counter(self, key: str) -> Counter:
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    # --- MutableMapping protocol (int-valued, like the old plain dicts) ----
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

    def __repr__(self):  # pragma: no cover - debug aid
        return f"CounterGroup({self.name!r}, {dict(self)})"

    def namespaced(self) -> Dict[str, int]:
        return {f"{self.name}.{k}": c.value for k, c in self._counters.items()}


class MetricRegistry:
    """One flat namespace of groups + free-standing metrics.

    Names are dotted (``"train.steps"``, ``"guard.loss_ewma"``); groups
    registered via :meth:`register_group` contribute ``<group>.<key>`` rows
    to :meth:`snapshot`.
    """

    def __init__(self):
        self._groups: Dict[str, CounterGroup] = {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # --- groups ------------------------------------------------------------
    def register_group(self, group: CounterGroup) -> CounterGroup:
        """Adopt an externally-created group (idempotent; name keyed)."""
        self._groups[group.name] = group
        return group

    def group(self, name: str, keys: Iterable[str] = ()) -> CounterGroup:
        g = self._groups.get(name)
        if g is None:
            g = self._groups[name] = CounterGroup(name, keys)
        else:
            for k in keys:
                g.counter(k)
        return g

    # --- free-standing metrics --------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    # --- snapshot ----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Flat ``{dotted_name: value}``; histograms appear as summaries."""
        out: Dict[str, object] = {}
        for g in self._groups.values():
            out.update(g.namespaced())
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._histograms.items():
            out[name] = h.summary()
        return out
