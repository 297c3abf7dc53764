"""Nested wall-clock trace spans with Chrome-trace/Perfetto export
(``repro.telemetry.spans``).

A :class:`Tracer` records complete ("ph": "X") spans; nesting comes from the
enter/exit timing, which Perfetto and chrome://tracing reconstruct into a
flame view.  Disabled tracing costs nothing: :data:`NULL_SPAN` is one shared
no-op context manager, so ``tracer.span(...)`` on a disabled tracer
allocates no objects.

``torch.profiler`` start/stop hooks live here too (behind ``--profile``, in
place of the reference's ``jax.profiler``): CPU activity always, CUDA
activity when a card is visible, and the capture exported as a Chrome trace
(``trace.json``) under the profile directory on stop. They never fail the
run: a profiler that cannot start or export is logged and skipped.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import List, Optional

log = logging.getLogger("repro_torch.telemetry")


class _NullSpan:
    """Shared no-op context manager (singleton: :data:`NULL_SPAN`)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One live span; records itself on the tracer at ``__exit__``."""

    __slots__ = ("tracer", "name", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name
        self.t0 = 0.0
        self.depth = 0

    def __enter__(self):
        tr = self.tracer
        self.depth = len(tr._stack)
        tr._stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        tr = self.tracer
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        tr.finished.append((self.name, self.t0 - tr.epoch, dur, self.depth))
        return False


class Tracer:
    """Collects finished spans as ``(name, start_s, dur_s, depth)`` tuples
    relative to the tracer's epoch."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.epoch = time.perf_counter()
        self.finished: List[tuple] = []
        self._stack: List[Span] = []

    def span(self, name: str):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name)

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> List[dict]:
        """Chrome trace event format: complete events, µs timestamps."""
        pid = os.getpid()
        tid = threading.get_ident() % 10_000
        return [{"name": name, "ph": "X", "ts": round(start * 1e6, 1),
                 "dur": round(dur * 1e6, 1), "pid": pid, "tid": tid,
                 "args": {"depth": depth}}
                for name, start, dur, depth in self.finished]

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.chrome_trace(),
                       "displayTimeUnit": "ms"}, fh)
        return path

    def totals(self) -> dict:
        """Per-name aggregate {count, total_s} — cheap summary for reports."""
        agg: dict = {}
        for name, _start, dur, _depth in self.finished:
            row = agg.setdefault(name, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += dur
        return agg


NULL_TRACER = Tracer(enabled=False)


# --------------------------------------------------------- torch.profiler
def start_profiler(log_dir: str) -> Optional[tuple]:
    """Start a ``torch.profiler`` capture (CPU, and CUDA when a card is
    visible); returns the handle :func:`stop_profiler` takes, or None when
    the profiler did not start."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:  # pragma: no cover - platform dependent
        log.warning("torch.profiler did not start: %s", e)
        return None
    return prof, log_dir


def stop_profiler(handle: tuple) -> Optional[str]:
    """Stop the capture ``handle`` and export it as a Chrome trace
    (``trace.json`` in its log directory); returns the trace's path, or
    None when it could not be exported."""
    prof, log_dir = handle
    try:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        return path
    except Exception as e:  # pragma: no cover - platform dependent
        log.warning("torch.profiler capture not exported: %s", e)
        return None
