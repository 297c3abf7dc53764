"""Telemetry runtime: structured metrics, typed events, trace spans
(``repro.telemetry``).

:class:`Telemetry` is the one object threaded through the trainer, resilient
loop and guard.  Disabled (the default) it is a frozen shell: ``enabled`` is
False, ``span()`` returns the shared no-op singleton, and ``emit()`` returns
immediately — the hot step path pays one attribute check and nothing else.
Enabled, it owns

* a :class:`~repro_torch.telemetry.metrics.MetricRegistry` (counters /
  gauges / histograms),
* event sinks (in-memory always; JSONL under ``--telemetry-dir``),
* a :class:`~repro_torch.telemetry.spans.Tracer` with Chrome-trace export,
  and
* optional ``torch.profiler`` capture (``--profile on``), exported as a
  Chrome trace under ``<telemetry-dir>/profile``.

Every registry also adopts the kernel autotuner's module-global counters
(``kernels/autotune.py``'s ``autotune.*``: cache hits and misses, sweeps
and their candidates), as the reference's does.

The module also hosts the structured *console* logging choke point
(:func:`log_step`, :func:`log_run_summary`) — both respect ``--quiet``.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional

from repro_torch.telemetry import events as ev
from repro_torch.telemetry import spans as sp
from repro_torch.telemetry.events import (AdmissionEvent, CheckpointEvent,
                                    DegradeEvent, FaultEvent, GuardEvent,
                                    RunEvent, SCHEMA_VERSION, StepEvent,
                                    WatermarkEvent)
from repro_torch.telemetry.memwatch import MemoryWatermark
from repro_torch.telemetry.metrics import (Counter, CounterGroup, Gauge, Histogram,
                                     MetricRegistry)
from repro_torch.telemetry.spans import NULL_SPAN, Tracer

__all__ = [
    "Telemetry", "DISABLED", "MemoryWatermark", "MetricRegistry",
    "CounterGroup", "Counter", "Gauge", "Histogram", "Tracer", "NULL_SPAN",
    "SCHEMA_VERSION", "RunEvent", "StepEvent", "FaultEvent", "DegradeEvent",
    "GuardEvent", "AdmissionEvent", "CheckpointEvent", "WatermarkEvent",
    "log_step", "log_run_summary",
]

log = logging.getLogger("repro_torch.train")


class Telemetry:
    """Event emitter + metric registry + tracer for one run."""

    def __init__(self, enabled: bool = True, out_dir: Optional[str] = None,
                 worker: Optional[int] = None, profile: bool = False,
                 sinks: Optional[list] = None):
        self.enabled = enabled
        self.out_dir = out_dir
        self.worker = worker
        self.registry = MetricRegistry()
        self.tracer = Tracer(enabled=enabled)
        self._seq = 0
        self.sinks: list = []
        self._profiling = None        # the running torch.profiler capture
        if not enabled:
            return
        self.memory_sink = ev.MemorySink()
        self.sinks = list(sinks) if sinks is not None else [self.memory_sink]
        if sinks is not None and not any(
                isinstance(s, ev.MemorySink) for s in self.sinks):
            self.memory_sink = None  # caller opted out of in-memory capture
        if out_dir:
            name = ("events.jsonl" if worker is None
                    else f"worker_{worker}.jsonl")
            self.sinks.append(ev.JsonlSink(os.path.join(out_dir, name)))
        if profile and out_dir:
            self._profiling = sp.start_profiler(
                os.path.join(out_dir, "profile"))
        # the autotuner's counters are module-global (kernel dispatch cannot
        # depend on a run-scoped object): adopt them so that snapshots
        # include the cache traffic
        from repro_torch.kernels import autotune
        self.registry.register_group(autotune.COUNTERS)

    @classmethod
    def from_spec(cls, spec, worker: Optional[int] = None) -> "Telemetry":
        """Build from TrainSpec telemetry fields."""
        enabled = getattr(spec, "telemetry", "off") == "on"
        if not enabled:
            return DISABLED
        out_dir = getattr(spec, "telemetry_dir", "") or os.path.join(
            spec.ckpt_dir, "telemetry")
        return cls(enabled=True, out_dir=out_dir, worker=worker,
                   profile=getattr(spec, "profile", "off") == "on")

    # ------------------------------------------------------------ emission
    def emit(self, event) -> None:
        if not self.enabled:
            return
        rec = ev.to_record(event, seq=self._seq, worker=self.worker)
        self._seq += 1
        for s in self.sinks:
            s.emit(rec)

    def span(self, name: str):
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name)

    # ------------------------------------------------------------- queries
    def events(self, kind: Optional[str] = None) -> List[dict]:
        """In-memory records (empty when disabled or memory sink opted out)."""
        sink = getattr(self, "memory_sink", None)
        if sink is None:
            return []
        if kind is None:
            return list(sink.records)
        return [r for r in sink.records if r.get("kind") == kind]

    def counts_by_kind(self) -> dict:
        out: dict = {}
        for r in self.events():
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out

    # ------------------------------------------------------------ shutdown
    def close(self) -> None:
        if not self.enabled:
            return
        if self._profiling is not None:
            sp.stop_profiler(self._profiling)
            self._profiling = None
        if self.out_dir and self.tracer.finished:
            # one trace a rank where ranks share the directory
            name = ("trace.json" if self.worker is None
                    else f"trace_{self.worker}.json")
            self.tracer.save(os.path.join(self.out_dir, name))
        for s in self.sinks:
            s.close()


#: module-level disabled singleton — safe default for every integration point
DISABLED = Telemetry(enabled=False)


# ----------------------------------------------------- console choke point
def log_step(res, interval: int, quiet: bool = False) -> None:
    """The single console step-log path."""
    if quiet:
        return
    if interval > 0 and res.step % interval == 0:
        log.info("step %5d loss %.4f %.3fs/step",
                 res.step, float(res.loss), res.seconds)


def log_run_summary(result, quiet: bool = False) -> None:
    """End-of-run console summary."""
    if quiet:
        return
    hist = getattr(result, "history", None)
    if hist:
        log.info("done: final loss %.4f over %d steps",
                 float(hist[-1].loss), len(hist))
    counters = getattr(result, "fault_counts", None) or {}
    nonzero = {k: v for k, v in counters.items() if v}
    if nonzero:
        log.info("faults survived: %s", nonzero)
    degr = getattr(result, "degradations", None)
    if degr:
        log.info("degraded %d time(s): %s", len(degr), " -> ".join(degr))
    metrics = getattr(result, "metrics", None) or {}
    wm = metrics.get("watermark")
    if wm and wm.get("measured_peak_mb"):
        log.info("memory watermark: measured peak %.1f MB of 2**20 bytes "
                 "(predicted %.1f MB, ratio %.2f, source=%s)",
                 wm["measured_peak_mb"], wm["predicted_peak_mb"],
                 wm["ratio"], wm["source"])
