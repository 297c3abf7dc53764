"""Typed telemetry events, the JSONL wire schema, and sinks
(``repro.telemetry.events``; plain Python, the same schema field for field,
so ``scripts/telemetry_report.py`` reads the records of either package).

Wire format — one JSON object per line::

    {"v": 1, "ts": 1699999999.123, "kind": "step", "seq": 7,
     "worker": 0, ...kind-specific fields...}

``v`` is :data:`SCHEMA_VERSION`; ``ts`` is ``time.time()`` at emit;
``seq`` is the per-emitter monotone index (the deterministic tie-break for
shard merging); ``worker`` is present only on worker shards.

Event kinds are plain dataclasses registered in :data:`EVENT_TYPES`.
``to_record`` / ``from_record`` round-trip them losslessly, and
``validate_record`` is the schema check.

Note: :class:`FaultEvent` here is the *telemetry record* of a fault firing or
being handled; ``repro_torch.runtime.faults.FaultEvent`` is the *injection
plan entry*.  They are distinct types in distinct namespaces.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, IO, List, Optional, Sequence, Type

SCHEMA_VERSION = 1

#: record keys added by the emitter envelope, not by the event dataclass
ENVELOPE_KEYS = ("v", "ts", "kind", "seq", "worker")


@dataclasses.dataclass
class RunEvent:
    """Run lifecycle marker; ``phase="start"`` carries the spec manifest."""
    KIND = "run"
    phase: str = "start"            # start | end
    engine: str = ""
    quantize: str = ""
    arch: str = ""
    spec: Optional[dict] = None     # CLI-field manifest (start only)
    steps: int = 0                  # completed steps (end only)
    final_loss: Optional[float] = None


@dataclasses.dataclass
class StepEvent:
    KIND = "step"
    step: int = 0
    loss: float = 0.0
    seconds: float = 0.0


@dataclasses.dataclass
class FaultEvent:
    """A fault firing (``source="injector"``) or being handled by the
    resilient loop (``source="loop"``)."""
    KIND = "fault"
    step: int = 0
    fault: str = ""                 # oom | crash | nan | stall | corrupt | exception
    injected: bool = False
    source: str = "loop"            # injector | loop
    error: str = ""


@dataclasses.dataclass
class DegradeEvent:
    """One rung of the memory-pressure ladder applied mid-run.

    ``seq_len`` (not ``seq``): the envelope reserves ``seq`` for the
    emitter's monotone record index."""
    KIND = "degrade"
    step: int = 0
    rung: str = ""
    trigger: str = "oom"            # oom | watermark
    engine: str = ""
    quantize: str = ""
    batch: int = 0
    seq_len: int = 0
    predicted_peak_mb: float = 0.0


@dataclasses.dataclass
class GuardEvent:
    """StepGuard rejection with the EWMA state that justified it."""
    KIND = "guard"
    step: int = 0
    reason: str = ""                # nonfinite_loss | nonfinite_norm | loss_spike | norm_spike
    detail: str = ""
    loss_ewma: Optional[float] = None
    norm_ewma: Optional[float] = None
    rejected: int = 0
    budget: int = 0


@dataclasses.dataclass
class AdmissionEvent:
    """Serve-loop request lifecycle: admit / reject / complete."""
    KIND = "admission"
    action: str = ""                # admit | reject | complete
    rid: str = ""
    adapter: str = ""
    reason: str = ""                # reject: pages | headroom | tiles | store
    step: int = 0


@dataclasses.dataclass
class CheckpointEvent:
    KIND = "checkpoint"
    action: str = ""                # save | restore | quarantine
    step: int = 0
    seconds: float = 0.0
    path: str = ""


@dataclasses.dataclass
class WatermarkEvent:
    """Memory watermark sample around a step boundary."""
    KIND = "watermark"
    step: int = 0
    measured_mb: float = 0.0
    peak_mb: float = 0.0
    predicted_mb: float = 0.0       # modelled peak for the live spec (0: none)
    ratio: float = 0.0              # peak_mb / predicted_mb (0 if unknown)
    source: str = ""                # device_stats | live_arrays


EVENT_TYPES: Dict[str, Type] = {
    cls.KIND: cls
    for cls in (RunEvent, StepEvent, FaultEvent, DegradeEvent, GuardEvent,
                AdmissionEvent, CheckpointEvent, WatermarkEvent)
}

# an event field named like an envelope key would silently clobber the
# envelope in to_record — refuse at import time
for _cls in EVENT_TYPES.values():
    _clash = {f.name for f in dataclasses.fields(_cls)} & set(ENVELOPE_KEYS)
    if _clash:
        raise TypeError(f"{_cls.__name__} field(s) {sorted(_clash)} collide "
                        f"with the record envelope {ENVELOPE_KEYS}")


def to_record(event, *, seq: int = 0, worker: Optional[int] = None,
              ts: Optional[float] = None) -> dict:
    """Wrap a typed event in the wire envelope."""
    rec = {"v": SCHEMA_VERSION,
           "ts": time.time() if ts is None else ts,
           "kind": event.KIND, "seq": seq}
    if worker is not None:
        rec["worker"] = worker
    rec.update(dataclasses.asdict(event))
    return rec


def from_record(rec: dict):
    """Typed event back out of a wire record (envelope keys dropped)."""
    cls = EVENT_TYPES[rec["kind"]]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in rec.items() if k in fields})


def validate_record(rec: dict) -> List[str]:
    """Schema check for one wire record; returns a list of problems."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is not an object: {type(rec).__name__}"]
    v = rec.get("v")
    if v != SCHEMA_VERSION:
        errs.append(f"schema version {v!r} != {SCHEMA_VERSION}")
    if not isinstance(rec.get("ts"), (int, float)):
        errs.append("missing/non-numeric 'ts'")
    if not isinstance(rec.get("seq"), int):
        errs.append("missing/non-int 'seq'")
    kind = rec.get("kind")
    cls = EVENT_TYPES.get(kind)
    if cls is None:
        errs.append(f"unknown kind {kind!r}")
        return errs
    for f in dataclasses.fields(cls):
        if f.name not in rec:
            errs.append(f"{kind}: missing field {f.name!r}")
    extra = set(rec) - {f.name for f in dataclasses.fields(cls)} \
        - set(ENVELOPE_KEYS)
    for k in sorted(extra):
        errs.append(f"{kind}: unexpected field {k!r}")
    return errs


# --------------------------------------------------------------------- sinks
class MemorySink:
    """Keeps records in a list; the default sink (snapshots, tests)."""

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-one-line-per-record file sink; flushes per emit so crashed or
    injected-fault runs still leave a complete timeline prefix."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[IO[str]] = None

    def emit(self, record: dict) -> None:
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------- jsonl I/O
def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def merge_jsonl_shards(shards: Sequence[str], out_path: str) -> List[dict]:
    """Merge per-worker JSONL shards into one deterministic fleet timeline.

    Sort key is ``(ts, worker, seq)`` — identical regardless of shard file
    order or interleaving, so the merged file is byte-stable. Returns the
    merged records.
    """
    records: List[dict] = []
    for path in shards:
        records.extend(read_jsonl(path))
    records.sort(key=lambda r: (r.get("ts", 0.0), str(r.get("worker", "")),
                                r.get("seq", 0)))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return records
