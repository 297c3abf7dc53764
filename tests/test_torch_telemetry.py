"""The port's telemetry (``repro_torch.telemetry``) against the reference's
(``repro.telemetry``), on the CPU.

Every event kind has the reference's fields and defaults; the port's wire
records pass the reference's ``validate_record`` and the reference's pass
the port's; the JSONL sink round-trips and shard merging is the
reference's; nested spans export to a Chrome trace; ``MetricRegistry``
snapshots equal the reference's for the same operations; the disabled
singleton is inert. The memory watermark reads live CPU tensors on the
CPU and refuses to stand in for a CUDA device; a Trainer run with
``--telemetry on`` leaves records that validate, spans for ``data_fetch``
and ``step``, and with ``--profile on`` a ``torch.profiler`` Chrome trace.
"""
import dataclasses
import json

import pytest
import torch

from repro.telemetry import events as jev
from repro.telemetry import metrics as jmetrics
from repro_torch import telemetry as tele
from repro_torch.api.spec import TrainSpec
from repro_torch.api.trainer import Trainer
from repro_torch.telemetry import events as tev
from repro_torch.telemetry import memwatch
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import spans as tspans


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("kind", sorted(jev.EVENT_TYPES))
def test_event_kind_has_the_reference_s_fields(kind):
    assert sorted(tev.EVENT_TYPES) == sorted(jev.EVENT_TYPES)
    assert _fields(tev.EVENT_TYPES[kind]) == _fields(jev.EVENT_TYPES[kind])
    assert tev.SCHEMA_VERSION == jev.SCHEMA_VERSION
    assert tev.ENVELOPE_KEYS == jev.ENVELOPE_KEYS


EVENTS = [("run", dict(phase="start", engine="mesp_cuda", spec={"a": 1})),
          ("step", dict(step=3, loss=5.5, seconds=0.25)),
          ("fault", dict(step=2, fault="oom", injected=True)),
          ("degrade", dict(step=2, rung="halve_batch", batch=1, seq_len=32)),
          ("guard", dict(step=8, reason="nonfinite_loss", rejected=1)),
          ("admission", dict(action="admit", rid="r0")),
          ("checkpoint", dict(action="save", step=4, seconds=1.5)),
          ("watermark", dict(step=1, measured_mb=10.5, source="device_stats"))]


@pytest.mark.parametrize("kind,kw", EVENTS, ids=[k for k, _ in EVENTS])
def test_records_validate_across_packages(kind, kw):
    trec = tev.to_record(tev.EVENT_TYPES[kind](**kw), seq=4, worker=1, ts=7.0)
    jrec = jev.to_record(jev.EVENT_TYPES[kind](**kw), seq=4, worker=1, ts=7.0)
    assert trec == jrec
    assert jev.validate_record(trec) == [] and tev.validate_record(jrec) == []
    assert tev.from_record(trec) == tev.EVENT_TYPES[kind](**kw)
    bad = {**trec, "extra_field": 1}
    assert tev.validate_record(bad) == jev.validate_record(bad) != []


def test_jsonl_round_trip_and_shard_merge(tmp_path):
    recs = [tev.to_record(tev.StepEvent(step=i, loss=1.0 / (i + 1)), seq=i,
                          worker=w, ts=float(10 - i))
            for w in (0, 1) for i in range(3)]
    paths = []
    for w in (0, 1):
        sink = tev.JsonlSink(str(tmp_path / f"w{w}" / "events.jsonl"))
        for r in recs:
            if r["worker"] == w:
                sink.emit(r)
        sink.close()
        paths.append(sink.path)
    assert tev.read_jsonl(paths[0]) == [r for r in recs if r["worker"] == 0]
    got = tev.merge_jsonl_shards(paths[::-1], str(tmp_path / "t.jsonl"))
    want = jev.merge_jsonl_shards(paths, str(tmp_path / "j.jsonl"))
    assert got == want
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()


def test_nested_spans_export_a_chrome_trace(tmp_path):
    tr = tspans.Tracer()
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    events = tr.chrome_trace()
    assert [(e["name"], e["args"]["depth"]) for e in events] == [
        ("inner", 1), ("inner", 1), ("outer", 0)]
    outer = events[-1]
    assert all(e["ts"] >= outer["ts"] and e["ts"] + e["dur"] <=
               outer["ts"] + outer["dur"] + 0.2 for e in events[:2])
    doc = json.load(open(tr.save(str(tmp_path / "trace.json"))))
    assert doc["traceEvents"] == events
    assert tr.totals()["inner"]["count"] == 2
    assert tspans.NULL_TRACER.span("x") is tspans.NULL_SPAN


def test_metric_registry_snapshot_is_the_reference_s():
    snaps = []
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricRegistry()
        g = reg.register_group(mod.CounterGroup("serve", ["admitted"]))
        g["admitted"] += 3
        reg.group("store", ["hits"])["hits"] = 7
        reg.counter("train.steps").inc(4)
        reg.gauge("guard.loss_ewma").set(2.5)
        for v in (0.0005, 0.02, 3.0, 100.0):
            reg.histogram("train.step_seconds").record(v)
        reg.histogram("empty")
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


def test_disabled_is_inert():
    d = tele.DISABLED
    assert not d.enabled and d.span("step") is tspans.NULL_SPAN
    d.emit(tev.StepEvent(step=1))
    assert d.events() == [] and d.counts_by_kind() == {}
    assert d.sinks == [] and d.registry.snapshot() == {}
    d.close()
    assert tele.Telemetry.from_spec(TrainSpec()) is tele.DISABLED


def test_memwatch_reads_cpu_tensors_and_never_stands_in_for_the_card():
    w = memwatch.MemoryWatermark(device="cpu")
    before = w.sample()["measured_mb"]
    big = torch.ones(1 << 20)                  # 4 MiB
    s = w.sample()
    assert s["source"] == "live_arrays"
    assert s["measured_mb"] >= before + 3.9 and w.peak_mb >= s["measured_mb"]
    del big
    with pytest.raises(RuntimeError, match="unavailable"):
        memwatch.MemoryWatermark("device_stats", device="cpu")
    with pytest.raises(ValueError, match="cannot stand for"):
        memwatch.MemoryWatermark("live_arrays", device="cuda")
    card = memwatch.MemoryWatermark(device="cuda")
    assert card.source == "device_stats"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            card.sample()
    assert card.compare()["source"] == "device_stats"


def test_trainer_run_with_telemetry_and_profile(tmp_path):
    spec = TrainSpec(reduced=True, device="cpu", engine="mesp_cuda",
                     steps=4, seq=32, batch=2, ckpt_interval=2,
                     ckpt_dir=str(tmp_path / "ck"), telemetry="on",
                     profile="on", inject_faults="nan@1", quiet=True)
    res = Trainer(spec).fit()
    out = res.metrics["telemetry_dir"]
    recs = tev.read_jsonl(f"{out}/events.jsonl")
    assert recs and all(tev.validate_record(r) == [] and
                        jev.validate_record(r) == [] for r in recs)
    kinds = {r["kind"] for r in recs}
    assert {"run", "step", "fault", "guard", "checkpoint",
            "watermark"} <= kinds
    spans = res.metrics["spans"]
    assert spans["data_fetch"]["count"] >= 4 and spans["step"]["count"] >= 4
    wm = res.metrics["watermark"]
    assert wm["source"] == "live_arrays" and wm["measured_peak_mb"] > 0
    assert res.metrics["registry"]["train.steps"] == 4
    trace = json.load(open(f"{out}/profile/trace.json"))
    assert trace["traceEvents"]
    assert json.load(open(f"{out}/trace.json"))["traceEvents"]
