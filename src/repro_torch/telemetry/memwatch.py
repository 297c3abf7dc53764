"""Memory watermark monitor: measured device residency beside a modelled
prediction (``repro.telemetry.memwatch``).

Samples around step boundaries (the resilient loop calls :meth:`sample` after
each step) and keeps a running peak. MB here is 2**20 bytes, as in the
reference. Two sources:

* ``device_stats`` — the CUDA caching allocator of the watched device:
  ``torch.cuda.memory_allocated`` is the residency, and
  ``torch.cuda.max_memory_allocated`` (since the process started or the
  last ``reset_peak_memory_stats``) the peak, so in-step temporaries are
  included. On a CUDA device this is the only source: when its stats
  cannot be read the sample raises, it never falls back to the CPU count.
* ``live_arrays`` — the CPU's source (PyTorch keeps no allocator stats
  there): sums the storage bytes of the live CPU tensors the garbage
  collector can see, each storage once, as the reference sums
  ``jax.live_arrays()``. This counts *resident* tensors (params, optimizer
  state, caches) and is a lower bound on the true peak — temporaries freed
  inside a step are invisible.

``predicted_mb`` is the reference's modelled peak of the live spec (from
its ``benchmarks/memsim.py``); the port has no memory model yet, so it
stays 0 and the records keep the field at 0.
"""
from __future__ import annotations

import gc
from typing import Optional

import torch


def _device_stats_mb(device: torch.device) -> dict:
    """The CUDA allocator's residency and peak on ``device``; raises when
    the stats cannot be read (no card, or the CUDA runtime failed)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"memory watermark of {device}: no CUDA card is "
                           "visible to read the allocator stats from")
    return {"measured_mb": torch.cuda.memory_allocated(device) / 2**20,
            "hw_peak_mb": torch.cuda.max_memory_allocated(device) / 2**20}


def _live_arrays_mb() -> float:
    """Bytes of the live CPU tensors' storages, each storage once."""
    seen, total = set(), 0
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # module objects the collector holds answer with a warning
        if not issubclass(type(obj), torch.Tensor) \
                or obj.device.type != "cpu":
            continue
        st = obj.untyped_storage()
        key = st.data_ptr()
        if key in seen or key == 0:
            continue
        seen.add(key)
        total += st.nbytes()
    return total / 2**20


class MemoryWatermark:
    """Running peak of measured device memory, beside a modelled peak.

    ``device`` is where the run's tensors live: a CUDA device is read
    through its allocator (``source`` "auto" or "device_stats"; asking a
    CUDA device for "live_arrays" raises), the CPU through its live
    tensors ("auto" or "live_arrays"; "device_stats" raises there, as the
    reference raises on a backend without allocator stats)."""

    def __init__(self, source: str = "auto", device=None):
        if source not in ("auto", "device_stats", "live_arrays"):
            raise ValueError(f"unknown memwatch source {source!r}")
        self.device = torch.device(
            device if device is not None else
            ("cuda" if torch.cuda.is_available() else "cpu"))
        on_card = self.device.type == "cuda"
        if on_card and source == "live_arrays":
            raise ValueError("the CPU's live-tensor count cannot stand for "
                             f"{self.device}'s memory; use device_stats")
        if not on_card and source == "device_stats":
            raise RuntimeError("device allocator stats are unavailable on "
                               f"{self.device}; use source='live_arrays'")
        self.source = "device_stats" if on_card else "live_arrays"
        self.peak_mb = 0.0
        self.last_mb = 0.0
        self.samples = 0
        self.predicted_mb = 0.0       # modelled peak for the live spec

    def sample(self) -> dict:
        """Measure now; update the running peak; return the sample dict."""
        if self.source == "device_stats":
            stats = _device_stats_mb(self.device)
            measured = stats["measured_mb"]
            self.peak_mb = max(self.peak_mb, stats["hw_peak_mb"])
        else:
            measured = _live_arrays_mb()
        self.last_mb = measured
        if measured > self.peak_mb:
            self.peak_mb = measured
        self.samples += 1
        return {"measured_mb": measured, "peak_mb": self.peak_mb,
                "source": self.source}

    def compare(self, predicted_mb: Optional[float] = None) -> dict:
        """Measured peak against the modelled peak (0 when none)."""
        pred = self.predicted_mb if predicted_mb is None else predicted_mb
        ratio = (self.peak_mb / pred) if pred else 0.0
        return {"measured_peak_mb": round(self.peak_mb, 3),
                "predicted_peak_mb": round(pred, 3),
                "ratio": round(ratio, 4),
                "source": self.source, "samples": self.samples}
