"""Deterministic, seeded fault injection for chaos-hardening the trainer
(``repro.runtime.faults``).

The paper's setting is a phone: 6-12 GB shared with every other workload,
so the dominant end of a fine-tuning run is not a clean completion but an
OOM kill, a preemption mid-step, or background throttling. This module makes
those failures *first-class, reproducible inputs* to a training run:

* :class:`FaultPlan` — a declarative list of ``(step, kind)`` events, built
  either from an explicit string (``"oom@4,corrupt@9,crash@9,nan@14,
  stall@18:1.5"``) or deterministically from a seed
  (:meth:`FaultPlan.seeded`). The same plan string always produces the same
  failures at the same steps — chaos runs are replayable.
* :class:`FaultInjector` — the runtime hook the
  :class:`~repro_torch.runtime.fault_tolerance.ResilientLoop` calls at the step
  boundary. Each event fires exactly once (a restart that rewinds past a
  fired event does not re-fire it), so an injected fault models one real
  incident, not a permanently broken device.

Fault kinds and what they exercise:

=========  ==================================================================
``oom``    raises :class:`InjectedOOM` (message mimics the runtime's
           ``RESOURCE_EXHAUSTED``) → the memory-pressure degradation ladder
           (``runtime/degrade.py``), falling back to retry-from-checkpoint.
``crash``  raises :class:`InjectedCrash` → supervised restart: restore from
           the latest checkpoint, replay the exact token stream.
``nan``    replaces the step's loss with NaN → the step guard
           (``runtime/guard.py``) rejects the update (skip-and-rewind).
``corrupt`` flips bytes in the newest checkpoint's arrays on disk → the next
           restore fails checksum verification and ``Checkpointer`` must
           quarantine it and fall back to the next-older valid checkpoint.
``stall``  sleeps ``arg`` seconds (default 1.0) inside the timed step → the
           straggler watchdog flags the step, and past its consecutive
           limit the supervisor restarts from checkpoint.
=========  ==================================================================

The CLI exposes plans via ``--inject-faults`` (``launch/train.py``).
This is the port's copy of ``repro.runtime.faults``: the same kinds, the
same plan syntax, and :meth:`FaultPlan.seeded` draws with numpy from the
seed exactly as the reference does, so one ``--inject-faults random:5
--seed s`` gives the same plan in both packages. :func:`is_oom_error` also
takes PyTorch's ``torch.cuda.OutOfMemoryError``, the card's allocator
failure.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("repro_torch.faults")

#: recognised fault kinds, in the order simultaneous events fire at one step
#: (corrupt before crash so a same-step "corrupt,crash" pair exercises the
#: checkpoint-fallback path; raising kinds last so non-raising ones run)
KINDS = ("corrupt", "stall", "nan", "oom", "crash")

#: substrings identifying a real allocator/runtime OOM in exception text
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "Allocation failure", "OOM", "CUDA out of memory")


class InjectedOOM(RuntimeError):
    """Simulated allocator exhaustion (message mimics RESOURCE_EXHAUSTED)."""


class InjectedCrash(RuntimeError):
    """Simulated process death: in-memory state is presumed lost."""


def is_oom_error(e: BaseException) -> bool:
    """True for injected OOMs, MemoryError, the CUDA allocator's
    ``torch.cuda.OutOfMemoryError``, and runtime errors whose text matches
    the platform's resource-exhaustion messages."""
    import torch
    if isinstance(e, (InjectedOOM, MemoryError,
                      torch.cuda.OutOfMemoryError)):
        return True
    msg = str(e)
    return any(m in msg for m in OOM_MARKERS)


def corrupt_latest_checkpoint(directory: str) -> Optional[int]:
    """Flip trailing bytes of one array file in the newest checkpoint so its
    content no longer matches the manifest checksum. Returns the corrupted
    step, or None if there is no checkpoint yet."""
    from repro_torch.checkpoint.checkpointer import latest_step

    step = latest_step(directory)
    if step is None:
        return None
    d = os.path.join(directory, f"step_{step:08d}")
    npys = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    if not npys:
        return None
    path = os.path.join(d, npys[0])
    with open(path, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        tail = f.read(8)
        f.seek(-8, os.SEEK_END)
        f.write(bytes(b ^ 0xFF for b in tail))
    return step


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str
    arg: float = 0.0      # stall: seconds to sleep

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")

    def to_string(self) -> str:
        base = f"{self.kind}@{self.step}"
        return f"{base}:{self.arg:g}" if self.arg else base


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, ordered set of fault events."""
    events: Tuple[FaultEvent, ...] = ()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """``"oom@4,corrupt@9,crash@9,nan@14,stall@18:1.5"`` — a comma list
        of ``kind@step`` entries, with an optional ``:arg`` suffix."""
        events = []
        for part in filter(None, (p.strip() for p in text.split(","))):
            try:
                kind, rest = part.split("@", 1)
                step, _, arg = rest.partition(":")
                events.append(FaultEvent(int(step), kind.strip(),
                                         float(arg) if arg else 0.0))
            except ValueError as e:
                raise ValueError(
                    f"bad fault entry {part!r} (expected kind@step[:arg], "
                    f"kind in {KINDS}): {e}") from None
        return cls(tuple(sorted(events,
                                key=lambda ev: (ev.step,
                                                KINDS.index(ev.kind)))))

    @classmethod
    def seeded(cls, seed: int, total_steps: int, n_faults: int = 5,
               kinds: Tuple[str, ...] = KINDS) -> "FaultPlan":
        """Deterministic random plan: ``n_faults`` events at distinct steps
        in ``[1, total_steps-2]``, kinds drawn without immediate repeats.
        The same (seed, total_steps, n_faults) always yields the same plan."""
        rng = np.random.default_rng(seed)
        hi = max(2, total_steps - 1)
        n = min(n_faults, hi - 1)
        steps = sorted(rng.choice(np.arange(1, hi), size=n, replace=False))
        chosen = [kinds[i % len(kinds)] for i in rng.permutation(
            max(n, len(kinds)))[:n]]
        return cls(tuple(FaultEvent(int(s), k)
                         for s, k in zip(steps, chosen)))

    @classmethod
    def from_string(cls, text: str, *, total_steps: int = 100,
                    seed: int = 0) -> "FaultPlan":
        """CLI entry point: either an explicit ``kind@step`` list, or
        ``random`` / ``random:N`` for an N-event seeded plan over the run."""
        text = text.strip()
        if text.startswith("random"):
            _, _, n = text.partition(":")
            return cls.seeded(seed, total_steps,
                              n_faults=int(n) if n else 5)
        return cls.parse(text)

    def to_string(self) -> str:
        return ",".join(ev.to_string() for ev in self.events)

    def __bool__(self) -> bool:
        return bool(self.events)


class FaultInjector:
    """Fires a :class:`FaultPlan` into a running loop, once per event.

    The :class:`~repro_torch.runtime.fault_tolerance.ResilientLoop` calls
    :meth:`before_step` inside its try block (raising kinds land in the
    loop's failure handler) and :meth:`after_step` on the produced loss.
    ``corrupt`` events that arrive before any checkpoint exists stay pending
    and fire at the first step boundary where one does.
    """

    def __init__(self, plan: FaultPlan, ckpt_dir: Optional[str] = None):
        self.plan = plan
        self.ckpt_dir = ckpt_dir
        self._fired: set = set()
        self.log: list = []          # (step_fired, kind) in firing order
        #: optional ``(step, kind) -> None`` hook fired on every injection
        #: (the trainer points this at telemetry so chaos timelines carry a
        #: typed event at the exact firing step, raising kinds included)
        self.on_fire = None

    def _fire(self, idx: int, step: int, ev: FaultEvent):
        self._fired.add(idx)
        self.log.append((step, ev.kind))
        log.warning("injecting fault %r (planned step %d) at step %d",
                    ev.kind, ev.step, step)
        if self.on_fire is not None:
            self.on_fire(step, ev.kind)

    def before_step(self, step: int) -> None:
        for idx, ev in enumerate(self.plan.events):
            if idx in self._fired or ev.kind in ("nan",):
                continue
            if ev.kind == "corrupt":
                # pending until a checkpoint exists to corrupt
                if ev.step <= step and self.ckpt_dir is not None:
                    if corrupt_latest_checkpoint(self.ckpt_dir) is not None:
                        self._fire(idx, step, ev)
                continue
            if ev.step != step:
                continue
            if ev.kind == "stall":
                self._fire(idx, step, ev)
                time.sleep(ev.arg or 1.0)
            elif ev.kind == "oom":
                self._fire(idx, step, ev)
                raise InjectedOOM(
                    f"RESOURCE_EXHAUSTED: injected OOM at step {step}")
            elif ev.kind == "crash":
                self._fire(idx, step, ev)
                raise InjectedCrash(f"injected process crash at step {step}")

    def after_step(self, step: int, loss):
        for idx, ev in enumerate(self.plan.events):
            if ev.kind == "nan" and ev.step == step and idx not in self._fired:
                self._fire(idx, step, ev)
                return float("nan")
        return loss

    def summary(self) -> dict:
        """``{kind: times_fired}`` — merged into the run's fault counters."""
        out: dict = {}
        for _, kind in self.log:
            out[kind] = out.get(kind, 0) + 1
        return out

    @property
    def exhausted(self) -> bool:
        return len(self._fired) == len(self.plan.events)
