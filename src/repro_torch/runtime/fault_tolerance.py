"""Fault-tolerant runtime: the supervised ResilientLoop + straggler policy
(``repro.runtime.fault_tolerance``).

On-device (and at 1000+ node scale) the failure model is: (a) whole-job
preemption/crash — handled by atomic checkpoints + auto-resume; (b) memory
pressure / ``RESOURCE_EXHAUSTED`` — handled by the degradation ladder
(``runtime/degrade.py``) before falling back to retry; (c) numerical
anomalies (NaN loss, gradient spikes) — handled by the step guard
(``runtime/guard.py``) with a bounded skip-and-rewind budget; (d) hangs /
stragglers — a per-step watchdog whose ``restart`` verdict triggers a
supervised restore-from-checkpoint (bounded by ``restart_budget``);
(e) data-loss on restart — prevented by checkpointing the data-iterator
state.

:class:`ResilientLoop` is the supervisor: it owns the step/retry state
machine, classifies failures (OOM vs transient), applies exponential
backoff, **resets the retry budget after every successful step** (one
transient early plus another much later must not kill a long run), counts
every fault into :class:`FaultCounters`, and always force-saves a final
checkpoint on exit so a completed run is resumable/servable even when
``total_steps % interval != 0``.

A failed step is handled only after its ``except`` block has ended, with
the exception's traceback dropped: on a card the traceback's frames hold
the failed step's activations, and a degradation rung, a checkpoint write
or a restore run inside the block would need memory while that is still
held. The loop then collects the freed frames and returns the CUDA caching
allocator's unused blocks (``torch.cuda.empty_cache``) before the handler
and before the next try. A failure the loop re-raises carries its original
traceback as text (an exception note).
"""
from __future__ import annotations

import dataclasses
import gc
import logging
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime.faults import is_oom_error

log = logging.getLogger("repro_torch.ft")


@dataclass
class StepResult:
    step: int
    loss: float
    seconds: float
    retried: bool = False


@dataclass
class FaultCounters:
    """Per-fault accounting surfaced in ``TrainResult``."""
    step_failures: int = 0        # generic exceptions (incl. crashes)
    oom_events: int = 0           # RESOURCE_EXHAUSTED-class failures
    degradations: int = 0         # ladder rungs applied
    watermark_triggers: int = 0   # proactive degrades from measured pressure
    guard_skips: int = 0          # anomalous steps rejected + rewound
    straggler_restarts: int = 0   # watchdog-triggered supervised restarts
    ckpt_quarantines: int = 0     # corrupt checkpoints quarantined
    steps_replayed: int = 0       # steps re-run after restore rewinds
    backoff_seconds: float = 0.0  # total time spent backing off
    injected: dict = field(default_factory=dict)  # {kind: fired} from plan

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def total_faults(self) -> int:
        return (self.step_failures + self.oom_events + self.guard_skips
                + self.straggler_restarts)


class StragglerPolicy:
    """EWMA step-time tracker; flags steps slower than ``factor``× the mean.

    The first ``warmup`` observations are discarded from the baseline (a
    first step's one-off set-up — kernel builds, allocator growth — would
    otherwise seed the EWMA with a wildly unhistoric mean). On real
    hardware a flagged step triggers (1) collective-timeout
    logging, (2) optional step skip for async-capable optimizers, (3) a
    restart signal if ``consecutive_limit`` is exceeded (the node is
    presumed sick).
    """

    def __init__(self, factor: float = 3.0, consecutive_limit: int = 3,
                 alpha: float = 0.1, warmup: int = 1):
        self.factor = factor
        self.limit = consecutive_limit
        self.alpha = alpha
        self.warmup = warmup
        self._seen = 0
        self.mean: Optional[float] = None
        self.slow_streak = 0

    def reset(self) -> None:
        """Re-seed the baseline (after a restart or a rebuilt step)."""
        self._seen = 0
        self.mean = None
        self.slow_streak = 0

    def observe(self, seconds: float) -> str:
        """Returns 'ok' | 'slow' | 'restart'."""
        self._seen += 1
        if self._seen <= self.warmup:
            return "ok"                      # set-up step: not a baseline
        if self.mean is None:
            self.mean = seconds
            return "ok"
        verdict = "ok"
        if seconds > self.factor * self.mean:
            self.slow_streak += 1
            verdict = "restart" if self.slow_streak >= self.limit else "slow"
        else:
            self.slow_streak = 0
        # slow steps don't poison the EWMA baseline
        if verdict == "ok":
            self.mean = (1 - self.alpha) * self.mean + self.alpha * seconds
        return verdict


class RestartRequired(RuntimeError):
    pass


def _drop_tracebacks(e: BaseException) -> None:
    """Drop the tracebacks of ``e`` and of the exceptions it chains to, so
    their frames (and the tensors those hold) can be freed."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        e.__traceback__ = None
        e = e.__cause__ or e.__context__


def _release_memory() -> None:
    """Collect unreachable frames, then hand the CUDA caching allocator's
    unused blocks back (a no-op while CUDA is not in use)."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class ResilientLoop:
    """Supervised training-step loop.

    step_fn(params, opt_state, batch) -> (params, opt_state, loss)
    restore_fn(loop) -> (step, params, opt_state): the state to run from,
    at the start and after a failure or a straggler restart (the Trainer's
    loads the newest checkpoint, rebuilding engine and iterator from the
    spec its manifest records, or starts afresh at step 0); it updates
    ``loop.batch_iter`` / ``loop.step_fn`` as needed.

    Pluggable hooks (all optional) let the Trainer facade wire in the full
    resilience stack without this module importing any of it eagerly:

    * ``injector``   — :class:`~repro_torch.runtime.faults.FaultInjector`; its
      ``before_step`` runs inside the try block (raising kinds land in the
      failure handler) and ``after_step`` may replace the loss.
    * ``guard``      — :class:`~repro_torch.runtime.guard.StepGuard`; a ``reject``
      verdict rewinds the step (new params/opt-state discarded, batch
      skipped).
    * ``on_oom(loop)`` — degradation hook. May swap ``loop.step_fn`` /
      ``loop.batch_iter`` and return transformed ``(params, opt_state)`` to
      retry the same step under a cheaper spec; ``None`` falls through to
      the ordinary retry path.
    * ``extra_fn()`` — dict merged into every checkpoint manifest (the
      Trainer records the live spec so restores are self-describing).
    * ``telemetry`` — :class:`repro_torch.telemetry.Telemetry`; when enabled
      the loop emits typed step/fault/checkpoint/watermark events, wraps
      data-fetch/step/checkpoint/restore in trace spans and keeps
      ``train.*`` metrics. Disabled (the default) the hot path pays one
      flag check and nothing else — the same step object, no span or
      record allocation.
    * ``memwatch`` — :class:`repro_torch.telemetry.MemoryWatermark`; sampled
      after every successful step.
    * ``pressure`` — :class:`repro_torch.runtime.degrade.WatermarkTrigger`; fed
      the watermark samples, and when it trips the loop walks the same
      ``on_oom`` ladder *before* the allocator actually fails.
    """

    def __init__(self, step_fn: Callable[[Any, Any, dict], tuple],
                 restore_fn: Callable,
                 batch_iter,
                 ckpt: Checkpointer,
                 total_steps: int,
                 *,
                 max_retries: int = 3,
                 restart_budget: int = 0,
                 backoff_base: float = 0.05,
                 backoff_max: float = 30.0,
                 straggler: Optional[StragglerPolicy] = None,
                 guard=None,
                 injector=None,
                 on_step: Optional[Callable[[StepResult], None]] = None,
                 on_oom: Optional[Callable] = None,
                 extra_fn: Optional[Callable[[], dict]] = None,
                 telemetry=None,
                 memwatch=None,
                 pressure=None):
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.batch_iter = batch_iter
        self.ckpt = ckpt
        self.total_steps = total_steps
        self.max_retries = max_retries
        self.restart_budget = restart_budget
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.straggler = straggler or StragglerPolicy()
        self.guard = guard
        self.injector = injector
        self.on_step = on_step
        self.on_oom = on_oom
        self.extra_fn = extra_fn
        if telemetry is None:
            from repro_torch.telemetry import DISABLED
            telemetry = DISABLED
        self.telemetry = telemetry
        self.memwatch = memwatch
        self.pressure = pressure
        #: why the current on_oom invocation happened ("oom" | "watermark");
        #: read by the Trainer's degrade hook to tag its DegradeEvent
        self.degrade_trigger = "oom"

        self.counters = FaultCounters()
        self.step = 0
        self.params = None
        self.opt_state = None
        self._consecutive_failures = 0
        self._last_saved: Optional[int] = None
        # snapshot of the iterator's initial position so a restore with no
        # checkpoint replays the exact token stream from the start
        state = getattr(batch_iter, "state", None)
        self._initial_data_state = (dataclasses.replace(state)
                                    if dataclasses.is_dataclass(state)
                                    else None)

    # -------------------------------------------------------------- restore
    def _data_state_dict(self) -> Optional[dict]:
        state = getattr(self.batch_iter, "state", None)
        return state.to_dict() if state is not None else None

    def _restore(self):
        with self.telemetry.span("restore"):
            return self._restore_inner()

    def _restore_inner(self):
        self.straggler.reset()
        t0 = time.monotonic()
        step, params, opt_state = self.restore_fn(self)
        if step < self.step:
            self.counters.steps_replayed += self.step - step
        prev_quar = self.counters.ckpt_quarantines
        self.counters.ckpt_quarantines = len(
            getattr(self.ckpt, "quarantined", ()))
        tel = self.telemetry
        if tel.enabled:
            from repro_torch.telemetry import CheckpointEvent
            tel.emit(CheckpointEvent(action="restore", step=step,
                                     seconds=time.monotonic() - t0,
                                     path=self.ckpt.directory))
            for _ in range(self.counters.ckpt_quarantines - prev_quar):
                tel.emit(CheckpointEvent(action="quarantine", step=step,
                                         path=self.ckpt.directory))
            tel.registry.counter("ckpt.restores").inc()
        return step, params, opt_state

    # ----------------------------------------------------------------- save
    def _save_now(self) -> None:
        t0 = time.monotonic()
        with self.telemetry.span("checkpoint"):
            self.ckpt.save(self.step, self.params, self.opt_state,
                           data_state=self._data_state_dict(),
                           extra=self.extra_fn() if self.extra_fn else None)
        self._last_saved = self.step
        tel = self.telemetry
        if tel.enabled:
            from repro_torch.telemetry import CheckpointEvent
            tel.emit(CheckpointEvent(action="save", step=self.step,
                                     seconds=time.monotonic() - t0,
                                     path=self.ckpt.directory))
            tel.registry.counter("ckpt.saves").inc()

    # -------------------------------------------------------------- failure
    def _handle_failure(self, e: BaseException, tb: str = "") -> None:
        """Classify and answer a step's failure ``e`` (its traceback
        already dropped; ``tb`` is its text, attached if ``e`` is
        re-raised)."""
        _release_memory()
        oom = is_oom_error(e)
        tel = self.telemetry
        if tel.enabled:
            from repro_torch.telemetry import FaultEvent as TelFault
            tel.emit(TelFault(step=self.step,
                              fault="oom" if oom else "exception",
                              injected=type(e).__name__.startswith("Injected"),
                              source="loop", error=str(e)))
            tel.registry.counter(
                "faults.oom" if oom else "faults.exception").inc()
        if oom:
            self.counters.oom_events += 1
            log.warning("step %d hit memory pressure: %s", self.step, e)
            if self.on_oom is not None:
                swapped = self.on_oom(self)
                if swapped is not None:
                    self.params, self.opt_state = swapped
                    self.counters.degradations += 1
                    self.straggler.reset()   # next step rebuilds: not slow
                    # checkpoint the degraded state immediately so any later
                    # restore reconstitutes the post-degradation program
                    self._save_now()
                    return
        else:
            self.counters.step_failures += 1
        self._consecutive_failures += 1
        log.warning("step %d failed (%s); retry %d/%d from checkpoint",
                    self.step, e, self._consecutive_failures,
                    self.max_retries)
        if self._consecutive_failures > self.max_retries:
            if tb:
                e.add_note(f"traceback of the failed step:\n{tb}")
            raise e
        delay = min(self.backoff_max,
                    self.backoff_base * (2 ** (self._consecutive_failures
                                               - 1)))
        if delay > 0:
            self.counters.backoff_seconds += delay
            time.sleep(delay)
        self.step, self.params, self.opt_state = self._restore()

    # ---------------------------------------------------------- memwatch
    def _sample_watermark(self) -> None:
        """Post-step watermark sample: metrics/event, then pressure check."""
        m = self.memwatch.sample()
        pred = self.memwatch.predicted_mb
        tel = self.telemetry
        if tel.enabled:
            from repro_torch.telemetry import WatermarkEvent
            tel.registry.gauge("mem.measured_mb").set(m["measured_mb"])
            tel.registry.gauge("mem.peak_mb").set(m["peak_mb"])
            tel.emit(WatermarkEvent(
                step=self.step, measured_mb=round(m["measured_mb"], 3),
                peak_mb=round(m["peak_mb"], 3),
                predicted_mb=round(pred or 0.0, 3),
                ratio=round(m["peak_mb"] / pred, 4) if pred else 0.0,
                source=m["source"]))
        if self.pressure is not None \
                and self.pressure.observe(m["measured_mb"]):
            self._degrade_for_pressure(m["measured_mb"])

    def _degrade_for_pressure(self, measured_mb: float) -> None:
        """Walk the on_oom ladder proactively, before the allocator fails."""
        if self.on_oom is None:
            self.pressure = None
            return
        self.counters.watermark_triggers += 1
        log.warning("watermark pressure: %.1f MB >= %.1f MB limit at step "
                    "%d; degrading proactively", measured_mb,
                    self.pressure.limit_mb, self.step)
        self.degrade_trigger = "watermark"
        try:
            swapped = self.on_oom(self)
        finally:
            self.degrade_trigger = "oom"
        if swapped is not None:
            self.params, self.opt_state = swapped
            self.counters.degradations += 1
            self.straggler.reset()
            self._save_now()
        else:
            # ladder exhausted: nothing cheaper exists, stop re-checking
            log.warning("watermark pressure with no rung left; trigger "
                        "disabled for the rest of the run")
            self.pressure = None

    # ------------------------------------------------------------------ run
    def run(self):
        from repro_torch.runtime.guard import update_norm as _update_norm

        self.step, self.params, self.opt_state = self._restore()
        tel = self.telemetry
        results = []
        while self.step < self.total_steps:
            t0 = time.monotonic()
            failure = None
            new_params = new_opt = loss = batch = None
            try:
                if self.injector is not None:
                    self.injector.before_step(self.step)
                # one flag check on the hot path: the disabled branch runs
                # the exact pre-telemetry code, no span/context allocation
                if tel.enabled:
                    with tel.span("data_fetch"):
                        batch = next(self.batch_iter)
                    with tel.span("step"):
                        new_params, new_opt, loss = self.step_fn(
                            self.params, self.opt_state, batch)
                else:
                    batch = next(self.batch_iter)
                    new_params, new_opt, loss = self.step_fn(
                        self.params, self.opt_state, batch)
                if self.injector is not None:
                    loss = self.injector.after_step(self.step, loss)
                lossf = float(loss)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                failure, tb = e, "".join(traceback.format_tb(e.__traceback__))
                _drop_tracebacks(e)
            if failure is not None:
                # outside the except block: no frame of the failed step is
                # alive while the failure is answered
                self._handle_failure(failure, tb)
                _release_memory()
                continue
            if self.guard is not None:
                unorm = (_update_norm(self.params, new_params)
                         if self.guard.track_update_norm else None)
                if self.guard.observe(lossf, update_norm=unorm,
                                      step=self.step) == "reject":
                    self.counters.guard_skips += 1
                    continue      # rewind: update discarded, batch skipped
            dt = time.monotonic() - t0
            verdict = self.straggler.observe(dt)
            if verdict == "restart":
                self.counters.straggler_restarts += 1
                if self.counters.straggler_restarts > self.restart_budget:
                    raise RestartRequired(
                        f"step {self.step}: {dt:.1f}s >= "
                        f"{self.straggler.factor}x EWMA for "
                        f"{self.straggler.limit} consecutive steps")
                log.warning("straggler watchdog: supervised restart %d/%d "
                            "at step %d (%.1fs step)",
                            self.counters.straggler_restarts,
                            self.restart_budget, self.step, dt)
                new_params = new_opt = None
                self.step, self.params, self.opt_state = self._restore()
                continue
            elif verdict == "slow":
                log.warning("step %d slow: %.2fs vs EWMA %.2fs",
                            self.step, dt, self.straggler.mean or 0.0)
            self.params, self.opt_state = new_params, new_opt
            new_params = new_opt = None       # the loop holds the only refs
            self._consecutive_failures = 0    # budget resets on success
            self.step += 1
            res = StepResult(self.step, lossf, dt,
                             retried=self.counters.total_faults > 0)
            results.append(res)
            if tel.enabled:
                from repro_torch.telemetry import StepEvent
                tel.emit(StepEvent(step=self.step, loss=lossf, seconds=dt))
                tel.registry.counter("train.steps").inc()
                tel.registry.gauge("train.loss").set(lossf)
                tel.registry.histogram("train.step_seconds").record(dt)
            if self.memwatch is not None:
                self._sample_watermark()
            if self.on_step:
                self.on_step(res)
            saved = self.ckpt.maybe_save(
                self.step, self.params, self.opt_state,
                data_state=self._data_state_dict(),
                extra=self.extra_fn() if self.extra_fn else None)
            if saved:
                self._last_saved = self.step
                if tel.enabled:
                    from repro_torch.telemetry import CheckpointEvent
                    tel.emit(CheckpointEvent(action="save", step=self.step,
                                             path=self.ckpt.directory))
                    tel.registry.counter("ckpt.saves").inc()
        # forced final save: a completed run is always resumable/servable
        # from its last step, even when total_steps % interval != 0
        if self.step > 0 and self._last_saved != self.step:
            self._save_now()
        if self.injector is not None:
            self.counters.injected = self.injector.summary()
        self.counters.ckpt_quarantines = len(
            getattr(self.ckpt, "quarantined", ()))
        return self.params, self.opt_state, results, self.counters

