"""Trainer facade: ``Trainer.from_spec(spec).fit(steps)``
(``repro.api.trainer``).

Wraps everything a training run needs around a TrainSpec: config resolution,
engine lookup + validation, optimizer, restartable data pipeline, atomic
checkpointing and the supervised resilient step loop
(``runtime.fault_tolerance.ResilientLoop``) with the full chaos stack —
deterministic fault injection (``--inject-faults``), the memory-pressure
degradation ladder (``runtime/degrade.py``) and the anomaly step guard
(``runtime/guard.py``). ``launch/train.py``'s ``main`` runs through this
facade.

The trainer is *re-specable* mid-run: every checkpoint manifest records the
spec that produced it, so a restore after a crash reconstitutes the exact
(possibly degraded) program, and an OOM walks the ladder to a cheaper spec
while carrying the optimizer state across compatible transitions.

The port runs on one device (``spec.device``; ``cuda`` fails without a
card rather than falling back), so the reference's mesh, ``shard_state``
and elastic ``resize`` have no counterpart here (``ROADMAP.md`` item 8).
Each engine's step is called as built: there is no jit. Restore templates
are made on the ``meta`` device (shapes and dtypes only), so a restore never
holds a second model's worth of weights beside the one it loads.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, Optional

import torch

from repro_torch.api.registry import Engine, get_engine
from repro_torch.api.spec import TrainSpec
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    history: List  # of runtime.fault_tolerance.StepResult
    #: runtime.fault_tolerance.FaultCounters — per-fault accounting for the
    #: run (retries, OOMs, degradations, guard skips, restarts, quarantines)
    counters: Any = None
    #: the TrainSpec the run *ended* on (differs from the requested spec
    #: when the degradation ladder stepped down under memory pressure)
    final_spec: Optional[TrainSpec] = None
    #: ladder rungs applied, in order (e.g. ["halve_batch", "quantize_int8"])
    degradations: List[str] = dataclasses.field(default_factory=list)
    #: telemetry snapshot: guard state always (when guarded); with
    #: ``--telemetry on`` also the metric registry, events-by-kind, span
    #: totals and the measured watermark
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def final_loss(self) -> float:
        return self.history[-1].loss if self.history else float("nan")

    @property
    def fault_counts(self) -> dict:
        return self.counters.to_dict() if self.counters is not None else {}


#: TrainSpec fields recorded into checkpoint manifests (all of them: every
#: field round-trips through the CLI)
_SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(TrainSpec))


def _spec_manifest(spec: TrainSpec) -> dict:
    return {name: getattr(spec, name) for name in _SPEC_FIELDS}


def _to_meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


class Trainer:
    """One training run, fully described by a TrainSpec.

    ``cfg`` overrides the spec's ``arch``/``reduced`` resolution with an
    explicit ArchConfig.
    """

    def __init__(self, spec: TrainSpec, *, cfg=None):
        from repro_torch.configs import get_config
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.optim.schedules import constant

        self.spec = spec.validate()
        if spec.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA card and none is "
                               "visible; pass --device cpu to train on the "
                               "CPU")
        self.device = torch.device(spec.device)
        if cfg is None:
            cfg = get_config(spec.arch)
            if spec.reduced:
                cfg = cfg.reduced()
        self.cfg = cfg
        self.opt = make_optimizer(spec.optimizer, constant(spec.lr))
        self._live_spec: Optional[TrainSpec] = None
        self._switch_to(self.spec)

    @classmethod
    def from_spec(cls, spec: TrainSpec, *, cfg=None) -> "Trainer":
        return cls(spec, cfg=cfg)

    # ------------------------------------------------------------ live spec
    def _switch_to(self, spec: TrainSpec) -> None:
        """(Re)build engine + step for ``spec``; no-op if unchanged. Raises
        (without changing live state) when the engine refuses the spec —
        the degradation path uses that to skip unbuildable rungs. The step
        takes the data pipeline's numpy batch and moves it to the device."""
        if spec == self._live_spec:
            return
        spec = spec.validate()
        engine: Engine = get_engine(spec.engine)
        policy = spec.policy()
        build = engine.build_step(spec, self.cfg, self.opt, policy)
        device = self.device

        def step_fn(params, opt_state, batch, _build=build):
            batch = {k: torch.from_numpy(v).long().to(device)
                     for k, v in batch.items()}
            return _build(params, opt_state, batch)

        self.engine, self.policy, self.step_fn = engine, policy, step_fn
        self._live_spec = spec

    @property
    def live_spec(self) -> TrainSpec:
        """The spec currently built (post-degradation, if any)."""
        return self._live_spec or self.spec

    # ---------------------------------------------------------------- state
    def init_state(self):
        from repro_torch.models import model as model_lib

        live = self.live_spec
        gen = torch.Generator(device=self.device).manual_seed(self.spec.seed)
        params = model_lib.init_params(self.cfg, generator=gen,
                                       quantize=live.quantize)
        return params, self.opt.init(params)

    def state_template(self):
        """(params, opt_state) of the live spec as tensors on the ``meta``
        device: shapes and dtypes, no storage (the restore template). The
        dense tree is drawn under a fake-tensor mode and quantized on
        ``meta``, one matrix a stack."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.core.quant import quantize_params
        from repro_torch.models import model as model_lib

        with FakeTensorMode():
            fake = model_lib.init_params(self.cfg,
                                         generator=torch.Generator())
        params = quantize_params(_to_meta(fake), self.live_spec.quantize)
        return params, self.opt.init(params)

    def make_data(self, state=None):
        from repro_torch.data import make_batch_iterator

        live = self.live_spec
        return make_batch_iterator(
            self.cfg.vocab, live.seq, live.batch, host_index=0, host_count=1,
            seed=self.spec.seed, state=state)

    # ------------------------------------------------------------------ fit
    def fit(self, steps: Optional[int] = None, *,
            data=None, on_step: Optional[Callable] = None,
            straggler=None, telemetry=None) -> TrainResult:
        """Run ``steps`` (default: spec.steps) supervised resilient training
        steps, resuming from the latest checkpoint in ``spec.ckpt_dir`` if
        any. Fault injection, the degradation ladder and the step guard are
        all driven by the spec's resilience fields; observability by the
        spec's telemetry fields (or an explicitly passed ``telemetry``)."""
        from repro_torch import telemetry as tele
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.core import quant
        from repro_torch.data.pipeline import DataState, TokenStream
        from repro_torch.runtime import degrade as degrade_mod
        from repro_torch.runtime import faults as faults_mod
        from repro_torch.runtime.fault_tolerance import (ResilientLoop,
                                                         StragglerPolicy)
        from repro_torch.runtime.guard import StepGuard

        spec0 = self.spec
        total = steps if steps is not None else spec0.steps
        self._switch_to(spec0)
        ckpt = Checkpointer(spec0.ckpt_dir, interval=spec0.ckpt_interval)

        tel = telemetry if telemetry is not None \
            else tele.Telemetry.from_spec(spec0)
        injector = None
        if spec0.inject_faults:
            plan = faults_mod.FaultPlan.from_string(
                spec0.inject_faults, total_steps=total, seed=spec0.seed)
            injector = faults_mod.FaultInjector(plan,
                                               ckpt_dir=spec0.ckpt_dir)
            log.warning("chaos run: injecting faults [%s]", plan.to_string())
            if tel.enabled:
                injector.on_fire = lambda step, kind: tel.emit(
                    tele.FaultEvent(step=step, fault=kind, injected=True,
                                    source="injector"))
        guard = (StepGuard(budget=spec0.guard_budget,
                           telemetry=tel if tel.enabled else None)
                 if spec0.guard == "on" else None)
        ladder = (degrade_mod.DegradationLadder()
                  if spec0.degrade == "on" else None)
        straggler = straggler or StragglerPolicy(
            factor=spec0.straggler_factor,
            consecutive_limit=spec0.straggler_limit)
        # watermark monitor: on for telemetry runs, and whenever a memory
        # budget asks for proactive (pre-OOM) pressure handling
        memwatch = (tele.MemoryWatermark(device=self.device)
                    if tel.enabled or spec0.mem_budget_mb > 0 else None)
        pressure = (degrade_mod.WatermarkTrigger(spec0.mem_budget_mb)
                    if spec0.mem_budget_mb > 0 and ladder is not None
                    else None)

        def _log_step(res):
            tele.log_step(res, spec0.log_interval, quiet=spec0.quiet)
            if on_step:
                on_step(res)

        def extra_fn():
            return {"spec": _spec_manifest(self.live_spec)}

        def _sync_iter(loop, state):
            """Point the loop at an iterator matching the live spec's
            (seq, batch) positioned at ``state``."""
            live = self.live_spec
            if data is None:
                loop.batch_iter = self.make_data(state=state)
                return
            it = loop.batch_iter
            if state is not None:
                it.state = state
            elif loop._initial_data_state is not None:
                it.state = dataclasses.replace(loop._initial_data_state)
            if isinstance(it, TokenStream) and (it.seq_len != live.seq
                                                or it.batch != live.batch):
                loop.batch_iter = TokenStream(it.tokens, live.seq,
                                              live.batch, state=it.state)

        def restore_fn(loop):
            # the loop's trees go before anything is loaded: the restore
            # never holds the old weights beside the new
            loop.params = loop.opt_state = None

            def template_fn(extra):
                saved = (extra or {}).get("spec")
                target = (dataclasses.replace(spec0, **saved) if saved
                          else spec0)
                self._switch_to(target)
                return self.state_template()

            try:
                restored = ckpt.restore_latest(template_fn=template_fn,
                                               device=self.device)
            except IOError as e:
                # every checkpoint corrupt: restart from step 0 rather
                # than lose the job (counters record the quarantines)
                log.error("all checkpoints unrestorable (%s); "
                          "restarting from scratch", e)
                restored = None
            if restored is None:
                self._switch_to(spec0)
                params, opt_state = self.init_state()
                _sync_iter(loop, None)
                loop.step_fn = self.step_fn
                return 0, params, opt_state
            log.info("resuming from step %d (engine=%s batch=%d seq=%d "
                     "quantize=%s)", restored["step"], self.live_spec.engine,
                     self.live_spec.batch, self.live_spec.seq,
                     self.live_spec.quantize)
            state = (DataState.from_dict(restored["data_state"])
                     if restored["data_state"] else None)
            _sync_iter(loop, state)
            loop.step_fn = self.step_fn
            return restored["step"], restored["params"], restored["opt_state"]

        def on_oom(loop):
            if ladder is None:
                return None
            live = self.live_spec
            try:
                cands = list(ladder.candidates(live))
            except degrade_mod.LadderExhausted as e:
                log.error("OOM with no rung left: %s", e)
                return None
            for cand, rung in cands:
                new_it = loop.batch_iter
                if cand.batch != live.batch or cand.seq != live.seq:
                    if not isinstance(new_it, TokenStream):
                        continue    # can't re-window an opaque iterator
                    new_it = TokenStream(new_it.tokens, cand.seq, cand.batch,
                                         state=new_it.state)
                try:
                    self._switch_to(cand)
                except Exception as e:
                    log.debug("rung %s unbuildable: %s", rung, e)
                    continue
                params, opt_state = loop.params, loop.opt_state
                if cand.quantize != live.quantize:
                    # in place on the tree only the loop holds: each frozen
                    # leaf's source is freed as its codes land, one matrix
                    # of a stack at a time
                    quant.quantize_frozen_(params, method=cand.quantize)
                    opt_state = degrade_mod.carry_opt_state(
                        opt_state, None, params)
                loop.batch_iter = new_it
                loop.step_fn = self.step_fn
                ladder.record(rung)
                if tel.enabled:
                    tel.emit(tele.DegradeEvent(
                        step=loop.step, rung=rung,
                        trigger=loop.degrade_trigger, engine=cand.engine,
                        quantize=cand.quantize, batch=cand.batch,
                        seq_len=cand.seq))
                    tel.registry.counter("degrade.rungs").inc()
                log.warning(
                    "memory pressure: degraded via %r -> engine=%s batch=%d "
                    "seq=%d quantize=%s",
                    rung, cand.engine, cand.batch, cand.seq, cand.quantize)
                return params, opt_state
            return None

        it = data if data is not None else self.make_data()
        loop = ResilientLoop(
            self.step_fn, restore_fn, it, ckpt, total,
            max_retries=spec0.max_retries,
            restart_budget=8,    # supervised straggler restarts per run
            straggler=straggler, guard=guard, injector=injector,
            on_step=_log_step, on_oom=on_oom,
            extra_fn=extra_fn, telemetry=tel, memwatch=memwatch,
            pressure=pressure)
        if tel.enabled:
            tel.emit(tele.RunEvent(
                phase="start", engine=spec0.engine, quantize=spec0.quantize,
                arch=spec0.arch, spec=_spec_manifest(spec0)))
        try:
            params, opt_state, history, counters = loop.run()
            if tel.enabled:
                tel.emit(tele.RunEvent(
                    phase="end", engine=self.live_spec.engine,
                    quantize=self.live_spec.quantize, arch=spec0.arch,
                    steps=len(history),
                    final_loss=float(history[-1].loss) if history else None))
        finally:
            if telemetry is None:   # fit owns the lifecycle it created
                tel.close()
        metrics: dict = {}
        if guard is not None:
            metrics["guard"] = guard.state()
        if memwatch is not None:
            metrics["watermark"] = memwatch.compare()
        if tel.enabled:
            metrics["registry"] = tel.registry.snapshot()
            metrics["events_by_kind"] = tel.counts_by_kind()
            metrics["spans"] = tel.tracer.totals()
            metrics["telemetry_dir"] = tel.out_dir
        return TrainResult(
            params=params, opt_state=opt_state, history=history,
            counters=counters, final_spec=self.live_spec,
            degradations=list(ladder.applied) if ladder else [],
            metrics=metrics)
