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

Each rank runs on one device (``spec.device``; ``cuda`` fails without a
card rather than falling back). Over several ranks of a ``torch.
distributed`` process group the Trainer holds a (data, model) mesh
(``runtime/elastic.py``; ``spec.model_parallel`` ranks on the model
axis): every rank keeps its shard of the model (the placement rules of
``launch/sharding.py``: Megatron tensor parallelism for the dense family,
with sequence parallelism where the sequence divides over the model axis,
derived on every switch as the reference's ``act_spec`` is), steps on its
data index's rows of the global batch (``spec.batch``), sums its partial
LoRA gradients over the model axis and all-reduces the LoRA gradients and
the loss over the data axis inside each engine's step (``policy.tp``,
``policy.dp``); ``shard_state`` places the state from the mesh's first
rank by its specs, ``gather_state`` gathers it whole, and ``resize``
moves the run onto a surviving rank set or another model axis, keeping
the global batch. Only rank 0 touches the checkpoints: a save gathers the
state whole, rank 0 writes it, and on a restore it alone picks the step
(quarantining corrupt ones), which every other rank then loads read-only
and places by the live mesh's specs (``checkpoint/mesh.py``); telemetry
writes ``worker_<rank>.jsonl``. Each engine's step is called as built:
there is no jit. Restore templates are made on the ``meta`` device
(shapes and dtypes only), so a restore never holds a second model's worth
of weights beside the one it loads.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, Optional

import torch

from repro_torch.api.registry import Engine, get_engine
from repro_torch.api.spec import TrainSpec, check_model_axis
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.mesh import MeshCheckpointer
from repro_torch.launch import sharding
from repro_torch.runtime import elastic
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


def _to_device(v, device):
    """A batch entry on ``device``: token ids and labels as int64, float
    inputs (a vlm's ``frontend_embeds``, an audio model's ``enc_frames``)
    as they are."""
    t = torch.from_numpy(v)
    return (t if t.is_floating_point() else t.long()).to(device)


def _to_meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


class Trainer:
    """One training run, fully described by a TrainSpec.

    ``cfg`` overrides the spec's ``arch``/``reduced`` resolution with an
    explicit ArchConfig.
    """

    def __init__(self, spec: TrainSpec, *, cfg=None, mesh=None):
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
        self._set_mesh(mesh if mesh is not None else self._auto_mesh(spec))
        self._switch_to(self.spec)

    @classmethod
    def from_spec(cls, spec: TrainSpec, *, cfg=None, mesh=None
                  ) -> "Trainer":
        return cls(spec, cfg=cfg, mesh=mesh)

    # -------------------------------------------------------------- sharding
    @staticmethod
    def _auto_mesh(spec: TrainSpec):
        """A (data, model) mesh over the process group's ranks; ``None``
        (no mesh, the single-process run) at world size 1 with
        ``model_parallel == 1``, as in the reference."""
        n = elastic.world_size()
        if n == 1 and spec.model_parallel == 1:
            return None
        return elastic.make_mesh_from_devices(list(range(n)),
                                              spec.model_parallel)

    def _set_mesh(self, mesh) -> None:
        """Adopt ``mesh`` (None: no mesh). Collective: every rank of the
        world calls it with the same mesh (its process groups are made
        here). A rank left off the mesh gets ``dp`` and ``tp`` None and
        waits for the next resize; it must not step. ``tp`` is None too on
        a mesh whose model axis is 1."""
        self.mesh = mesh
        self.dp = self.tp = self.mesh_group = None
        self.on_mesh = True
        self._specs = {}
        if mesh is None:
            return
        self.mesh_group, data_group, model_group = elastic.mesh_groups(mesh)
        self.on_mesh = elastic.rank() in mesh.rank_list
        if self.on_mesh:
            self.dp = elastic.DataParallel(mesh, data_group)
            if mesh.model_size > 1:
                self.tp = elastic.ModelParallel(mesh, model_group)

    def param_specs(self):
        """The spec tree of the live spec's whole params on the mesh
        (``launch/sharding.py``, from ``state_template``), or None without
        a model axis."""
        if self.mesh is None or self.mesh.model_size == 1:
            return None
        key = self.live_spec.quantize
        if key not in self._specs:
            self._specs[key] = sharding.param_specs(
                self.cfg, self.state_template()[0], self.mesh)
        return self._specs[key]

    def _opt_specs(self, opt_state):
        pspec = self.param_specs()
        return None if pspec is None or opt_state is None \
            else sharding.opt_specs_like(opt_state, pspec)

    def place_state(self, params, opt_state=None):
        """This rank's shards of a whole state that every rank of the mesh
        holds alike (made from the seed, or read from a checkpoint):
        sliced by the live specs, nothing sent."""
        if self.mesh is not None:
            params = elastic.place_tree(params, self.mesh,
                                        self.param_specs())
            if opt_state is not None:
                opt_state = elastic.place_tree(opt_state, self.mesh,
                                               self._opt_specs(opt_state))
        return params if opt_state is None else (params, opt_state)

    def shard_state(self, params, opt_state=None, *, mesh=None):
        """Placement of a whole state on the mesh (``runtime.elastic.
        reshard_tree``: broadcast from the mesh's first rank, then sliced
        by ``launch/sharding.py``'s specs; values untouched). Returns
        ``params`` or ``(params, opt_state)`` mirroring the arguments."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is not None and elastic.rank() in mesh.rank_list:
            group = self.mesh_group if mesh is self.mesh else None
            pspec = sharding.param_specs(self.cfg, params, mesh)
            params = elastic.reshard_tree(params, mesh, pspec, group)
            if opt_state is not None:
                opt_state = elastic.reshard_tree(
                    opt_state, mesh,
                    sharding.opt_specs_like(opt_state, pspec), group)
        return params if opt_state is None else (params, opt_state)

    def gather_state(self, params, opt_state=None):
        """The whole state from this rank's shards (``runtime.elastic.
        gather_tree`` over its model axis); collective over the mesh. A
        round trip through :meth:`shard_state` is bit-exact."""
        if self.on_mesh and self.mesh is not None:
            group = self.tp.group if self.tp is not None else None
            ospec = self._opt_specs(opt_state)
            params = elastic.gather_tree(params, self.mesh,
                                         self.param_specs(), group)
            if opt_state is not None:
                opt_state = elastic.gather_tree(opt_state, self.mesh, ospec,
                                                group)
        return params if opt_state is None else (params, opt_state)

    def resize(self, devices=None, *, model_parallel=None, params=None,
               opt_state=None):
        """Elastic resize onto the surviving ranks ``devices`` (default:
        every rank of the world), and onto a model axis of
        ``model_parallel`` (default: the mesh's): a mesh and its process
        groups over them (``dist.new_group``, so every rank of the world
        calls this alike), the live spec's step rebuilt for it, and, when
        ``params`` / ``opt_state`` are passed, the state gathered whole on
        the old mesh and placed on the new one from its first rank. The
        global batch is kept: each rank's rows follow
        ``runtime.elastic.rebalance_batch``. Ranks left off the new mesh
        keep the whole state and wait (``on_mesh`` false). Returns
        ``None``, ``params`` or ``(params, opt_state)`` mirroring the state
        arguments."""
        devices = list(devices) if devices is not None \
            else list(range(elastic.world_size()))
        if model_parallel is None:
            model_parallel = (self.mesh.model_size if self.mesh is not None
                              else self.live_spec.model_parallel)
        if params is not None:
            params, opt_state = self.gather_state(params, opt_state)
        self._set_mesh(elastic.make_mesh_from_devices(devices,
                                                      model_parallel))
        live = self.live_spec
        self._live_spec = None    # rebuild the step over the new mesh
        self._switch_to(live)
        if params is None:
            return None
        if self.on_mesh:
            params, opt_state = self.shard_state(params, opt_state)
        return params if opt_state is None else (params, opt_state)

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (the whole of it without a
        mesh, or where its rows do not divide over the data axis:
        ``DataParallel.rows``)."""
        if self.dp is None:
            return batch
        rows = self.dp.rows(len(next(iter(batch.values()))))
        return {k: v[rows] for k, v in batch.items()}

    # ------------------------------------------------------------ live spec
    def _switch_to(self, spec: TrainSpec) -> None:
        """(Re)build engine + step for ``spec``; no-op if unchanged. Raises
        (without changing live state) when the engine refuses the spec —
        the degradation path uses that to skip unbuildable rungs (an engine
        or base the model axis refuses among them). The step takes the data
        pipeline's numpy batch and moves it to the device; over a mesh it
        sums the partial LoRA gradients over the model axis (``policy.tp``,
        with ``policy.sp`` where the sequence divides over it) and
        all-reduces the LoRA gradients and the loss over the data axis
        (``policy.dp``)."""
        if spec == self._live_spec:
            return
        spec = spec.validate()
        engine: Engine = get_engine(spec.engine)
        mp = 1 if self.mesh is None else self.mesh.model_size
        check_model_axis(self.cfg, mp, spec.engine, spec.quantize)
        policy = spec.policy()
        if self.dp is not None:
            # sequence parallelism is derived state: on where this spec's
            # sequence divides over the model axis (a truncated one may not)
            policy = dataclasses.replace(
                policy, dp=self.dp, tp=self.tp,
                sp=self.tp is not None and spec.seq % mp == 0)
        build = engine.build_step(spec, self.cfg, self.opt, policy)
        device = self.device

        def step_fn(params, opt_state, batch, _build=build):
            batch = {k: _to_device(v, device) for k, v in batch.items()}
            return _build(params, opt_state, batch)

        self.engine, self.policy, self.step_fn = engine, policy, step_fn
        self._live_spec = spec

    def absmax_reducer(self):
        """``quant.quantize_frozen_``'s ``reduce_for`` on this mesh: for a
        row-parallel weight shard (its input dim on ``model``), whose
        per-column absmax covers only this rank's rows, an all-reduce MAX
        over the model axis, so that the codes and scales are the single
        process's, sliced. None without a model axis."""
        if self.tp is None:
            return None
        tp = self.tp

        def reduce_for(path):
            if not sharding.row_parallel(path):
                return None
            return lambda amax: tp.all_reduce(amax, "max")

        return reduce_for

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
        """This rank's stream of the live spec's global batches: its
        host shard of the corpus and its share of the rows over a data
        mesh (``host_index`` / ``host_count``), or, where the batch does
        not divide over the mesh (a halved batch below the data size), the
        whole corpus and batch on every rank, so that the sync averages
        identical copies. The one rule of which rows a rank reads: a
        restore and a rung that changes the batch both rebuild the stream
        here."""
        from repro_torch.data import make_batch_iterator

        live = self.live_spec
        index, count = 0, 1
        if self.dp is not None and live.batch % self.dp.size == 0:
            index, count = self.dp.index, self.dp.size
        return make_batch_iterator(
            self.cfg.vocab, live.seq, live.batch, host_index=index,
            host_count=count, seed=self.spec.seed, state=state)

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
        from repro_torch.core import quant
        from repro_torch.data.pipeline import DataState, TokenStream
        from repro_torch.runtime import degrade as degrade_mod
        from repro_torch.runtime import faults as faults_mod
        from repro_torch.runtime.fault_tolerance import (ResilientLoop,
                                                         StragglerPolicy)
        from repro_torch.runtime.guard import StepGuard

        spec0 = self.spec
        total = steps if steps is not None else spec0.steps
        if not self.on_mesh:
            raise RuntimeError(f"rank {elastic.rank()} is not on the mesh "
                               f"{self.mesh.rank_list}: it cannot fit")
        self._switch_to(spec0)
        ckpt = (Checkpointer(spec0.ckpt_dir, interval=spec0.ckpt_interval)
                if self.mesh is None else MeshCheckpointer(
                    spec0.ckpt_dir, spec0.ckpt_interval, self.mesh,
                    self.mesh_group, self.gather_state))

        tel = telemetry if telemetry is not None \
            else tele.Telemetry.from_spec(
                spec0, worker=None if self.mesh is None else elastic.rank())
        injector = None
        if spec0.inject_faults:
            plan = faults_mod.FaultPlan.from_string(
                spec0.inject_faults, total_steps=total, seed=spec0.seed)
            # over a data mesh only rank 0 corrupts the files it wrote;
            # the others fire the event alike and touch nothing
            injector = faults_mod.FaultInjector(
                plan, ckpt_dir=spec0.ckpt_dir,
                corrupts=self.dp is None or self.dp.index == 0)
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
                params, opt_state = self.place_state(*self.init_state())
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
            return (restored["step"],) + self.place_state(
                restored["params"], restored["opt_state"])

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
                rewindow = cand.batch != live.batch or cand.seq != live.seq
                # a caller's iterator is re-windowed only when it is a
                # TokenStream of the whole batch (no data mesh)
                if rewindow and data is not None and (
                        self.dp is not None
                        or not isinstance(new_it, TokenStream)):
                    continue
                try:
                    self._switch_to(cand)
                except Exception as e:
                    log.debug("rung %s unbuildable: %s", rung, e)
                    continue
                if rewindow:
                    state = dataclasses.replace(new_it.state)
                    new_it = (self.make_data(state=state) if data is None
                              else TokenStream(new_it.tokens, cand.seq,
                                               cand.batch, state=state))
                params, opt_state = loop.params, loop.opt_state
                if cand.quantize != live.quantize:
                    # in place on the tree only the loop holds: each frozen
                    # leaf's source is freed as its codes land, one matrix
                    # of a stack at a time
                    quant.quantize_frozen_(params, method=cand.quantize,
                                           reduce_for=self.absmax_reducer())
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
