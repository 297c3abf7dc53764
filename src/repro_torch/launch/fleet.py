"""A fleet of ranks on one host (``repro.launch.fleet``): real
multi-process data- and tensor-parallel training over
``torch.distributed``.

The reference emulates N devices in one XLA process. The port's
counterpart is N processes joined in a ``gloo`` process group on a free
local port (``tcp://localhost:<port>``), each one rank of the Trainer's
(data, model) mesh (``api/trainer.py``, ``runtime/elastic.py``; the spec's
``model_parallel`` ranks on the model axis). So the whole stack, the
Megatron collectives, the gradient sync, ``shard_state``, elastic
``resize``, rank-0 checkpoints and per-rank telemetry, runs for real on
the CPU, with no card.

Protocol: the parent writes a JSON payload (task + TrainSpec overrides),
:func:`run_fleet` starts N workers (``python -m repro_torch.launch.fleet
payload.json result.json``, each told its rank), and rank 0's JSON is the
result; tensors travel through ``torch.save`` files (payload ``"init"``
to start from given params, ``"out"`` for the final state). A worker that
fails or outlives the timeout fails the fleet: every worker is stopped.
Tasks (the reference's):

* ``train``: deterministic synthetic batches (a function of the seed, the
  step and the *global* shape) through the Trainer; each rank takes its
  data index's rows; returns the global losses (and with ``"out"`` the
  final state, gathered whole);
* ``collectives``: one step, with the bytes the sync handed to
  ``all_reduce`` (counted in ``DataParallel`` itself) beside the f32
  bytes of the rank's LoRA leaves and the two scalars (the valid-token
  count and the loss), ``runtime.elastic.predicted_grad_sync_bytes``, and
  the bytes handed to the model axis (``ModelParallel``); a world of 1
  all-reduces nothing;
* ``saved``: one ``value_and_grad`` under ``saved_tensors_hooks``, the
  shapes of what each rank's forward keeps (remat on and off);
* ``elastic``: a live resize through ``Trainer.resize`` along a plan of
  (ranks, model axis, steps), by default N → N/2 → N, against the
  checkpoint path (whole host copies, a fresh Trainer a mesh) and an
  uninterrupted run, all inside the fleet;
* ``ladder``: every degradation-ladder rung from the spec builds and takes
  a step on the mesh (a halved batch below the data size included: every
  rank then takes the whole batch), with a digest of the frozen base
  gathered whole after each quantize rung;
* ``fit``: ``Trainer.fit`` itself on the data mesh, faults, ladder,
  rank 0's checkpoints and restores included, with the rows each rank
  read a step;
* ``probe``: the mesh's geometry, no model;
* ``sequence``: several of the above in one process group
  (``"payloads"``), to share the workers' start-up.

A task at ``model_parallel`` above 1 runs what ``TrainSpec.validate``
takes (the dense family under mesp, mesp_cuda, mebp or store_h) and
raises for the rest (``ROADMAP.md`` §1, item 3).
"""
from __future__ import annotations

import dataclasses
import datetime
import glob
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import List, Optional

#: steps discarded from the front of every timing series (warm-up)
WARMUP_STEPS = 1


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost (bound once and released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def fleet_env(env: Optional[dict] = None) -> dict:
    """A worker's environment: a copy of this one with the port's ``src``
    on ``PYTHONPATH`` and one compute thread a rank unless asked
    otherwise."""
    env = dict(os.environ if env is None else env)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def run_fleet(payload: dict, *, devices: int, timeout: float = 300.0) -> dict:
    """Run one task on a fleet of ``devices`` ranks and return rank 0's
    result dict. Raises RuntimeError (with the workers' stderr tails) when
    a worker fails or reports an error, TimeoutError when the fleet
    outlives ``timeout`` seconds (every worker is stopped either way)."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_fleet_") as td:
        ppath = os.path.join(td, "payload.json")
        rpath = os.path.join(td, "result.json")
        with open(ppath, "w") as f:
            json.dump({**payload, "port": free_port(),
                       "world_size": devices, "timeout": timeout}, f)
        logs, procs = [], []
        for rank in range(devices):
            logs.append(open(os.path.join(td, f"stderr_{rank}"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.fleet", ppath,
                 rpath, str(rank)], env=fleet_env(), stdout=subprocess.DEVNULL,
                stderr=logs[-1]))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    _stop(procs)
                    raise TimeoutError(f"fleet of {devices} ranks outlived "
                                       f"{timeout} s ({payload.get('task')})")
                time.sleep(0.05)
        finally:
            _stop(procs)
        tails = []
        for rank, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {rank} rc={procs[rank].returncode}\n"
                         + log.read()[-3000:])
            log.close()
        result = None
        if os.path.exists(rpath):
            with open(rpath) as f:
                result = json.load(f)
        if result is None or any(p.returncode != 0 for p in procs):
            err = (result or {}).get("error", "")
            raise RuntimeError(f"fleet of {devices} ranks failed: {err}\n"
                               + "\n".join(tails))
    if result.get("status") != "ok":
        raise RuntimeError(f"fleet of {devices} ranks errored:\n"
                           f"{result.get('error')}\n"
                           f"{result.get('traceback', '')[-4000:]}")
    return result


def merge_fleet_telemetry(telemetry_dir: str,
                          out_name: str = "fleet.jsonl") -> Optional[str]:
    """Merge the per-rank ``worker_<rank>.jsonl`` shards under
    ``telemetry_dir`` into one deterministic timeline (sorted by ``(ts,
    worker, seq)``, ``telemetry.events.merge_jsonl_shards``). Returns the
    merged path, or None when no shard exists."""
    from repro_torch.telemetry.events import merge_jsonl_shards

    shards: List[str] = sorted(
        glob.glob(os.path.join(telemetry_dir, "worker_*.jsonl")))
    if not shards:
        return None
    out = os.path.join(telemetry_dir, out_name)
    merge_jsonl_shards(shards, out)
    return out


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


def synth_batch(cfg, batch: int, seq: int, seed: int, step: int,
                drop: float = 0.0) -> dict:
    """Deterministic synthetic batch: a function of (seed, step) and the
    *global* shape, so every rank count sees the same data. ``drop``: the
    share of labels set to -1 (ignored), so that ranks hold different
    numbers of valid tokens. A ``vlm`` model also gets its
    ``frontend_embeds`` [batch, frontend_tokens, d] (their labels are -1
    in its loss)."""
    import numpy as np

    rng = np.random.default_rng((seed, step))
    toks = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    labels = toks.copy()
    if drop:
        labels[rng.random((batch, seq)) < drop] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        out["frontend_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def _refuse_model_axis(payload: dict) -> None:
    """A task's spec at a model axis above 1 must be one the model axis
    runs (``TrainSpec.validate``: the dense family, an engine of
    ``MODEL_AXIS_ENGINES``, an axis that divides the heads, d_ff and the
    vocabulary); it raises before any rank builds a Trainer."""
    if int(payload.get("spec", {}).get("model_parallel", 1)) > 1:
        _spec(payload).validate()


def _spec(payload: dict):
    from repro_torch.api.spec import TrainSpec

    spec = TrainSpec(**{"device": "cpu", **payload.get("spec", {})})
    if spec.device != "cpu":
        raise ValueError("the fleet runs gloo ranks on the CPU: "
                         f"--device {spec.device} is not taken")
    return spec


def _make_trainer(payload: dict, mesh=None):
    from repro_torch.api.trainer import Trainer

    return Trainer.from_spec(_spec(payload), mesh=mesh)


def _init_state(tr, payload: dict):
    """The Trainer's fresh state, or the params of ``payload["init"]`` (a
    ``torch.save`` file) with a fresh optimizer state."""
    import torch

    if not payload.get("init"):
        return tr.init_state()
    params = torch.load(payload["init"], weights_only=True)
    return params, tr.opt.init(params)


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone() if hasattr(t, "clone") else t, tree)


def _worker_telemetry(payload: dict, rank: int):
    """Per-rank Telemetry writing ``worker_<rank>.jsonl`` when the payload
    carries ``telemetry_dir`` (merge with :func:`merge_fleet_telemetry`);
    the DISABLED singleton otherwise."""
    from repro_torch import telemetry as tele

    tdir = payload.get("telemetry_dir")
    if not tdir:
        return tele.DISABLED
    os.makedirs(tdir, exist_ok=True)
    return tele.Telemetry(enabled=True, out_dir=tdir, worker=rank)


def _steps(tr, params, opt_state, payload, start, n, losses, times=None):
    """``n`` steps of the Trainer from global step ``start`` on this rank's
    rows of the synthetic batches."""
    spec = tr.live_spec
    for step in range(start, start + n):
        batch = tr.local_batch(synth_batch(
            tr.cfg, spec.batch, spec.seq, spec.seed, step,
            payload.get("label_drop", 0.0)))
        t0 = time.perf_counter()
        params, opt_state, loss = tr.step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if times is not None:
            times.append(time.perf_counter() - t0)
    return params, opt_state


def task_train(payload: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch import telemetry as tele
    from repro_torch.runtime import elastic

    tr = _make_trainer(payload)
    params, opt_state = tr.shard_state(*_init_state(tr, payload))
    spec = tr.live_spec
    tel = _worker_telemetry(payload, elastic.rank())
    steps = int(payload.get("steps", spec.steps))
    tel.emit(tele.RunEvent(phase="start", engine=spec.engine,
                           quantize=spec.quantize, arch=spec.arch,
                           steps=steps))
    losses, times = [], []
    try:
        for step in range(steps):
            with tel.span("step"):
                params, opt_state = _steps(tr, params, opt_state, payload,
                                           step, 1, losses, times)
            tel.emit(tele.StepEvent(step=step, loss=losses[-1],
                                    seconds=times[-1]))
        tel.emit(tele.RunEvent(phase="end", steps=len(losses),
                               final_loss=losses[-1] if losses else 0.0))
    finally:
        tel.close()
    if payload.get("out"):
        params, opt_state = tr.gather_state(params, opt_state)
        if elastic.rank() == 0:
            torch.save({"params": params, "opt": opt_state}, payload["out"])
    steady = times[WARMUP_STEPS:] or times
    result = {"losses": losses, "step_times_s": times,
              "step_time_s": float(np.median(steady)),
              "devices": elastic.world_size(),
              "mesh": {} if tr.mesh is None else tr.mesh.shape}
    if tel.enabled and tel.out_dir:
        result["telemetry_shard"] = os.path.join(
            tel.out_dir, f"worker_{tel.worker}.jsonl")
    return result


def task_collectives(payload: dict) -> dict:
    from repro_torch.models.model import split_params
    from repro_torch.models.parallel import partial_numel
    from repro_torch.runtime import elastic
    from repro_torch.tree import tree_leaves

    tr = _make_trainer(payload)
    whole, opt_state = tr.init_state()
    n_trainable = sum(t.numel() for t in tree_leaves(split_params(whole)[0]))
    params, opt_state = tr.shard_state(whole, opt_state)
    del whole
    train, _ = split_params(params)
    n_rank = sum(t.numel() for t in tree_leaves(train))
    if tr.dp is not None:
        tr.dp.bytes_all_reduced = 0
    if tr.tp is not None:
        tr.tp.bytes_model_axis = 0
    _steps(tr, params, opt_state, payload, 0, 1, [])
    shape = {} if tr.mesh is None else tr.mesh.shape
    data = 1 if tr.mesh is None else tr.mesh.data_size
    return {"all_reduce_bytes": 0 if tr.dp is None
            else tr.dp.bytes_all_reduced,
            "bytes_model_axis": 0 if tr.tp is None
            else tr.tp.bytes_model_axis,
            "n_trainable": int(n_trainable),
            "rank_trainable": int(n_rank),
            "partial_numel": int(partial_numel(train)),
            "trainable_f32_bytes": 4 * int(n_rank),
            # the rank's LoRA leaves in f32 plus the valid-token count and
            # the loss
            "predicted_grad_sync_bytes":
                4 * (int(n_rank) + 2) if data > 1 else 0,
            "grad_sync_floor": elastic.predicted_grad_sync_bytes(
                int(n_trainable), shape),
            "sp": bool(tr.policy.sp),
            "devices": elastic.world_size(), "mesh": shape}


def task_saved(payload: dict) -> dict:
    """The shapes of the tensors one ``value_and_grad`` on this rank's rows
    hands to autograd to keep (``saved_tensors_hooks``), with remat on and
    off; those that share storage with a parameter are left out."""
    import torch

    from repro_torch.core import mesp
    from repro_torch.tree import tree_leaves

    tr = _make_trainer(payload)
    params, _ = tr.shard_state(*tr.init_state())
    spec = tr.live_spec
    batch = {k: torch.from_numpy(v).long() for k, v in tr.local_batch(
        synth_batch(tr.cfg, spec.batch, spec.seq, spec.seed, 0)).items()}
    stores = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    out = {}
    for remat in (True, False):
        shapes = []

        def pack(t):
            if t.untyped_storage().data_ptr() not in stores:
                shapes.append(list(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            mesp.value_and_grad(params, tr.cfg, batch, policy=dataclasses
                                .replace(tr.policy, remat=remat))
        out["remat" if remat else "no_remat"] = shapes
    return {**out, "sp": bool(tr.policy.sp),
            "mesh": {} if tr.mesh is None else tr.mesh.shape}


def task_elastic(payload: dict) -> dict:
    """A live resize along ``payload["plan"]``, [[ranks, model axis,
    steps], ...] (by default N → N/2 → N at the spec's model axis, the
    steps of ``"phases"``), three ways, inside the fleet:

    * A: uninterrupted on the first phase's mesh (the reference
      trajectory);
    * B: live resize through ``Trainer.resize`` at the phase boundaries;
    * C: the checkpoint path: the state gathered whole, through host
      copies, and a fresh Trainer a mesh placing it (what a real restore
      does).

    B and C run the same sequence of steps on the same meshes, so they
    must be bit-identical; A sums the ranks' gradients over another
    grouping, so it agrees only to float tolerance. Also a
    ``reshard_tree`` / ``gather_tree`` round trip onto the second phase's
    mesh and back, which must be bit-exact."""
    import torch

    from repro_torch.api.trainer import Trainer
    from repro_torch.runtime import elastic
    from repro_torch.tree import tree_leaves, tree_map

    spec = _spec(payload)
    n_full = elastic.world_size()
    phases = payload.get("phases", [2, 2, 2])
    mp = spec.model_parallel
    plan = payload.get("plan") or [
        [n_full, mp, phases[0]],
        [int(payload.get("shrink_to", max(n_full // 2, 1))), mp, phases[1]],
        [n_full, mp, phases[2]]]
    meshes = [elastic.make_mesh_from_devices(list(range(n)), m)
              for n, m, _ in plan]
    total = sum(n for _, _, n in plan)
    me = elastic.rank()

    # --- A: uninterrupted on the first mesh
    tr_a = Trainer.from_spec(spec, mesh=meshes[0])
    params_a, opt_a = tr_a.shard_state(*tr_a.init_state())
    losses_a = []
    params_a, opt_a = _steps(tr_a, params_a, opt_a, payload, 0, total,
                             losses_a)
    whole_a = tr_a.gather_state(params_a)

    # --- reshard_tree / gather_tree round trip (placement only)
    from repro_torch.launch import sharding
    moved = meshes[1]
    groups = elastic.mesh_groups(moved)  # collective: every rank makes them
    back = whole_a
    if me in moved.rank_list:
        specs = sharding.param_specs(tr_a.cfg, whole_a, moved)
        placed = elastic.reshard_tree(_clone(whole_a), moved, specs,
                                      groups[0])
        back = elastic.gather_tree(placed, moved, specs, groups[2])
    reshard_bitexact = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(whole_a), tree_leaves(back)))

    # --- B: live resize through the Trainer
    tr = Trainer.from_spec(spec, mesh=meshes[0])
    params_b, opt_b = tr.shard_state(*tr.init_state())
    losses_b, step = [], 0
    for i, (n, m, k) in enumerate(plan):
        if i > 0:
            params_b, opt_b = tr.resize(list(range(n)), model_parallel=m,
                                        params=params_b, opt_state=opt_b)
        if tr.on_mesh:
            params_b, opt_b = _steps(tr, params_b, opt_b, payload, step, k,
                                     losses_b)
        step += k
    params_b, opt_b = tr.gather_state(params_b, opt_b)

    # --- C: the checkpoint path (whole host copies, a fresh Trainer a mesh)
    to_host = lambda tree: tree_map(
        lambda t: t.detach().cpu().clone() if hasattr(t, "clone") else t,
        tree)
    losses_c, state, step = [], None, 0
    for mesh, (_, _, k) in zip(meshes, plan):
        trc = Trainer.from_spec(spec, mesh=mesh)
        if state is None:
            state = trc.init_state()
        if trc.on_mesh:
            params_c, opt_c = trc.shard_state(*state)
            params_c, opt_c = _steps(trc, params_c, opt_c, payload, step, k,
                                     losses_c)
            state = to_host(trc.gather_state(params_c, opt_c))
        step += k

    same = lambda u, v: all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(tree_leaves(u), tree_leaves(v)))
    b_vs_c_bitwise = (losses_b == losses_c and same(params_b, state[0])
                      and same(opt_b, state[1]))
    b_vs_a_maxdiff = max(float((x.double() - y.double()).abs().max())
                         for x, y in zip(tree_leaves(whole_a),
                                         tree_leaves(params_b))
                         if x.is_floating_point())
    return {"reshard_bitexact": bool(reshard_bitexact),
            "b_vs_c_bitwise": bool(b_vs_c_bitwise),
            "b_vs_a_maxdiff": b_vs_a_maxdiff,
            "losses_a": losses_a, "losses_b": losses_b,
            "losses_c": losses_c, "devices": n_full,
            "shrink_to": plan[1][0], "plan": plan}


def task_ladder(payload: dict) -> dict:
    """Every degradation-ladder rung reachable from the spec builds and
    takes a step on the mesh: a halved batch below the data size (every
    rank takes the whole batch), the int8 rung's ``{"q", "scale"}``
    leaves (and from an int8 base the int4 rung's), a truncated sequence.
    After a quantize rung, the SHA-256 of the frozen base gathered whole
    (``"base_sha256"``: every rank's shards quantized in place, the
    row-parallel ones over the model axis's absmax)."""
    import hashlib
    import math

    import torch

    from repro_torch.models.model import split_params
    from repro_torch.tree import tree_leaves

    from repro_torch.core import quant
    from repro_torch.runtime import degrade as degrade_mod
    from repro_torch.runtime import elastic

    tr = _make_trainer(payload)
    base = tr.live_spec
    params0, opt0 = tr.shard_state(*tr.init_state())
    rungs = []
    for cand, rung in degrade_mod.DegradationLadder().candidates(base):
        try:
            tr._switch_to(cand)
        except Exception as e:   # an unbuildable rung (the Trainer skips it)
            rungs.append({"rung": rung, "built": False,
                          "reason": f"{type(e).__name__}: {e}"})
            continue
        params, opt_state = _clone(params0), opt0
        digest = None
        if cand.quantize != base.quantize:
            quant.quantize_frozen_(params, method=cand.quantize,
                                   reduce_for=tr.absmax_reducer())
            opt_state = degrade_mod.carry_opt_state(opt_state, None, params)
            h = hashlib.sha256()
            for t in tree_leaves(split_params(tr.gather_state(params))[1],
                                 sort=True):
                h.update(t.contiguous().view(-1).view(torch.uint8)
                         .numpy().tobytes())
            digest = h.hexdigest()
        live = tr.live_spec
        losses = []
        _steps(tr, params, opt_state, payload, 0, 1, losses)
        rows = tr.dp.rows(live.batch) if tr.dp else slice(0, live.batch)
        rungs.append({"rung": rung, "built": True, "loss": losses[0],
                      "finite": math.isfinite(losses[0]),
                      "batch": live.batch, "seq": live.seq,
                      "engine": live.engine, "quantize": live.quantize,
                      "rows": rows.stop - rows.start, "sp": tr.policy.sp,
                      "base_sha256": digest})
        tr._switch_to(base)   # reset for the next rung
    return {"rungs": rungs, "devices": elastic.world_size(),
            "mesh": {} if tr.mesh is None else tr.mesh.shape}


class _Recorded:
    """An iterator over ``it``'s batches that logs each batch's rows and a
    digest of its tokens into ``log``: which rows a rank read."""

    def __init__(self, it, log: list):
        self.it, self.log = it, log

    @property
    def state(self):
        return self.it.state

    @state.setter
    def state(self, value):
        self.it.state = value

    def __iter__(self):
        return self

    def __next__(self):
        import hashlib

        import numpy as np

        batch = next(self.it)
        toks = np.ascontiguousarray(batch["tokens"])
        self.log.append([int(toks.shape[0]),
                         hashlib.sha256(toks.tobytes()).hexdigest()[:16]])
        return batch


def task_fit(payload: dict) -> dict:
    """``Trainer.fit`` on the data mesh: the resilient loop with the spec's
    faults, the degradation ladder, rank 0's checkpoints and every rank's
    restore, each rank on the stream ``Trainer.make_data`` gives it. Rank
    0 returns the history and, for every rank, the rows it read a step
    (``_Recorded``), a digest of its final params and its fault counts."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.runtime import elastic
    from repro_torch.tree import tree_leaves

    tr = _make_trainer(payload)
    read: list = []
    make_data = tr.make_data
    tr.make_data = lambda state=None: _Recorded(make_data(state=state), read)
    res = tr.fit()
    h = hashlib.sha256()
    for t in tree_leaves(tr.gather_state(res.params)):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    mine = {"read": read, "params": h.hexdigest(),
            "counts": res.fault_counts}
    ranks = [None] * elastic.world_size()
    dist.all_gather_object(ranks, mine)
    return {"history": [[r.step, r.loss] for r in res.history],
            "degradations": res.degradations,
            "final_batch": res.final_spec.batch, "ranks": ranks,
            "devices": elastic.world_size(),
            "mesh": {} if tr.mesh is None else tr.mesh.shape}


def task_probe(payload: dict) -> dict:
    """Topology only: the mesh over the fleet's ranks and its geometry."""
    from repro_torch.runtime import elastic

    mesh = elastic.make_mesh_from_devices(
        list(range(elastic.world_size())), payload.get("model_parallel", 1),
        pods=payload.get("pods", 1))
    return {"axis_names": list(mesh.axis_names), "mesh": mesh.shape,
            "devices": elastic.world_size()}


def task_sequence(payload: dict) -> dict:
    """Each of ``payload["payloads"]`` in turn, in this one process
    group."""
    return {"results": [_run_task(p) for p in payload["payloads"]]}


TASKS = {"train": task_train, "collectives": task_collectives,
         "saved": task_saved,
         "elastic": task_elastic, "ladder": task_ladder, "fit": task_fit,
         "probe": task_probe, "sequence": task_sequence}


def _run_task(payload: dict) -> dict:
    _refuse_model_axis(payload)
    return TASKS[payload.get("task", "train")](payload)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print("usage: python -m repro_torch.launch.fleet payload.json "
              "result.json rank", file=sys.stderr)
        return 2
    import torch.distributed as dist

    with open(argv[0]) as f:
        payload = json.load(f)
    rank = int(argv[2])
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{payload['port']}", rank=rank,
        world_size=int(payload["world_size"]),
        timeout=datetime.timedelta(seconds=float(payload["timeout"])))
    rc = 0
    try:
        result = _run_task(payload)
        result["status"] = "ok"
    except Exception as e:   # reported through the JSON channel
        result = {"status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()}
        rc = 1
    if rank == 0 or rc:
        path = argv[1] if rank == 0 else f"{argv[1]}.{rank}"
        with open(path, "w") as f:
            json.dump(result, f, default=str)
    if rc:
        sys.stderr.write(result["traceback"])
        sys.stderr.flush()
        os._exit(rc)          # peers may still wait in a collective
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
