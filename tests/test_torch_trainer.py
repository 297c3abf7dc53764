"""The port's Trainer facade (``repro_torch.api.trainer``) against the
reference's (``repro.api.trainer``), on the CPU.

The fault matrix is the reference's own (``tests/test_resilience.py``:
reduced qwen2.5-0.5b, f32, seq 32, batch 2, lr 5e-3, checkpoint interval
3), run through both trainers side by side on ``mesp`` and on the kernel
engine (``mesp_cuda`` here, whose wrappers take their plain versions on CPU
tensors; ``mesp_pallas`` in interpret mode there). The port's ``init_state``
returns the bridge of the reference's ``init_params``, so both start from
the same weights; the data pipelines are the same code from the same seed.
Each pair must agree on the per-step losses (1e-4 relative), every fault
counter but ``backoff_seconds``, the rungs applied, the final spec, the
checkpoint directories on disk and the final LoRA leaves (1e-5). The
reference's ladder runs with its memory model switched off
(``_import_memsim`` raises ImportError), the port having none yet. One
reference run per scenario is shared through module-scoped fixtures.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.runtime.degrade as jdegrade
import repro.runtime.fault_tolerance as jft
import repro.runtime.faults as jfaults
from repro.api import Trainer as JaxTrainer
from repro.api import TrainSpec as JaxSpec
from repro.api.spec import build_arg_parser as jax_arg_parser
from repro.configs import get_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api.spec import TrainSpec, build_arg_parser
from repro_torch.api.trainer import Trainer
from repro_torch.launch import train as ttrain
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import faults as tfaults

#: the port's engine -> the reference engine it is held against
JAX_ENGINE = {"mesp": "mesp", "mesp_cuda": "mesp_pallas"}
STEPS, CHAOS_STEPS = 8, 12
CHAOS = "oom@2,corrupt@4,crash@5,nan@8,stall@10:0.6"
#: scenario -> (TrainSpec overrides, engines it runs on). The chaos plan
#: holds the reference's single-fault cases oom@3 (here at 2), nan@4 (at
#: 8) and corrupt@4,crash@5, so they run once, inside it.
SCENARIOS = {
    "clean": ({}, ("mesp",)),
    "crash": ({"inject_faults": "crash@5"}, ("mesp",)),
    "oom_no_ladder": ({"inject_faults": "oom@3", "degrade": "off"},
                      ("mesp",)),
    "chaos": ({"steps": CHAOS_STEPS, "inject_faults": CHAOS},
              ("mesp", "mesp_cuda")),
}
CASES = [(s, e) for s, (_, engines) in SCENARIOS.items() for e in engines]
LOSS_RTOL, LEAF_TOL = 1e-4, 1e-5
JCFG = get_config("qwen2.5-0.5b").reduced()


def _no_memsim():
    raise ImportError("memsim switched off: the port has no memory model")


@pytest.fixture(autouse=True)
def _reference_without_memsim(monkeypatch):
    monkeypatch.setattr(jdegrade, "_import_memsim", _no_memsim)


class BridgedTrainer(Trainer):
    """The port's Trainer whose fresh state is the reference's
    ``init_params`` for the live spec, bridged through numpy."""

    def init_state(self):
        jp = JM.init_params(jax.random.PRNGKey(self.spec.seed), JCFG,
                            quantize=self.live_spec.quantize)
        params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                               jp))
        return params, self.opt.init(params)


def _specs(root, name, engine, **kw):
    kw = {"arch": "qwen2.5-0.5b", "reduced": True, "steps": STEPS,
          "seq": 32, "batch": 2, "lr": 5e-3, "ckpt_interval": 3, **kw}
    jspec = JaxSpec(engine=JAX_ENGINE[engine],
                    ckpt_dir=str(root / f"jax_{name}"), **kw)
    tspec = TrainSpec(engine=engine, device="cpu",
                      ckpt_dir=str(root / f"torch_{name}"), **kw)
    return jspec, tspec


def _fit(trainer, ft, faults, stalls):
    """``trainer.fit()``; with ``stalls``, under a watchdog that restarts
    on the step the injected stall fell in and on no other, on both sides
    alike. The EWMA watchdog's verdict depends on the host's speed (a busy
    host slows this package's CPU steps tenfold, not the reference's
    compiled ones), so the matrix keys the restart to the fault itself;
    the EWMA's verdicts are held against the reference's in
    tests/test_torch_runtime.py."""
    if not stalls:
        return trainer.fit()

    class StallWatchdog(ft.StragglerPolicy):
        stalled = False

        def observe(self, seconds):
            hit, self.stalled = self.stalled, False
            return "restart" if hit else "ok"

    dog = StallWatchdog()
    fire = faults.FaultInjector._fire

    def fire_and_flag(self, idx, step, ev):
        fire(self, idx, step, ev)
        dog.stalled = dog.stalled or ev.kind == "stall"

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(faults.FaultInjector, "_fire", fire_and_flag)
        return trainer.fit(straggler=dog)


def _run_pair(root, name, engine, **kw):
    jspec, tspec = _specs(root, name, engine, **kw)
    stalls = "stall" in kw.get("inject_faults", "")
    jres = _fit(JaxTrainer.from_spec(jspec), jft, jfaults, stalls)
    tres = _fit(BridgedTrainer(tspec), tft, tfaults, stalls)
    return jres, tres, jspec, tspec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdegrade, "_import_memsim", _no_memsim)
        for scenario, engine in CASES:
            kw = SCENARIOS[scenario][0]
            out[scenario, engine] = _run_pair(
                root, f"{scenario}_{engine}", engine, **kw)
    return out


def _lora(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_lora(v, f"{prefix}/{k}"))
        elif k in ("a", "b"):
            out[f"{prefix}/{k}"] = np.asarray(
                v.float().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _on_disk(d):
    return sorted(n for n in os.listdir(d)
                  if n.startswith(("step_", "corrupt_step_")))


@pytest.mark.parametrize("scenario,engine", CASES)
def test_trainer_matches_reference_fault_matrix(runs, scenario, engine):
    jres, tres, jspec, tspec = runs[scenario, engine]
    jl = [h.loss for h in jres.history]
    tl = [h.loss for h in tres.history]
    assert len(tl) == len(jl) and tres.history[-1].step == jspec.steps
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jc, tc = dict(jres.fault_counts), dict(tres.fault_counts)
    jc.pop("backoff_seconds"), tc.pop("backoff_seconds")
    assert tc == jc
    assert tres.degradations == jres.degradations
    fs, jfs = tres.final_spec, jres.final_spec
    assert (JAX_ENGINE.get(fs.engine, fs.engine), fs.batch, fs.seq,
            fs.quantize) == (jfs.engine, jfs.batch, jfs.seq, jfs.quantize)
    assert _on_disk(tspec.ckpt_dir) == _on_disk(jspec.ckpt_dir)
    jlora, tlora = _lora(jres.params), _lora(tres.params)
    assert tlora.keys() == jlora.keys() and len(tlora) == 14
    for k in jlora:
        np.testing.assert_allclose(tlora[k], jlora[k], rtol=LEAF_TOL,
                                   atol=LEAF_TOL, err_msg=k)


@pytest.mark.parametrize("engine", ["mesp", "mesp_cuda"])
def test_crash_resumes_bit_for_bit(runs, tmp_path, engine):
    """A crashed-and-resumed run equals the clean run bit for bit."""
    def port(scenario, **kw):
        if (scenario, engine) in runs:
            return runs[scenario, engine][1]
        # the port's run alone
        return BridgedTrainer(_specs(tmp_path, scenario, engine,
                                     **kw)[1]).fit()

    clean, crashed = port("clean"), port("crash", inject_faults="crash@5")
    assert crashed.fault_counts["step_failures"] == 1
    assert crashed.fault_counts["steps_replayed"] > 0

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert torch.equal(a, b), path

    walk(clean.params, crashed.params)


def test_chaos_counters_are_the_reference_acceptance(runs):
    res = runs["chaos", "mesp_cuda"][1]
    assert res.history[-1].step == CHAOS_STEPS
    assert res.fault_counts["injected"] == {
        "oom": 1, "corrupt": 1, "crash": 1, "nan": 1, "stall": 1}
    assert res.fault_counts["straggler_restarts"] == 1
    assert res.fault_counts["ckpt_quarantines"] >= 1
    assert res.degradations == ["halve_batch"]
    assert res.final_spec.batch == 1 and res.final_spec.engine == "mesp_cuda"


# --------------------------------------------------------------- the CLI
def test_spec_cli_round_trip(tmp_path):
    spec = TrainSpec(engine="mesp_cuda", device="cpu", reduced=True,
                     inject_faults="oom@4,nan@7", straggler_limit=1,
                     guard_budget=4, lr=5e-3, ckpt_dir=str(tmp_path),
                     mem_budget_mb=512.0, telemetry="on", quiet=True)
    assert TrainSpec.from_cli_args(spec.to_cli_args()) == spec
    assert TrainSpec.from_cli_args([]) == TrainSpec()
    with pytest.raises(ValueError, match=r"model axis .* item 3"):
        TrainSpec(model_parallel=2, engine="mezo").validate()
    with pytest.raises(ValueError, match="bad fault entry"):
        TrainSpec(inject_faults="meteor@3").validate()


def _flags(ap):
    return {s for a in ap._actions for s in a.option_strings} - {"-h",
                                                                "--help"}


def test_parser_flags_are_the_reference_s():
    want = (_flags(jax_arg_parser()) - {"--pallas-interpret"}) | {"--device"}
    assert _flags(build_arg_parser()) == want
    assert ttrain.build_arg_parser is build_arg_parser


def test_launcher_chaos_run_resumes_from_its_directory(tmp_path):
    argv = ["--reduced", "--device", "cpu", "--steps", "6", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--inject-faults",
            "oom@2,crash@4,nan@5", "--quiet"]
    assert ttrain.main(argv) == 0
    assert _on_disk(tmp_path)[-1] == "step_00000006"
    spec = TrainSpec.from_cli_args(argv)
    res = Trainer(spec).fit()          # a second identical call resumes
    assert res.history == []
    assert res.final_spec.engine == "mesp_seq"    # the ladder's rung kept
