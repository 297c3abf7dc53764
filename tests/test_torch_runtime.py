"""The port's training runtime (``repro_torch.runtime``) against the
reference's (``repro.runtime``), on the CPU.

Fault plans parse and draw the same (``FaultPlan.seeded`` uses numpy from
the seed in both); the step guard, the straggler watchdog and the watermark
trigger give the same verdicts and states on the same input sequences; the
degradation ladder offers the same rungs and specs (engine names mapped
``mesp_pallas`` <-> ``mesp_cuda``; the reference's memory model switched
off, the port having none); ``carry_opt_state`` and ``update_norm`` (1e-6
relative) agree on bridged trees. Then what only the port has: the in-place
quantize rung gives ``quantize_params``'s codes bit for bit, every engine's
step leaves its input trees bit for bit unchanged (the guard's rewind
relies on it), and the proactive ladder through both Trainers fed the same
watermark samples.
"""
import copy
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.degrade as jdegrade
from repro.api import Trainer as JaxTrainer
from repro.api import TrainSpec as JaxSpec
from repro.core.quant import quantize_params as jquantize
from repro.models import model as JM
from repro.runtime import faults as jfaults
from repro.runtime import fault_tolerance as jft
from repro.runtime import guard as jguard
from repro.telemetry import memwatch as jmemwatch
from repro_torch import bridge
from repro_torch.api.registry import get_engine, list_engines
from repro_torch.api.spec import TrainSpec
from repro_torch.api.trainer import Trainer
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.data import make_batch_iterator
from repro_torch.models import model as TM
from repro_torch.optim import optimizers
from repro_torch.runtime import degrade as tdegrade
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import guard as tguard
from repro_torch.telemetry import memwatch as tmemwatch

JAX_ENGINE = {"mesp_cuda": "mesp_pallas"}
TCFG = get_config("qwen2.5-0.5b").reduced()


def _no_memsim():
    raise ImportError("memsim switched off: the port has no memory model")


@pytest.fixture(autouse=True)
def _reference_without_memsim(monkeypatch):
    monkeypatch.setattr(jdegrade, "_import_memsim", _no_memsim)


# ---------------------------------------------------------------- faults
PLANS = ["oom@4,corrupt@9,crash@9,nan@14,stall@18:1.5", "crash@9,corrupt@9",
         "nan@3, oom@3 ,stall@3:0.25", "", "random", "random:3", "random:9"]


@pytest.mark.parametrize("text", PLANS)
@pytest.mark.parametrize("seed,total", [(0, 100), (7, 30), (3, 6), (11, 2)])
def test_fault_plan_matches_reference(text, seed, total):
    got = tfaults.FaultPlan.from_string(text, total_steps=total, seed=seed)
    want = jfaults.FaultPlan.from_string(text, total_steps=total, seed=seed)
    assert got.to_string() == want.to_string()
    assert tfaults.FaultPlan.parse(got.to_string()).to_string() == \
        want.to_string()


def test_fault_plan_seeded_matches_reference():
    for seed in range(20):
        for n in (1, 3, 5, 8):
            assert tfaults.FaultPlan.seeded(seed, 40, n).to_string() == \
                jfaults.FaultPlan.seeded(seed, 40, n).to_string()
    with pytest.raises(ValueError, match="bad fault entry"):
        tfaults.FaultPlan.parse("meteor@3")


def test_is_oom_error_takes_the_cuda_allocator_s_error():
    assert tfaults.is_oom_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert tfaults.is_oom_error(RuntimeError("CUDA out of memory."))
    assert tfaults.is_oom_error(tfaults.InjectedOOM("RESOURCE_EXHAUSTED"))
    assert tfaults.is_oom_error(MemoryError())
    assert not tfaults.is_oom_error(RuntimeError("device lost"))
    for e in (RuntimeError("RESOURCE_EXHAUSTED: hbm"), ValueError("x"),
              RuntimeError("Allocation failure")):
        assert tfaults.is_oom_error(e) == jfaults.is_oom_error(e)


def test_injector_fires_as_the_reference_s(tmp_path):
    plan = "oom@2,nan@3,crash@4,stall@5:0.01"
    logs = []
    for mod in (tfaults, jfaults):
        inj = mod.FaultInjector(mod.FaultPlan.parse(plan),
                                ckpt_dir=str(tmp_path))
        seen = []
        for step in (0, 1, 2, 2, 3, 4, 4, 5, 6):
            try:
                inj.before_step(step)
                seen.append((step, inj.after_step(step, 1.0)))
            except RuntimeError as e:
                seen.append((step, type(e).__name__))
        logs.append((seen, inj.summary(), inj.exhausted))
    assert str(logs[0]) == str(logs[1])


# ------------------------------------------------------ guard, watchdog
GUARD_LOSSES = [5.0, 4.9, float("nan"), 4.8, 4.7, 4.6, 4.5, 4.4, 4.3, 4.2,
                200.0, 4.1, 4.0, float("inf"), 3.9, 3.8]
GUARD_NORMS = [1.0, 1.1, 1.0, 0.9, 1.0, float("nan"), 1.0, 1.2, 1.1, 1.0,
               1.0, 90.0, 1.0, 1.0, 1.0, 0.8]


@pytest.mark.parametrize("track", [True, False])
def test_step_guard_matches_reference(track):
    out = []
    for mod in (tguard, jguard):
        g = mod.StepGuard(budget=4, warmup=3)
        seen = []
        for i, (loss, norm) in enumerate(zip(GUARD_LOSSES, GUARD_NORMS)):
            try:
                seen.append(g.observe(loss, norm if track else None, step=i))
            except mod.GuardExhausted as e:
                seen.append(f"exhausted {e}")
                break
        out.append((seen, g.state()))
    assert str(out[0]) == str(out[1])


STEP_SECONDS = [3.0, 0.1, 0.11, 0.09, 1.5, 0.1, 2.0, 2.5, 3.0, 0.1, 0.12]


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_straggler_policy_matches_reference(limit):
    out = []
    for mod in (tft, jft):
        p = mod.StragglerPolicy(factor=8.0, consecutive_limit=limit)
        out.append(([p.observe(s) for s in STEP_SECONDS], p.mean,
                     p.slow_streak))
    assert out[0] == out[1]


def test_watermark_trigger_matches_reference():
    samples = [10, 95, 95, 50, 91, 92, 93, 94, 10, 99, 99, 99]
    out = []
    for mod in (tdegrade, jdegrade):
        t = mod.WatermarkTrigger(100.0)
        out.append(([t.observe(m) for m in samples], t.trips, t.limit_mb))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        tdegrade.WatermarkTrigger(0.0)


# --------------------------------------------------------------- ladder
LADDER_SPECS = [
    dict(engine="mesp_cuda", batch=4, seq=256),
    dict(engine="mesp_cuda", batch=1, seq=256, quantize="int8"),
    dict(engine="mesp", batch=2, seq=64, quantize="nf4"),
    dict(engine="mesp_seq", batch=1, seq=48, quantize="int4"),
    dict(engine="mezo", batch=1, seq=32),
    dict(engine="mebp", batch=8, seq=33, optimizer="adamw"),
    dict(engine="mesp_seq", batch=1, seq=32, quantize="int4"),
]


def _rungs(mod_ladder, spec):
    try:
        return [(rung, JAX_ENGINE.get(c.engine, c.engine), c.batch, c.seq,
                 c.quantize, c.optimizer)
                for c, rung in mod_ladder.candidates(spec)]
    except (tdegrade.LadderExhausted, jdegrade.LadderExhausted) as e:
        return f"exhausted: {e}"


@pytest.mark.parametrize("kw", LADDER_SPECS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_ladder_candidates_match_reference(kw):
    tspec = TrainSpec(device="cpu", **kw)
    jspec = JaxSpec(**{**kw, "engine": JAX_ENGINE.get(kw["engine"],
                                                       kw["engine"])})
    got = _rungs(tdegrade.DegradationLadder(), tspec)
    want = _rungs(jdegrade.DegradationLadder(), jspec)
    if isinstance(want, str):
        got = got.replace("mesp_cuda", "mesp_pallas")
    assert got == want


@pytest.mark.parametrize("kw", LADDER_SPECS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_ladder_on_the_card_keeps_the_kernel_engine(kw):
    """On a CUDA device ``mesp_cuda`` has no engine rung (it would take the
    kernels off the card and frees nothing there): the reference's rungs
    less its step-downs out of ``mesp_pallas``. Every other engine walks
    the reference's ladder on the card too."""
    tspec = TrainSpec(device="cuda", **kw)
    jspec = JaxSpec(**{**kw, "engine": JAX_ENGINE.get(kw["engine"],
                                                       kw["engine"])})
    got = _rungs(tdegrade.DegradationLadder(), tspec)
    want = _rungs(jdegrade.DegradationLadder(), jspec)
    if kw["engine"] == "mesp_cuda":
        assert any(r[0].startswith("engine_") for r in want)
        want = [r for r in want if not r[0].startswith("engine_")]
        assert got and all(r[1] == "mesp_pallas" for r in got)
    elif isinstance(want, str):
        got = got.replace("mesp_cuda", "mesp_pallas")
    assert got == want


# ------------------------------------------------- trees: carry, norms
def _jax_params(quantize=None):
    jcfg = JaxTrainer.from_spec(JaxSpec(reduced=True)).cfg
    return JM.init_params(jax.random.PRNGKey(0), jcfg, quantize=quantize)


def _paths(tree, prefix=""):
    """{"/a/b": leaf} over nested dicts, None leaves kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]
    return {"".join(f"/{p.key}" for p in path): leaf for path, leaf in flat}


def _moments(params, rng):
    """A momentum tree: numpy arrays at the LoRA leaves, None elsewhere."""
    return {k: _moments(v, rng) if isinstance(v, dict) else
            (rng.standard_normal(np.shape(v)).astype(np.float32)
             if k in ("a", "b") else None) for k, v in params.items()}


@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_carry_opt_state_matches_reference(method):
    jp = jax.tree_util.tree_map(np.asarray, _jax_params())
    m = _moments(jp, np.random.default_rng(0))
    keep_none = dict(is_leaf=lambda x: x is None)
    jstate = {"step": 3, "m": jax.tree_util.tree_map(
        lambda x: None if x is None else jnp.asarray(x), m, **keep_none)}
    want = jdegrade.carry_opt_state(jstate, jp, jquantize(jp, method))
    tp = bridge.from_numpy_tree(jp)
    tstate = {"step": 3, "m": jax.tree_util.tree_map(
        lambda x: None if x is None else torch.from_numpy(x), m,
        **keep_none)}
    got = tdegrade.carry_opt_state(tstate, tp,
                                   quant.quantize_params(tp, method))
    assert got["step"] == want["step"] == 3
    g, w = _paths(got["m"]), _jax_paths(want["m"])
    assert g.keys() == w.keys()
    for k in w:
        if w[k] is None:
            assert g[k] is None, k
        else:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def _perturbed(tree, rng, scale):
    return {k: _perturbed(v, rng, scale) if isinstance(v, dict) else
            (v + scale * rng.standard_normal(np.shape(v)).astype(np.float32)
             if k in ("a", "b") else v) for k, v in tree.items()}


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_update_norm_matches_reference(scale):
    old = jax.tree_util.tree_map(np.asarray, _jax_params("int8"))
    new = _perturbed(old, np.random.default_rng(1), scale)
    want = jguard.update_norm(jax.tree_util.tree_map(jnp.asarray, old),
                              jax.tree_util.tree_map(jnp.asarray, new))
    told = bridge.from_numpy_tree(old)
    # frozen leaves shared by object, as an engine's step returns them
    tnew = {**told, "blocks": {**told["blocks"], "attn": {
        k: {**v, **{f: torch.from_numpy(new["blocks"]["attn"][k][f])
                    for f in ("a", "b")}}
        for k, v in told["blocks"]["attn"].items()}, "mlp": {
        k: {**v, **{f: torch.from_numpy(new["blocks"]["mlp"][k][f])
                    for f in ("a", "b")}}
        for k, v in told["blocks"]["mlp"].items()}}}
    got = tguard.update_norm(told, tnew)
    assert math.isclose(got, want, rel_tol=1e-6)
    assert got == tguard.update_norm(told, bridge.from_numpy_tree(new))
    assert tguard.update_norm(told, told) == 0.0


# ------------------------------------------------- the in-place rung
@pytest.mark.parametrize("arch", ["qwen2.5-0.5b", "olmoe-1b-7b"])
@pytest.mark.parametrize("steps", [("none", "int8"), ("int8", "int4"),
                                   ("none", "nf4"), ("nf4", "int8")])
def test_in_place_quantize_rung_gives_quantize_params_codes(arch, steps):
    cfg = get_config(arch).reduced()
    src = quant.quantize_params(
        TM.init_params(cfg, generator=torch.Generator().manual_seed(0)),
        steps[0])
    want = quant.quantize_params(src, steps[1])
    got = quant.quantize_frozen_(copy.deepcopy(src), method=steps[1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert quant.tree_method(got) == steps[1]


def test_in_place_quantize_rung_frees_each_source():
    """A frozen leaf's source goes as its codes land: only the tree held
    it, so its storage is released before the next leaf is read."""
    params = TM.init_params(TCFG, generator=torch.Generator().manual_seed(0))
    w = params["blocks"]["mlp"]["up"]["w"]
    ref = weakref.ref(w)
    del w
    quant.quantize_frozen_(params, method="int8")
    assert ref() is None
    assert quant.is_quantized(params["blocks"]["mlp"]["up"]["w"])


# ------------------------------------------ functional steps (rewind)
def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _with_b(tree, gen):
    return {k: _with_b(v, gen) if isinstance(v, dict) else
            (0.02 * torch.randn(v.shape, generator=gen) if k == "b" else v)
            for k, v in tree.items()}


STEP_RUNS = [(e.name, "sgd", "none") for e in list_engines()] + [
    ("mesp_cuda", "sgd_momentum", "none"), ("mesp_cuda", "adamw", "nf4"),
    ("mesp", "adamw", "int8")]


@pytest.mark.parametrize("engine,optimizer,quantize", STEP_RUNS)
def test_every_engine_step_leaves_its_input_unchanged(engine, optimizer,
                                                      quantize):
    gen = torch.Generator().manual_seed(0)
    params = _with_b(TM.init_params(TCFG, generator=gen, quantize=quantize),
                     gen)
    spec = TrainSpec(engine=engine, optimizer=optimizer, quantize=quantize,
                     device="cpu", lr=1e-2, reduced=True)
    opt = optimizers.make_optimizer(optimizer, spec.lr)
    step = get_engine(engine).build_step(spec.validate(), TCFG, opt,
                                         spec.policy())
    batch = {k: torch.from_numpy(v).long() for k, v in next(
        make_batch_iterator(TCFG.vocab, 16, 2, seed=0)).items()}
    state = opt.init(params)
    for _ in range(2):       # the second step reads a state with moments
        p0, s0 = _clone(params), _clone(state)
        new, new_state, loss = step(params, state, batch)
        assert math.isfinite(float(loss))
        torch.testing.assert_close(params, p0, rtol=0, atol=0)
        torch.testing.assert_close(state, s0, rtol=0, atol=0)
        params, state = new, new_state


# --------------------------------------------- proactive pressure
#: measured MB fed to both trainers' watermarks, one per sample: over the
#: limit until four rungs have landed (two samples a rung), then under it
PRESSURE = [100.0] * 8 + [1.0] * 4
BUDGET_MB = 50.0


def test_proactive_ladder_matches_reference(tmp_path, monkeypatch):
    def feed(mod):
        samples = iter(PRESSURE)

        def sample(self):
            m = next(samples)
            self.last_mb, self.peak_mb = m, max(self.peak_mb, m)
            self.samples += 1
            return {"measured_mb": m, "peak_mb": self.peak_mb,
                    "source": self.source}

        monkeypatch.setattr(mod.MemoryWatermark, "sample", sample)

    feed(jmemwatch)
    feed(tmemwatch)
    kw = dict(reduced=True, steps=len(PRESSURE), seq=32, batch=2, lr=5e-3,
              ckpt_interval=3, mem_budget_mb=BUDGET_MB)
    jres = JaxTrainer.from_spec(JaxSpec(
        engine="mesp_pallas", ckpt_dir=str(tmp_path / "jax"), **kw)).fit()
    tspec = TrainSpec(engine="mesp_cuda", device="cpu",
                      ckpt_dir=str(tmp_path / "torch"), **kw)

    class Bridged(Trainer):
        def init_state(self):
            jp = JM.init_params(jax.random.PRNGKey(0), JaxTrainer.from_spec(
                JaxSpec(reduced=True)).cfg, quantize=self.live_spec.quantize)
            p = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
            return p, self.opt.init(p)

    tres = Bridged(tspec).fit()
    assert jres.degradations == ["halve_batch", "engine_mesp",
                                 "engine_mesp_seq", "quantize_int8"]
    assert tres.degradations == jres.degradations
    assert tres.fault_counts["watermark_triggers"] == 4
    assert tres.fault_counts["oom_events"] == 0
    assert (tres.final_spec.engine, tres.final_spec.quantize,
            tres.final_spec.batch) == ("mesp_seq", "int8", 1)
    np.testing.assert_allclose([h.loss for h in tres.history],
                               [h.loss for h in jres.history], rtol=1e-4)
    w = tres.params["blocks"]["attn"]["q"]["w"]
    assert w["q"].dtype == torch.int8 and w["scale"].dtype == torch.float32
    # a restore of the int8 run reconstitutes the degraded program
    again = Trainer(tspec).fit()
    assert again.history == [] and again.final_spec.quantize == "int8"
    torch.testing.assert_close(again.params, tres.params, rtol=0, atol=0)
