"""The port's kernel autotuner (``repro_torch.kernels.autotune``) against
the reference's (``repro.kernels.autotune``), on the CPU.

The interface is held against the reference's on the same inputs: cache
keys, counter names, what ``save_cache`` writes and the counters' traffic
over the same lookups. Block sizes are not compared: the reference sizes
blocks for a TPU's VMEM, the port picks cluster splits for Hopper. The
port's dense split rule, moved from C (``split_of`` of
``csrc/lora_dense_tc.cuh``) into Python, is held against values written out
from the C rule's constants (64-row, 128-column tiles; 32-deep slabs; at
most 8 members, each at least 4 slabs; two blocks an SM of 132) at
qwen2.5-0.5b's, OLMoE-1B-7B's and Gemma3-12B's shapes. A sweep's timing
and checks run here on host tensors with a fake ``run``.
"""
import json

import pytest
import torch

from repro.kernels import autotune as jtune
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as tune
from repro_torch.kernels import lora_grouped as tlg
from repro_torch.runtime import elastic

H100_SMS = 132


@pytest.fixture
def clean_cache():
    """A fresh cache on both sides, the loaded ones put back after."""
    saved, jsaved = dict(tune._CACHE), dict(jtune._CACHE)
    tune._ensure_loaded()
    jtune._ensure_loaded()
    tune._CACHE.clear()
    jtune._CACHE.clear()
    yield
    tune._CACHE.clear()
    tune._CACHE.update(saved)
    jtune._CACHE.clear()
    jtune._CACHE.update(jsaved)


# ---------------------------------------------------------------- the keys
@pytest.mark.parametrize("op,dims,dtype", [
    ("rmsnorm", {"M": 1024, "d": 64}, "float32"),
    ("lora_fused", {"M": 256, "K": 896, "N": 4864}, "bfloat16"),
    ("lora_dx_q4", {"M": 2048, "K": 15360, "N": 3840}, "bfloat16"),
    ("flash", {"Nq": 256, "Nk": 256, "D": 64, "causal": 1, "window": 0},
     "float32"),
])
def test_key_format_is_the_reference_s(op, dims, dtype):
    # on the CPU both generations are "cpu": the same key, the same string
    want = jtune._key(op, dims, dtype)
    assert tune._key(op, dims, getattr(torch, dtype)) == want
    assert tune._key(op, dims, dtype) == want
    assert want.endswith("|cpu") and "mesh=" not in want


def test_generation_names_the_card(monkeypatch):
    assert tune.backend_generation() == "cpu"
    tune.backend_generation.cache_clear()
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: "NVIDIA H100 80GB HBM3")
        assert tune.backend_generation() == "nvidia-h100-80gb-hbm3"
        assert tune._key("rmsnorm", {"M": 8, "d": 896}, torch.bfloat16) == \
            "rmsnorm|M=8/d=896|bfloat16|nvidia-h100-80gb-hbm3"
        assert tune.builtin_cache_path().endswith(
            "autotune_cache/nvidia-h100-80gb-hbm3.json")
    finally:
        monkeypatch.undo()
        tune.backend_generation.cache_clear()
    assert tune.backend_generation() == "cpu"


def test_rank_local_key_is_the_single_process_key(fake_mesh):
    """A data-parallel rank launches its kernels on its own rows, so its
    key at its local batch is the single-process key at that batch; the
    reference reaches the same local dims from the global ones under a
    mesh (``_local_dims``) and tags the key with the mesh."""
    seq, global_batch, K, N = 32, 4, 896, 4864
    dp = elastic.DataParallel(elastic.make_mesh_from_devices([0, 1], 1))
    rows = dp.rows(global_batch)            # rank 0 of a data axis of 2
    local = {"M": (rows.stop - rows.start) * seq, "K": K, "N": N}
    single = {"M": global_batch // 2 * seq, "K": K, "N": N}
    key = tune._key("lora_fused", local, torch.bfloat16)
    assert key == tune._key("lora_fused", single, torch.bfloat16)
    jkey = jtune._key("lora_fused", {"M": global_batch * seq, "K": K,
                                     "N": N}, "bfloat16",
                      mesh=fake_mesh(2, 1))
    assert key == jkey.replace("mesh=data2xmodel1|", "")


# ------------------------------------------------------------ the counters
def test_counter_names_are_the_reference_s():
    assert list(tune.COUNTERS) == list(jtune.COUNTERS)
    assert tune.COUNTERS.name == jtune.COUNTERS.name == "autotune"
    assert set(tune.cache_stats()) == set(jtune.cache_stats())


def test_telemetry_adopts_the_counters(tmp_path):
    from repro import telemetry as jtele
    from repro_torch import telemetry as ttele
    names = lambda tel: sorted(k for k in tel.registry.snapshot()
                               if k.startswith("autotune."))
    tt = ttele.Telemetry(enabled=True)
    jt = jtele.Telemetry(enabled=True)
    try:
        assert names(tt) == names(jt) and names(tt)
    finally:
        tt.close()
        jt.close()
    assert "autotune.cache_hit" not in \
        ttele.Telemetry(enabled=False).registry.snapshot()


def test_lookups_tick_as_the_reference_s(clean_cache):
    """The same lookups against the same cached entry: the same hits and
    misses on both sides, and the cached plan returned as stored."""
    dims = {"M": 256, "K": 896, "N": 896}
    tune._CACHE[tune._key("lora_fused", dims, torch.float32)] = {"split": 3}
    jtune._CACHE[jtune._key("lora_fused", dims, "float32")] = {"bm": 128}
    before, jbefore = tune.cache_stats(), jtune.cache_stats()
    got = [tune.choose_blocks("lora_fused", torch.float32, **d)
           for d in (dims, dict(dims, M=128), dims)]
    assert got == [{"split": 3}, {}, {"split": 3}]
    for d in (dims, dict(dims, M=128), dims):
        jtune.choose_blocks("lora_fused", "float32", **d)
    delta = lambda now, then: {k: now[k] - then[k] for k in now}
    jdelta = delta(jtune.cache_stats(), jbefore)
    assert jdelta == {"cache_hit": 2, "cache_miss": 1, "sweeps": 0,
                      "sweep_candidates": 0}
    assert delta(tune.cache_stats(), before) == jdelta


def test_save_cache_writes_only_this_generation(clean_cache, tmp_path):
    """The same entries on both sides, one of them another generation's:
    both files hold the same keys and the same bytes' structure, neither
    the other generation's entry."""
    dims = {"M": 64, "d": 32}
    mine = tune._key("rmsnorm", dims, torch.float32)
    other = mine.rsplit("|", 1)[0] + "|nvidia-h100-80gb-hbm3"
    jmine = jtune._key("rmsnorm", dims, "float32")
    jother = jmine.rsplit("|", 1)[0] + "|tpu"
    tune._CACHE.update({mine: {"rows_per_warp": 1}, other: {"split": 4}})
    jtune._CACHE.update({jmine: {"rows_per_warp": 1}, jother: {"bm": 256}})
    path = tune.save_cache(str(tmp_path / "cpu.json"))
    jpath = jtune.save_cache(str(tmp_path / "jax_cpu.json"))
    text, jtext = open(path).read(), open(jpath).read()
    assert json.loads(text) == {mine: {"rows_per_warp": 1}}
    assert text == jtext                    # the same file, byte for byte


def test_load_save_round_trip(clean_cache, tmp_path):
    dims = {"M": 8, "K": 896, "N": 4864, "r": 8, "bm": 2}
    key = tune._key("lora_grouped", dims, torch.bfloat16)
    tune._CACHE[key] = {"split": 2, "bn": 64}
    path = tune.save_cache(str(tmp_path / "cpu.json"))
    tune.clear_cache()
    hit0 = tune.cache_stats()["cache_hit"]
    assert tune.load_cache(path) == 1
    assert tune.choose_blocks("lora_grouped", torch.bfloat16, **dims) == \
        {"split": 2, "bn": 64}
    assert tune.cache_stats()["cache_hit"] == hit0 + 1
    # the reference reads the port's file as its own: the same format
    jtune._CACHE.clear()
    assert jtune.load_cache(path) == 1 and jtune._CACHE == tune._CACHE


def test_env_override_is_loaded_first_use(clean_cache, tmp_path,
                                          monkeypatch):
    key = tune._key("flash", {"Nq": 64, "Nk": 64, "D": 64, "causal": 1,
                              "window": 0}, torch.float32)
    path = tmp_path / "override.json"
    path.write_text(json.dumps({key: {"bq": 64, "bk": 64}}))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(tune, "_LOADED", False)
    tune._ensure_loaded()
    assert tune._CACHE[key] == {"bq": 64, "bk": 64}


# ------------------------------------------------------------- the sweep
def _fake_run(costs, bad=(), wrong=(), broken=()):
    """``run(plan)`` and the ms of each plan: a plan in ``bad`` is refused
    at launch (as an entry refuses a plan past its limits), one in
    ``broken`` fails otherwise, one in ``wrong`` answers wrongly; the
    timer (``_graph_ms``, patched in) reads the cost of the plan last
    run."""
    last = {}

    def run(plan):
        s = plan["split"]
        if s in bad:
            raise _build.LaunchRefused(f"split {s}: CUDA error 1")
        if s in broken:
            raise RuntimeError(f"split {s}: CUDA error 700")
        last["split"] = s
        return torch.full((4,), 2.0 if s in wrong else 1.0)

    def graph_ms(fn, repeats):
        fn()
        return costs[last["split"]]
    return run, graph_ms


def test_autotune_crowns_the_fastest_and_skips_what_cannot_launch(
        clean_cache, monkeypatch):
    dims = {"M": 256, "K": 896, "N": 896}
    stats = tune.cache_stats()
    run, graph_ms = _fake_run({1: 3.0, 2: 0.5, 4: 1.5, 8: 0.1}, bad=(8,))
    monkeypatch.setattr(tune, "_graph_ms", graph_ms)
    best = tune.autotune(
        "lora_fused", run, candidates=[{"split": s} for s in (1, 2, 4, 8)],
        dtype=torch.bfloat16, repeats=1, want=torch.ones(4),
        tol=dict(rtol=0, atol=0), **dims)
    assert best == {"split": 2}
    now = tune.cache_stats()
    assert now["sweeps"] - stats["sweeps"] == 1
    assert now["sweep_candidates"] - stats["sweep_candidates"] == 4
    assert tune.LAST_SWEEP["times"] == [({"split": 1}, 3.0),
                                        ({"split": 2}, 0.5),
                                        ({"split": 4}, 1.5),
                                        ({"split": 8}, None)]
    assert tune.choose_blocks("lora_fused", torch.bfloat16, **dims) == best


def test_autotune_refuses_a_plan_with_another_answer(clean_cache,
                                                     monkeypatch):
    run, graph_ms = _fake_run({1: 0.2, 4: 0.1}, wrong=(4,))
    monkeypatch.setattr(tune, "_graph_ms", graph_ms)
    with pytest.raises(ValueError, match=r"plan \{'split': 4\}"):
        tune.autotune("lora_dx", run,
                      candidates=[{"split": 1}, {"split": 4}],
                      dtype=torch.bfloat16, repeats=1, want=torch.ones(4),
                      tol=dict(rtol=0, atol=0), M=8, K=64, N=64)
    assert tune._key("lora_dx", {"M": 8, "K": 64, "N": 64},
                     torch.bfloat16) not in tune._CACHE
    with pytest.raises(RuntimeError, match="no candidate"):
        tune.autotune("lora_dx", _fake_run({}, bad=(1,))[0],
                      candidates=[{"split": 1}], dtype=torch.bfloat16,
                      repeats=1, M=8, K=64, N=64)


def test_autotune_raises_a_failure_that_is_no_refusal(clean_cache,
                                                      monkeypatch):
    """Only a launch refused for its plan is skipped: any other failure of
    a candidate (a fault of the kernel) stops the sweep, and an op with a
    fixed plan is not swept."""
    run, graph_ms = _fake_run({1: 0.2, 2: 0.1}, broken=(2,))
    monkeypatch.setattr(tune, "_graph_ms", graph_ms)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tune.autotune("lora_fused", run,
                      candidates=[{"split": 1}, {"split": 2}],
                      dtype=torch.bfloat16, repeats=1, M=8, K=64, N=64)
    assert tune._key("lora_fused", {"M": 8, "K": 64, "N": 64},
                     torch.bfloat16) not in tune._CACHE
    with pytest.raises(RuntimeError, match="fixed plan"):
        tune.autotune("rmsnorm", run, candidates=[{"split": 1}],
                      M=8, d=64)


def test_fixed_plans_count_a_miss_without_the_cache(clean_cache):
    """A dispatch of an op with a fixed plan ticks one miss and returns
    that plan, as the reference's lookup of an uncached key does."""
    before, jbefore = tune.cache_stats(), jtune.cache_stats()
    assert tune.choose_blocks("rmsnorm", torch.bfloat16, M=8, d=896) == \
        {"rows_per_warp": 1}
    assert tune.choose_blocks("lora_grouped", torch.bfloat16, M=2560,
                              K=2048, N=1024, E=64, bm=40) == {"bn": 256}
    jtune.choose_blocks("rmsnorm", "bfloat16", M=8, d=896)
    jtune.choose_blocks("lora_grouped", "bfloat16", M=2560, K=2048,
                        N=1024, E=64, bm=40)
    delta = lambda now, then: {k: now[k] - then[k] for k in now}
    assert delta(tune.cache_stats(), before) == \
        delta(jtune.cache_stats(), jbefore) == \
        {"cache_hit": 0, "cache_miss": 2, "sweeps": 0,
         "sweep_candidates": 0}


# ------------------------------------------------------- the split rule
#: (M, K, N) -> the C rule's split, written out from its constants at 132
#: SMs: tiles = ceil(M/64) ceil(N/128), slabs = ceil(K/32), split =
#: max(1, min(ceil(264 / tiles), 8, slabs // 4)); the dx with K and N
#: swapped
QWEN = {"q/o": (896, 896), "k/v": (896, 128), "gate/up": (896, 4864),
        "down": (4864, 896)}
FWD_SPLITS = {
    (256, 896, 896): 7, (256, 896, 128): 7, (256, 896, 4864): 2,
    (256, 4864, 896): 8,                         # qwen2.5-0.5b at M 256
    (192, 896, 896): 7, (192, 896, 4864): 3,    # ... at 4 x 48
    (256, 2048, 2048): 5, (256, 2048, 1024): 8,  # OLMoE q/k/v/o, expert
    (256, 1024, 2048): 5,
    (2048, 3840, 4096): 1, (2048, 3840, 15360): 1,   # Gemma3-12B MLP/q
    (2048, 15360, 3840): 1, (2048, 4096, 3840): 1,
    (8, 896, 896): 7, (4, 2048, 2048): 8,       # decode rows
}
DX_SPLITS = {   # g [M, N] -> dx [M, K]: the contraction is N
    (256, 896, 896): 7, (256, 896, 128): 1, (256, 896, 4864): 8,
    (256, 4864, 896): 2, (256, 2048, 2048): 5,
    (2048, 3840, 15360): 1, (2048, 15360, 3840): 1,
}


@pytest.mark.parametrize("mkn,want", sorted(FWD_SPLITS.items()))
def test_forward_split_is_the_c_rule(mkn, want):
    M, K, N = mkn
    assert tune._heuristic("lora_fused", {"M": M, "K": K, "N": N},
                           torch.bfloat16, H100_SMS) == {"split": want}
    for op in ("lora_fused_q", "lora_fused_q4"):
        assert tune._heuristic(op, {"M": M, "K": K, "N": N},
                               torch.bfloat16, H100_SMS) == {"split": want}
    assert 1 <= want <= tune.dense_split_limit(K)


@pytest.mark.parametrize("mkn,want", sorted(DX_SPLITS.items()))
def test_dx_split_is_the_c_rule_over_n(mkn, want):
    M, K, N = mkn
    for op in tune.DENSE_DX_OPS:
        assert tune._heuristic(op, {"M": M, "K": K, "N": N},
                               torch.bfloat16, H100_SMS) == {"split": want}
    assert 1 <= want <= tune.dense_split_limit(N)


def test_fixed_plans_and_f32():
    """Ops without a free parameter return their fixed plan; every f32
    dense body has none; the decode heuristic is ``decode_plan``'s."""
    h = lambda op, dtype=torch.bfloat16, **d: tune._heuristic(
        op, d, dtype, H100_SMS)
    assert h("flash", Nq=256, Nk=256, D=64, causal=1, window=0) == \
        {"bq": 64, "bk": 64}
    assert h("rmsnorm", M=256, d=896) == {"rows_per_warp": 1}
    assert h("lora_dab", M=256, K=896, N=896) == {}
    assert h("lora_grouped_dab", M=2560, K=2048, N=1024) == {}
    assert h("lora_grouped", M=2560, K=2048, N=1024, E=64, bm=40) == \
        {"bn": 256}
    assert h("lora_fused", torch.float32, M=256, K=896, N=896) == {}
    for M, K, N in ((8, 896, 896), (8, 896, 4864), (8, 4864, 896),
                    (16, 2048, 1024)):
        plan = tlg.decode_plan(M, K, N, 8, bm=2, sms=H100_SMS)
        assert h("lora_grouped_q4", M=M, K=K, N=N, r=8, bm=2) == \
            {"split": plan["split"], "bn": plan["bn"]}
    with pytest.raises(ValueError, match="unknown op"):
        h("conv")


def test_cpu_dispatch_asks_for_no_plan():
    """On host tensors the wrappers run their plain versions, which have
    no plan: no lookup ticks."""
    from repro_torch.kernels import lora_fused as tlf, rmsnorm as trn
    before = tune.cache_stats()
    x = torch.randn(8, 16)
    tlf.lora_fused(x, torch.randn(16, 8), torch.randn(16, 2),
                   torch.randn(2, 8))
    trn.rmsnorm(x, torch.ones(16))
    assert tune.cache_stats() == before
    assert not torch.cuda.is_initialized()
