"""The port's data-parallel runtime (``runtime/elastic.py``,
``optim/compression.py``, ``launch/mesh.py``, ``launch/fleet.py``, the
Trainer's mesh) against the reference's, on the CPU.

Fleets are real ``gloo`` process groups of 2 or 4 ranks on a free local
port (``repro_torch.launch.fleet.run_fleet``), each spawn under its own
timeout so that a hang fails its test. The DP-2 runs share one fleet (a
``sequence`` task) and the elastic run has its own of 4 ranks (the
reference's 8 → 4 → 8 cut to 4 → 2 → 4 for CPU time). Every run starts
from the reference's ``init_params`` bridged through numpy, and its
batches drop a quarter of the labels (-1) so that the ranks hold
different numbers of valid tokens.

Tolerances are the reference's own: a DP-2 run against the port's single
process at atol + rtol 1e-6 (the ranks sum their weighted gradients in
another order); its losses against the reference's single-device Trainer
at 1e-5; a mesh of one rank bit for bit against no mesh.
"""
import functools
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Trainer as JaxTrainer
from repro.api import TrainSpec as JaxSpec
from repro.optim import compression as jcomp
from repro.runtime import elastic as jelastic
from repro_torch import bridge
from repro_torch.api.spec import TrainSpec
from repro_torch.api.trainer import Trainer
from repro_torch.launch import fleet
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compression as tcomp
from repro_torch.runtime import elastic
from repro_torch.tree import leaves_with_paths, path_str, tree_leaves

BASE = {"reduced": True, "batch": 4, "seq": 32, "seed": 3, "lr": 5e-3}
STEPS = 3
DROP = 0.25
ATOL = RTOL = 1e-6
JAX_TOL = 1e-5
#: case -> (arch, engine, quantize, optimizer)
CASES = {
    "mesp_momentum": ("qwen2.5-0.5b", "mesp", "none", "sgd_momentum"),
    "mesp_seq_sgd": ("qwen2.5-0.5b", "mesp_seq", "none", "sgd"),
    "mesp_int8": ("qwen2.5-0.5b", "mesp", "int8", "sgd_momentum"),
    "internvl": ("internvl2-1b", "mesp", "none", "sgd"),
}
JAX_CASES = ("mesp_momentum", "mesp_seq_sgd", "mesp_int8")
LADDER_SPEC = dict(BASE, engine="mesp_cuda", optimizer="sgd", batch=2,
                   seq=64)


def _spec(case):
    arch, engine, quantize, opt = CASES[case]
    return dict(BASE, arch=arch, engine=engine, quantize=quantize,
                optimizer=opt)


def _jax_trainer(case):
    s = _spec(case)
    return JaxTrainer.from_spec(JaxSpec(**s, ckpt_dir=tempfile.mkdtemp()))


@functools.lru_cache(maxsize=None)
def _init(case):
    """The reference's fresh params for the case, as the port's tree."""
    params, _ = _jax_trainer(case).init_state()
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                         params))


def _single(case, mesh=None, engine=None):
    """(losses, params, opt_state) of the port's Trainer in this process
    (no mesh unless given) over the fleet's batches."""
    spec = dict(_spec(case), device="cpu")
    if engine:
        spec["engine"] = engine
    tr = Trainer.from_spec(TrainSpec(**spec), mesh=mesh)
    params = _init(case)
    params, opt = tr.shard_state(params, tr.opt.init(params))
    losses = []
    params, opt = fleet._steps(tr, params, opt, {"label_drop": DROP}, 0,
                               STEPS, losses)
    return losses, params, opt, tr


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """One fleet of 2 ranks: the four training cases (final state saved),
    the collectives step and the ladder."""
    root = tmp_path_factory.mktemp("dp2")
    payloads = []
    for case in CASES:
        init = str(root / f"{case}_init.pt")
        torch.save(_init(case), init)
        payloads.append({"task": "train", "spec": _spec(case),
                         "steps": STEPS, "label_drop": DROP, "init": init,
                         "out": str(root / f"{case}_out.pt"),
                         **({"telemetry_dir": str(root / "tel")}
                            if case == "mesp_momentum" else {})})
    payloads.append({"task": "collectives", "label_drop": DROP,
                     "spec": dict(BASE, engine="mesp", optimizer="sgd")})
    payloads.append({"task": "ladder", "spec": LADDER_SPEC})
    res = fleet.run_fleet({"task": "sequence", "payloads": payloads},
                          devices=2, timeout=240)["results"]
    out = dict(zip(list(CASES) + ["collectives", "ladder"], res))
    for case in CASES:
        out[case]["state"] = torch.load(str(root / f"{case}_out.pt"),
                                        weights_only=True)
    out["telemetry_dir"] = str(root / "tel")
    return out


def _close(got, want, what):
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        if not isinstance(a, torch.Tensor):
            assert a == b, (what, p)
        elif a.is_floating_point():
            np.testing.assert_allclose(a.double().numpy(),
                                       b.double().numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{what} "
                                       f"{path_str(p)}")
        else:
            assert torch.equal(a, b), (what, path_str(p))


# ------------------------------------------------------------ DP-2 parity
@pytest.mark.parametrize("case", list(CASES))
def test_dp2_matches_the_single_process(dp2, case):
    res = dp2[case]
    assert res["devices"] == 2 and res["mesh"] == {"data": 2, "model": 1}
    losses, params, opt, _ = _single(case)
    np.testing.assert_allclose(res["losses"], losses, atol=ATOL, rtol=RTOL)
    assert len(set(losses)) > 1                  # the run trains
    _close(res["state"]["params"], params, f"{case} params")
    _close(res["state"]["opt"], opt, f"{case} opt")


@pytest.mark.parametrize("case", JAX_CASES)
def test_dp2_losses_match_the_reference_trainer(dp2, case):
    """The reference's single-device Trainer on the same params and
    batches (its loss ignores the -1 labels too)."""
    tr = _jax_trainer(case)
    params, opt = tr.init_state()
    spec = tr.live_spec
    want = []
    for step in range(STEPS):
        batch = fleet.synth_batch(tr.cfg, spec.batch, spec.seq, spec.seed,
                                  step, DROP)
        params, opt, loss = tr.step_fn(params, opt, {
            k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(loss))
    np.testing.assert_allclose(dp2[case]["losses"], want, rtol=JAX_TOL,
                               atol=JAX_TOL)


def test_dp2_telemetry_shards_merge(dp2):
    tdir = dp2["telemetry_dir"]
    assert {"worker_0.jsonl", "worker_1.jsonl", "trace_0.json",
            "trace_1.json"} <= set(os.listdir(tdir))
    merged = fleet.merge_fleet_telemetry(tdir)
    recs = [json.loads(line) for line in open(merged)]
    assert {r["worker"] for r in recs} == {0, 1}
    assert sum(r["kind"] == "step" for r in recs) == 2 * STEPS


def test_collective_bytes_are_the_lora_leaves_and_two_scalars(dp2):
    r = dp2["collectives"]
    assert r["mesh"] == {"data": 2, "model": 1} and r["n_trainable"] > 0
    assert r["all_reduce_bytes"] == r["predicted_grad_sync_bytes"] == \
        r["trainable_f32_bytes"] + 8


def test_ladder_rungs_step_on_the_data_mesh(dp2):
    r = dp2["ladder"]
    by_rung = {row["rung"]: row for row in r["rungs"]}
    assert {"halve_batch", "engine_mesp", "quantize_int8",
            "truncate_seq"} <= set(by_rung)
    for rung, row in by_rung.items():
        assert row["built"], (rung, row.get("reason"))
        assert row["finite"], (rung, row)
    # batch 1 below the data size 2: every rank takes the whole batch
    assert by_rung["halve_batch"]["batch"] == 1
    assert by_rung["halve_batch"]["rows"] == 1
    assert by_rung["quantize_int8"]["quantize"] == "int8"


# ------------------------------------------------- Trainer.fit on DP-2
FIT_SPEC = dict(BASE, arch="qwen2.5-0.5b", engine="mesp", optimizer="sgd",
                batch=2, steps=5, ckpt_interval=2, device="cpu")
#: case -> (faults of the DP-2 run at batch 2, faults of the one-process
#: run it must match, at the batch it must match; None: no such run)
FITS = {"oom": ("oom@0", "", 1),
        "oom_crash": ("oom@0,crash@3", "crash@3", 1),
        "clean": ("", None, None),
        "corrupt": ("corrupt@4,crash@4", None, None)}


def _digest(params):
    import hashlib
    h = hashlib.sha256()
    for t in tree_leaves(params):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def dp2_fit(tmp_path_factory):
    """One fleet of 2 ranks running ``Trainer.fit`` for each of ``FITS``,
    each in a checkpoint directory of its own."""
    root = tmp_path_factory.mktemp("dp2_fit")
    payloads = [{"task": "fit", "spec": dict(
        FIT_SPEC, inject_faults=faults, ckpt_dir=str(root / case))}
        for case, (faults, _, _) in FITS.items()]
    res = fleet.run_fleet({"task": "sequence", "payloads": payloads},
                          devices=2, timeout=240)["results"]
    return dict(zip(FITS, res))


@pytest.mark.parametrize("case", ["oom", "oom_crash"])
def test_dp2_fit_halved_below_the_data_size_is_the_one_process_run(
        dp2_fit, case, tmp_path):
    """An OOM at batch 2 on two ranks halves the batch to 1, below the
    data size: every rank then reads the same row of the whole stream
    (``Trainer.make_data``, also after a crash and a restore past the
    rung), so the run is the one-process batch-1 run, losses and params
    bit for bit."""
    r = dp2_fit[case]
    _, faults, batch = FITS[case]
    assert r["mesh"] == {"data": 2, "model": 1}
    assert r["degradations"] == ["halve_batch"] and r["final_batch"] == 1
    (r0, r1) = r["ranks"]
    assert r0["read"] == r1["read"] and {n for n, _ in r0["read"]} == {1}
    assert r0["params"] == r1["params"]
    assert r0["counts"] == r1["counts"]
    one = Trainer.from_spec(TrainSpec(**dict(
        FIT_SPEC, batch=batch, inject_faults=faults,
        ckpt_dir=str(tmp_path / "one")))).fit()
    assert r["history"] == [[h.step, h.loss] for h in one.history]
    assert r0["params"] == _digest(one.params)


def test_dp2_fit_restores_past_a_corrupt_checkpoint(dp2_fit):
    """``corrupt@4,crash@4`` on two ranks: rank 0 alone corrupts and
    quarantines step 4, both ranks resume from step 2 and replay to the
    clean run's losses and params, each rank on its own shard's rows."""
    r, clean = dp2_fit["corrupt"], dp2_fit["clean"]
    (r0, r1), (c0, c1) = r["ranks"], clean["ranks"]
    assert r0["counts"] == r1["counts"]
    assert r0["counts"]["ckpt_quarantines"] == 1
    assert c0["read"] != c1["read"]             # disjoint host shards
    assert {n for n, _ in r0["read"] + r1["read"]} == {1}
    assert dict(map(tuple, r["history"])) == dict(map(tuple,
                                                      clean["history"]))
    assert len(r["history"]) == len(clean["history"]) + 2   # 2, 3 replayed
    assert r0["params"] == r1["params"] == c0["params"] == c1["params"]


# ------------------------------------------------------------ world size 1
@pytest.mark.parametrize("engine", ["mesp", "mesp_seq", "mezo"])
def test_one_rank_mesh_is_bit_identical_to_no_mesh(engine):
    case = "mesp_seq_sgd"
    losses, params, opt, tr = _single(
        case, mesh=elastic.make_mesh_from_devices([0], 1), engine=engine)
    assert tr.dp is not None and tr.dp.size == 1
    assert tr.dp.bytes_all_reduced == 0             # nothing all-reduced
    want_l, want_p, want_o, _ = _single(case, engine=engine)
    assert losses == want_l
    got, want = (tree_leaves(params) + tree_leaves(opt),
                 tree_leaves(want_p) + tree_leaves(want_o))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


# --------------------------------------------------------------- elastic
def test_elastic_resize_4_2_4_trajectory():
    spec = dict(BASE, engine="mesp", optimizer="sgd_momentum", seed=5)
    r = fleet.run_fleet({"task": "elastic", "spec": spec,
                         "phases": [2, 2, 2], "shrink_to": 2,
                         "label_drop": DROP}, devices=4, timeout=240)
    assert r["devices"] == 4 and r["shrink_to"] == 2
    assert r["reshard_bitexact"]
    assert r["b_vs_c_bitwise"], (r["losses_b"], r["losses_c"])
    assert r["b_vs_a_maxdiff"] <= 1e-6
    assert len(r["losses_b"]) == 6
    np.testing.assert_allclose(r["losses_b"], r["losses_a"], atol=ATOL,
                               rtol=RTOL)


# ----------------------------------------------------- mesh and batch math
@pytest.mark.parametrize("n,mp,pods", [(1, 2, 1), (0, 1, 1), (1, 0, 1),
                                       (1, 1, 0), (6, 4, 1), (8, 2, 3)])
def test_make_mesh_errors_are_the_reference_s(n, mp, pods):
    devs = jax.devices() * n if n <= 1 else list(range(n))
    try:
        jelastic.make_mesh_from_devices(devs, mp, pods)
    except ValueError as e:
        want = str(e)
    else:           # the reference needs real devices past one
        want = None
    with pytest.raises(ValueError) as e:
        elastic.make_mesh_from_devices(list(range(n)), mp, pods)
    if want is not None:
        assert str(e.value) == want


@pytest.mark.parametrize("n,mp,pods,axes,shape", [
    (1, 1, 1, ("data", "model"), {"data": 1, "model": 1}),
    (8, 2, 1, ("data", "model"), {"data": 4, "model": 2}),
    (8, 2, 2, ("pod", "data", "model"), {"pod": 2, "data": 2, "model": 2}),
    (4, 1, 1, ("data", "model"), {"data": 4, "model": 1}),
])
def test_make_mesh_shapes_are_the_reference_s(n, mp, pods, axes, shape):
    # the reference's own expectations (tests/multihost/
    # test_fleet_elastic.py), and its mesh itself at one device
    mesh = elastic.make_mesh_from_devices(list(range(n)), mp, pods)
    assert mesh.axis_names == axes and mesh.shape == shape
    assert mesh.rank_list == list(range(n))
    if n == 1:
        jm = jelastic.make_mesh_from_devices(jax.devices(), mp, pods)
        assert tuple(jm.axis_names) == axes
        assert {a: int(jm.shape[a]) for a in jm.axis_names} == shape
    assert make_host_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("args", [(256, 16, 8), (64, 4, 8), (24, 8, 6),
                                  (256, 16, 7), (256, 16, 0), (3, 1, 2)])
def test_rebalance_batch_is_the_reference_s(args):
    try:
        want = jelastic.rebalance_batch(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            elastic.rebalance_batch(*args)
        assert str(got.value) == str(e)
    else:
        assert elastic.rebalance_batch(*args) == want


def test_the_model_axis_is_refused():
    """What the model axis still refuses (``ROADMAP.md`` §1, item 3): a
    family other than dense, an engine other than mesp / mesp_cuda / mebp
    / store_h, and an axis that splits a head."""
    for payload in ({"task": "train", "spec": dict(BASE, model_parallel=2,
                                                   arch="olmoe-1b-7b")},
                    {"task": "train", "spec": dict(BASE, model_parallel=2,
                                                   engine="mesp_seq")}):
        with pytest.raises(ValueError, match="item 3"):
            fleet._run_task(payload)
    with pytest.raises(ValueError, match="item 3"):
        TrainSpec(model_parallel=2, arch="rwkv6-1.6b").validate()
    with pytest.raises(ValueError, match="n_heads = 14"):
        TrainSpec(model_parallel=4).validate()
    assert TrainSpec(model_parallel=2).validate().model_parallel == 2
    dp = elastic.DataParallel(elastic.make_mesh_from_devices([0, 1], 2))
    assert (dp.size, dp.index) == (1, 0)


# ------------------------------------------------------------ compression
def _trees(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    a[0, :3] = a[1, 0] = 2.5             # ties at the threshold
    b = rng.standard_normal(10).astype(np.float32)
    return {"a": a, "skip": None, "b": b}


def _to(tree, mod):
    f = torch.from_numpy if mod == "t" else jnp.asarray
    return {k: None if v is None else f(v) for k, v in tree.items()}


def _same(t, j):
    assert set(t) == set(j)
    for k in t:
        if t[k] is None:
            assert j[k] is None
        else:
            np.testing.assert_array_equal(
                t[k].float().numpy(), np.asarray(j[k], np.float32))


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_topk_with_error_feedback_is_the_reference_s(frac):
    err_t = err_j = None
    for step in range(4):
        g = _trees(step)
        sent_t, err_t = tcomp.topk_sparsify(_to(g, "t"), frac, err_t)
        sent_j, err_j = jcomp.topk_sparsify(_to(g, "j"), frac, err_j)
        _same(sent_t, sent_j)
        _same(err_t, err_j)
    k = max(1, int(24 * frac))
    assert int((sent_t["a"] != 0).sum()) >= k


def test_bf16_round_trip_is_the_reference_s():
    g = _trees(7)
    t = tcomp.to_bf16(_to(g, "t"))
    assert t["a"].dtype == torch.bfloat16 and t["skip"] is None
    _same(tcomp.from_bf16(t), jcomp.from_bf16(jcomp.to_bf16(_to(g, "j"))))
    assert tcomp.from_bf16(t)["b"].dtype == torch.float32
