"""Training under the port's model axis (``models/parallel.py``,
``runtime/elastic.ModelParallel``, the Trainer's (data, model) mesh)
against the port's single process and the reference, on the CPU (the
placement rules and refusals: ``test_torch_sharding.py``).

Real ``gloo`` fleets (``launch/fleet.run_fleet``), one of 2
ranks (TP 2: data 1 x model 2) and one of 4 (DP 2 x TP 2), each a
``sequence`` task under its own timeout, at the reduced qwen2.5-0.5b (d
64, 4 q and 2 KV heads of 16, d_ff 128, vocab 256, 2 layers, f32, LoRA
r 4). Every run starts from the reference's ``init_params`` bridged
through numpy and drops a quarter of the labels. Sequence 32 divides over
the model axis (sequence parallelism on); 33 does not (off, the block
inputs replicated). Tolerances: the port's single process at atol + rtol
1e-6 (the ranks sum partials in another order), the reference's
single-device Trainer at 1e-5; resizes against the checkpoint path bit
for bit.
"""
import functools
import hashlib
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.api import Trainer as JaxTrainer
from repro.api import TrainSpec as JaxSpec
from repro_torch import bridge
from repro_torch.api.spec import TrainSpec
from repro_torch.api.trainer import Trainer
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.launch import fleet
from repro_torch.models.model import split_params
from repro_torch.runtime import elastic
from repro_torch.tree import leaves_with_paths, path_str, tree_leaves

ATOL = RTOL = 1e-6
JAX_TOL = 1e-5
STEPS = 3
DROP = 0.25
BASE = {"reduced": True, "batch": 4, "seed": 3, "lr": 5e-3,
        "optimizer": "sgd_momentum"}
#: sequence parallelism on (32 divides over 2) and off (33 does not)
SEQS = {"sp": 32, "no_sp": 33}
ENGINES = ("mesp", "mesp_cuda")
BASES = ("none", "int8", "nf4")
CASES = [(e, q, s) for e in ENGINES for q in BASES for s in SEQS]
LADDER = dict(BASE, engine="mesp_cuda", optimizer="sgd", batch=2, seq=64,
              model_parallel=2)
FIT = dict(BASE, engine="mesp", optimizer="sgd", batch=2, seq=32, steps=4,
           ckpt_interval=2, device="cpu")


def _spec(engine, quantize, seq, mp=2):
    return dict(BASE, engine=engine, quantize=quantize, seq=SEQS[seq],
                model_parallel=mp)


@functools.lru_cache(maxsize=None)
def _init(quantize):
    """The reference's fresh params over a base of ``quantize``, as the
    port's tree."""
    params, _ = JaxTrainer.from_spec(JaxSpec(**dict(
        BASE, seq=32, quantize=quantize, ckpt_dir=tempfile.mkdtemp()))
    ).init_state()
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _single(engine, quantize, seq):
    """(losses, params, opt) of the port's Trainer in this process."""
    spec = dict(_spec(engine, quantize, seq, mp=1), device="cpu")
    tr = Trainer.from_spec(TrainSpec(**spec))
    params = _init(quantize)
    opt = tr.opt.init(params)
    losses = []
    params, opt = fleet._steps(tr, params, opt, {"label_drop": DROP}, 0,
                               STEPS, losses)
    return losses, params, opt


def _train_payloads(root, tag):
    out = []
    for case in CASES:
        engine, q, seq = case
        init = root / f"init_{q}.pt"
        if not init.exists():
            torch.save(_init(q), str(init))
        out.append({"task": "train", "spec": _spec(*case), "steps": STEPS,
                    "label_drop": DROP, "init": str(init),
                    "out": str(root / f"{tag}_{engine}_{q}_{seq}.pt")})
    return out


def _run(payloads, devices):
    return fleet.run_fleet({"task": "sequence", "payloads": payloads},
                           devices=devices, timeout=240)["results"]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """One fleet of 2 ranks (data 1 x model 2): the twelve training cases,
    the collectives step with SP on and off, the saved tensors, the ladder
    from a bf16-like and an int8 base, the 2 -> 1 change of the model
    axis, and ``Trainer.fit`` writing a checkpoint at mp 2 and resuming one
    written by the single process."""
    root = tmp_path_factory.mktemp("tp2")
    one = Trainer.from_spec(TrainSpec(**dict(FIT, ckpt_dir=str(
        root / "one_ckpt")))).fit()
    coll = dict(BASE, engine="mesp", optimizer="sgd", model_parallel=2)
    payloads = _train_payloads(root, "tp2") + [
        {"task": "collectives", "label_drop": DROP,
         "spec": dict(coll, seq=SEQS["sp"])},
        {"task": "collectives", "label_drop": DROP,
         "spec": dict(coll, seq=SEQS["no_sp"])},
        {"task": "saved", "spec": dict(coll, engine="mesp_cuda", seq=32)},
        {"task": "ladder", "spec": LADDER},
        {"task": "ladder", "spec": dict(LADDER, quantize="int8")},
        {"task": "elastic", "spec": dict(coll, seq=32, seed=5),
         "plan": [[2, 2, 2], [2, 1, 2]], "label_drop": DROP},
        {"task": "fit", "spec": dict(FIT, model_parallel=2,
                                     ckpt_dir=str(root / "tp_ckpt"))},
        {"task": "fit", "spec": dict(FIT, model_parallel=2,
                                     ckpt_dir=str(root / "one_ckpt"))},
    ]
    res = _run(payloads, 2)
    names = [f"train_{e}_{q}_{s}" for e, q, s in CASES] + [
        "coll_sp", "coll_no_sp", "saved", "ladder", "ladder_int8",
        "mp_change", "fit", "fit_resume"]
    out = dict(zip(names, res))
    for e, q, s in CASES:
        out[f"train_{e}_{q}_{s}"]["state"] = torch.load(
            str(root / f"tp2_{e}_{q}_{s}.pt"), weights_only=True)
    out["root"], out["one"] = root, one
    return out


@pytest.fixture(scope="module")
def dp2tp2(tmp_path_factory):
    """One fleet of 4 ranks (data 2 x model 2): the twelve training cases,
    the collectives step and a live 4 -> 2 -> 4 resize at mp 2."""
    root = tmp_path_factory.mktemp("dp2tp2")
    payloads = _train_payloads(root, "dp2tp2") + [
        {"task": "collectives", "label_drop": DROP, "spec": dict(
            BASE, engine="mesp", optimizer="sgd", seq=32,
            model_parallel=2)},
        {"task": "elastic", "spec": dict(BASE, engine="mesp", seq=32,
                                         seed=5, model_parallel=2),
         "phases": [2, 2, 2], "shrink_to": 2, "label_drop": DROP}]
    res = _run(payloads, 4)
    names = [f"train_{e}_{q}_{s}" for e, q, s in CASES] + ["coll", "elastic"]
    out = dict(zip(names, res))
    for e, q, s in CASES:
        out[f"train_{e}_{q}_{s}"]["state"] = torch.load(
            str(root / f"dp2tp2_{e}_{q}_{s}.pt"), weights_only=True)
    return out


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        if not isinstance(a, torch.Tensor):
            assert a == b, (what, p)
        elif a.is_floating_point():
            np.testing.assert_allclose(
                a.double().numpy(), b.double().numpy(), atol=atol,
                rtol=rtol, err_msg=f"{what} {path_str(p)}")
        else:
            assert torch.equal(a, b), (what, path_str(p))


# ------------------------------------------------------------ training
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("fleet_name", ["tp2", "dp2tp2"])
def test_tensor_parallel_matches_the_single_process(request, fleet_name,
                                                    case):
    res = request.getfixturevalue(fleet_name)["train_" + "_".join(case)]
    assert res["mesh"] == ({"data": 1, "model": 2} if fleet_name == "tp2"
                           else {"data": 2, "model": 2})
    losses, params, opt = _single(*case)
    np.testing.assert_allclose(res["losses"], losses, atol=ATOL, rtol=RTOL)
    assert len(set(losses)) > 1                  # the run trains
    _close(res["state"]["params"], params, f"{case} params")
    _close(res["state"]["opt"], opt, f"{case} opt")


@functools.lru_cache(maxsize=None)
def _jax_losses(quantize, seq):
    """The reference's single-device Trainer (engine mesp) on the bridged
    params' source and the fleet's batches."""
    import jax.numpy as jnp
    tr = JaxTrainer.from_spec(JaxSpec(**dict(
        BASE, engine="mesp", quantize=quantize, seq=SEQS[seq],
        ckpt_dir=tempfile.mkdtemp())))
    params, opt = tr.init_state()
    spec = tr.live_spec
    out = []
    for step in range(STEPS):
        batch = fleet.synth_batch(tr.cfg, spec.batch, spec.seq, spec.seed,
                                  step, DROP)
        params, opt, loss = tr.step_fn(params, opt, {
            k: jnp.asarray(v) for k, v in batch.items()})
        out.append(float(loss))
    return out


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_tensor_parallel_losses_match_the_reference_trainer(tp2, dp2tp2,
                                                            case):
    """Both meshes' losses against the reference's single-device Trainer
    fed the same params and batches (its ``mesp``: the port's mesp_cuda
    runs the same rules through the kernels' plain versions)."""
    _, quantize, seq = case
    want = _jax_losses(quantize, seq)
    for res in (tp2, dp2tp2):
        np.testing.assert_allclose(res["train_" + "_".join(case)]["losses"],
                                   want, rtol=JAX_TOL, atol=JAX_TOL)


# ------------------------------------------------------------ the counts
def _model_axis_bytes(cfg, tokens, mp, sp, partial, act=4):
    """Bytes handed to the model axis in one step of the dense family
    under remat, derived from the config: sums (all-reduce and
    reduce-scatter inputs, the whole [tokens, d]) travel in f32, gathers
    (this rank's [tokens / mp, d]) in the activations' type. Each block
    runs its forward collectives twice (the checkpoint's recompute stops
    after the down linear, the last op that saves a tensor, so it skips
    down's sum), and its backward ones once; block 0's ln1 output needs no
    gradient. Then the embedding's sum, the head's gather (its gradient's
    sum), the loss (a MAX of the row maxima, a sum of [2, tokens]) and the
    partial LoRA leaves in f32."""
    d, L = cfg.d_model, cfg.n_layers
    whole = tokens * d * 4
    if sp:
        ag = tokens // mp * d * act
        fwd, bwd = 2 * (ag + whole), 2 * (whole + ag)
        head = ag + whole
    else:          # copy (gradient all-reduced) and reduce (all-reduced)
        fwd = bwd = 2 * whole
        head = whole
    blocks = L * (fwd + (fwd - whole) + bwd) - whole
    return blocks + whole + head + 3 * tokens * 4 + 4 * partial


@pytest.mark.parametrize("seq", list(SEQS))
def test_bytes_model_axis_are_derived_from_the_config(tp2, seq):
    r = tp2["coll_" + seq]
    cfg = get_config("qwen2.5-0.5b").reduced()
    assert r["sp"] == (seq == "sp") and r["mesh"] == {"data": 1, "model": 2}
    # the partial leaves: A of q, k, v, gate, up; B of o, down
    r_ = cfg.lora.rank
    partial = cfg.n_layers * r_ * (5 * cfg.d_model + 2 * cfg.d_model)
    assert r["partial_numel"] == partial
    assert r["bytes_model_axis"] == _model_axis_bytes(
        cfg, BASE["batch"] * SEQS[seq], 2, seq == "sp", partial)
    assert r["all_reduce_bytes"] == 0             # one data rank


def test_bytes_all_reduced_are_the_rank_s_lora_leaves(dp2tp2):
    r = dp2tp2["coll"]
    assert r["mesh"] == {"data": 2, "model": 2} and r["sp"]
    assert r["rank_trainable"] < r["n_trainable"]
    assert r["all_reduce_bytes"] == r["trainable_f32_bytes"] + 8
    assert r["all_reduce_bytes"] >= r["grad_sync_floor"] == \
        elastic.predicted_grad_sync_bytes(r["n_trainable"], r["mesh"]) > 0
    cfg = get_config("qwen2.5-0.5b").reduced()
    assert r["bytes_model_axis"] == _model_axis_bytes(
        cfg, BASE["batch"] // 2 * 32, 2, True, r["partial_numel"])


def test_each_rank_stores_its_part_of_the_block_inputs(tp2):
    """remat on: the outer forward keeps one input a block and the final
    norm's, each [B, N / mp, d] under SP (the single process keeps [B, N,
    d]); remat off: no [B·N, r] h and no [B, N, r] h anywhere (MeSP)."""
    r = tp2["saved"]
    cfg = get_config("qwen2.5-0.5b").reduced()
    B, N, d, L = BASE["batch"], 32, cfg.d_model, cfg.n_layers
    assert r["sp"]
    inputs = [s for s in r["remat"] if len(s) == 3 and s[2] == d]
    assert sorted(inputs) == [[B, N // 2, d]] * (L + 1), r["remat"]
    for s in r["no_remat"]:
        assert not (s[-1] == cfg.lora.rank and np.prod(s[:-1]) == B * N), s


# ------------------------------------------------------------ resizes
def test_model_axis_change_2_to_1_is_the_checkpoint_path(tp2):
    r = tp2["mp_change"]
    assert r["plan"] == [[2, 2, 2], [2, 1, 2]]
    assert r["reshard_bitexact"]
    assert r["b_vs_c_bitwise"], (r["losses_b"], r["losses_c"])
    assert r["b_vs_a_maxdiff"] <= 1e-6
    np.testing.assert_allclose(r["losses_b"], r["losses_a"], atol=ATOL,
                               rtol=RTOL)


def test_elastic_resize_4_2_4_at_model_axis_2(dp2tp2):
    r = dp2tp2["elastic"]
    assert r["plan"] == [[4, 2, 2], [2, 2, 2], [4, 2, 2]]
    assert r["reshard_bitexact"]
    assert r["b_vs_c_bitwise"], (r["losses_b"], r["losses_c"])
    assert r["b_vs_a_maxdiff"] <= 1e-6 and len(r["losses_b"]) == 6
    np.testing.assert_allclose(r["losses_b"], r["losses_a"], atol=ATOL,
                               rtol=RTOL)


def _digest(tree):
    h = hashlib.sha256()
    for t in tree_leaves(tree, sort=True):
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def test_checkpoints_cross_the_model_axis(tp2):
    """``Trainer.fit`` at mp 2 saves whole trees: its checkpoint is the
    single process's run to 1e-6; and it resumes the single process's
    checkpoint, placing it by its specs, bit for bit (nothing left to
    run)."""
    from repro_torch.checkpoint import latest_step, load_checkpoint
    fit, resume, one = tp2["fit"], tp2["fit_resume"], tp2["one"]
    assert fit["mesh"] == {"data": 1, "model": 2}
    d = str(tp2["root"] / "tp_ckpt")
    params = load_checkpoint(d, latest_step(d))[0]
    _close(params, one.params, "mp-2 checkpoint vs one process")
    np.testing.assert_allclose([l for _, l in fit["history"]],
                               [h.loss for h in one.history], atol=ATOL,
                               rtol=RTOL)
    assert resume["history"] == []
    assert resume["ranks"][0]["params"] == resume["ranks"][1]["params"]
    h = hashlib.sha256()
    for t in tree_leaves(one.params):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    assert resume["ranks"][0]["params"] == h.hexdigest()


@pytest.mark.parametrize("base", ["none", "int8"])
def test_ladder_rungs_step_on_the_model_axis(tp2, base):
    r = tp2["ladder" if base == "none" else "ladder_int8"]
    by_rung = {row["rung"]: row for row in r["rungs"]}
    want = {"halve_batch", "engine_mesp", "truncate_seq",
            "quantize_int8" if base == "none" else "quantize_int4"}
    assert want <= set(by_rung) and r["mesh"] == {"data": 1, "model": 2}
    for rung, row in by_rung.items():
        assert row["built"], (rung, row.get("reason"))
        assert row["finite"] and row["sp"], (rung, row)
    # the quantize rung's codes and scales: the single process's, sliced
    rung = "quantize_int8" if base == "none" else "quantize_int4"
    tr = Trainer.from_spec(TrainSpec(**dict(LADDER, quantize=base,
                                            model_parallel=1,
                                            device="cpu")))
    params, _ = tr.init_state()
    params = quant.quantize_frozen(params, method=rung.split("_")[1])
    assert by_rung[rung]["base_sha256"] == _digest(split_params(params)[1])


