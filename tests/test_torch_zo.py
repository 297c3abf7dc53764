"""The port's zeroth-order subsystem (``repro_torch.zo``, ``core/mezo.py``,
``core/gradcheck.py``) against the JAX reference (f32, CPU).

The model is ``test_torch_seq.py``'s (3 layers, d_model 160, 4/2 heads of
40, d_ff 192, vocab 97, qkv bias), batch 2, seq 48, with the reference's
``init_params(PRNGKey(0))`` bridged through numpy and every LoRA B redrawn
at 0.02. Draws differ between ``torch.Generator`` and ``jax.random``, so
what is held against the reference is what does not depend on them: the
sparse sampler's top-ρ mask, the low-rank sampler's paired-factor scales
and rank-1 structure, the blockwise sampler's one-layer mask at the same
layer; and the estimator fed the reference's own z (bridged from its
sampler): L± at 1e-5, and the projection within (|ΔL₊| + |ΔL₋|)/2ε of
the reference's, where ΔL are the measured differences of the losses.
Seed replay is bit for bit; Table 3's metrics at 1e-6.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import gradcheck as jgradcheck
from repro.models import model as JM
from repro.zo import estimator as jest
from repro.zo import samplers as jsamplers
from repro_torch import bridge
from repro_torch.api.policy import PLAIN, ExecutionPolicy
from repro_torch.api.registry import get_engine
from repro_torch.configs.base import ArchConfig
from repro_torch.core import gradcheck, mesp, mezo
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import optimizers
from repro_torch.zo import estimator, gradquality, samplers

_FIELDS = dict(name="zo-test", family="dense", n_layers=3, d_model=160,
               n_heads=4, n_kv_heads=2, d_ff=192, vocab=97, qkv_bias=True,
               tie_embeddings=True, dtype="float32")
JCFG = JaxArchConfig(**_FIELDS)
TCFG = ArchConfig(**_FIELDS)
BATCH, SEQ, EPS = 2, 48, 1e-3
ZO_ENGINES = ("mezo", "mezo_sparse", "mezo_lowrank", "mezo_block",
              "mezo_avg4")


def _redraw_b(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_b(v, rng)
        elif k == "b":
            out[k] = (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
        else:
            out[k] = v
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tree}


@pytest.fixture(scope="module")
def np_params():
    p = jax.tree_util.tree_map(np.asarray,
                               JM.init_params(jax.random.PRNGKey(0), JCFG))
    return _redraw_b(p, np.random.default_rng(1))


@pytest.fixture(scope="module")
def np_batch():
    return next(tpipe.make_batch_iterator(TCFG.vocab, SEQ, BATCH, seed=3,
                                          n_tokens=4096))


@pytest.fixture(scope="module")
def train_tree(np_params):
    """(the port's trainable tree, the reference's) of the same params."""
    jtrain, _ = JM.split_params(jax.tree_util.tree_map(jnp.asarray,
                                                       np_params))
    ttrain_, _ = TM.split_params(bridge.from_numpy_tree(np_params))
    return ttrain_, jtrain


# ------------------------------------------------------------- samplers


@pytest.mark.parametrize("name", sorted(samplers.SAMPLERS))
def test_seed_replay_is_bit_exact(name, train_tree):
    t, _ = train_tree
    s = samplers.get_sampler(name)
    assert isinstance(s, samplers.PerturbationSampler)
    z1, z2, z3 = s.sample(7, t), s.sample(7, t), s.sample(8, t)
    l1, l2, l3, lt = (_leaves(z) for z in (z1, z2, z3, t))
    assert l1.keys() == lt.keys()
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    assert any(not torch.equal(l1[k], l3[k]) for k in l1)
    assert all(l1[k].shape == lt[k].shape and l1[k].dtype == lt[k].dtype
               for k in l1)
    # frozen leaves stay None
    assert z1["embed"]["tok"] is None and z1["blocks"]["ln1"] is None


@pytest.mark.parametrize("zero_b", [False, True])
def test_sparse_mask_is_the_references(train_tree, zero_b):
    """Top-10 % |w| per leaf, jnp.quantile's interpolation; an all-equal
    leaf (B = 0 at init) gives a dense mask in both."""
    t, j = train_tree
    ref = jsamplers.SparseSampler(0.10)
    tl, jl = _leaves(t), _leaves(j)
    z = _leaves(samplers.SparseSampler(0.10).sample(3, t))
    for path, p in tl.items():
        jp = jl[path]
        if zero_b and path.endswith("/b"):
            p, jp = torch.zeros_like(p), jnp.zeros_like(jp)
        got = samplers.top_fraction_mask(p, 0.10)
        want = np.asarray(ref._mask(jp))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        if zero_b and path.endswith("/b"):
            assert bool(got.all())
        elif not zero_b:
            assert 0.09 < float(got.float().mean()) < 0.11
            assert bool((z[path][~got] == 0).all())
            assert bool((z[path][got] != 0).all())


@pytest.mark.parametrize("cross_scale", [True, False])
def test_lowrank_scales_and_rank_one_structure(train_tree, cross_scale):
    t, j = train_tree
    if cross_scale:
        got = samplers.paired_factor_scales(t)
        want = jsamplers._paired_factor_scales(j)
        np.testing.assert_allclose([float(s) for s in got],
                                   [float(s) for s in want], rtol=1e-6)
    scales = samplers.paired_factor_scales(t) if cross_scale else None
    z = samplers.LowRankSampler(cross_scale).sample(5, t)
    for i, (path, zl) in enumerate(sorted(_leaves(z).items())):
        s = float(scales[i]) if cross_scale else 1.0
        for layer in zl:
            sv = torch.linalg.svdvals(layer.double())
            assert float(sv[1]) < 1e-5 * float(sv[0]), path
        # z / s is an outer product u vᵀ of standard normals
        assert 0.2 < float((zl / s).square().mean().sqrt()) < 5, path


def test_blockwise_mask_is_the_references_at_the_same_layer(train_tree):
    t, j = train_tree
    seed, L = 11, TCFG.n_layers
    z = _leaves(samplers.BlockwiseSampler().sample(seed, t))
    layers = {k: [i for i in range(L) if bool(v[i].ne(0).any())]
              for k, v in z.items()}
    (idx,) = set(map(tuple, layers.values()))
    assert len(idx) == 1
    # the same draws, masked to the layer and scaled by sqrt(L)
    gen = torch.Generator().manual_seed(seed)
    torch.rand((), generator=gen)
    for path, p in sorted(_leaves(t).items()):
        dense = torch.randn(p.shape, generator=gen, dtype=p.dtype)
        mask = torch.zeros(L, 1, 1)
        mask[idx[0]] = 1
        assert torch.equal(z[path], dense * mask * L ** 0.5), path
    # the reference's z at a key that picks the same layer: same mask
    ref = jsamplers.BlockwiseSampler()
    for k in range(64):
        jz = _leaves(ref.sample(jax.random.PRNGKey(k), j))
        jl = {p: [i for i in range(L) if bool(jnp.any(v[i] != 0))]
              for p, v in jz.items()}
        if next(iter(jl.values())) == list(idx):
            break
    else:
        pytest.fail("no reference key picked the same layer")
    for path, zl in z.items():
        np.testing.assert_array_equal(zl.numpy() != 0,
                                      np.asarray(jz[path]) != 0, path)


def test_fold_in_is_deterministic_and_spreads():
    seeds = {samplers.fold_in(s, d) for s in range(8) for d in range(8)}
    assert len(seeds) == 64
    assert samplers.fold_in(3, 4) == samplers.fold_in(3, 4)
    assert all(0 <= s < 2 ** 63 for s in seeds)


# ------------------------------------------------------------ estimator


def _from_numpy(tree):
    if isinstance(tree, dict):
        return {k: _from_numpy(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(np.array(tree))


class _Fixed:
    """A sampler that returns one given z whatever the seed."""
    name = "fixed"

    def __init__(self, z):
        self.z = z

    def sample(self, seed, train):
        return self.z


@pytest.fixture(scope="module")
def jax_spsa(np_params, np_batch):
    """The reference's dense z, its L+ and L- and its spsa_grad."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    key = jax.random.PRNGKey(42)
    jtrain, jfrozen = JM.split_params(jp)
    z = jsamplers.DenseSampler().sample(key, jtrain)
    loss = jax.jit(lambda t: JM.loss_fn(JM.merge_params(t, jfrozen), JCFG,
                                        jb))
    lp = float(loss(jest.perturb(jtrain, z, EPS)))
    lm = float(loss(jest.perturb(jtrain, z, -EPS)))
    jl, jg = jax.jit(lambda p: jest.spsa_grad(p, JCFG, jb, key))(jp)
    return (jax.tree_util.tree_map(np.asarray, z), lp, lm, float(jl),
            {k: np.asarray(v) for k, v in _leaves(jg).items()})


@pytest.mark.parametrize("backend", ["plain", "structured", "cuda"])
def test_spsa_grad_fed_the_references_z(np_params, np_batch, jax_spsa,
                                        backend):
    """``cuda`` runs the forward kernels' plain versions on CPU tensors."""
    z_np, jlp, jlm, jloss, jgrads = jax_spsa
    params = bridge.from_numpy_tree(np_params)
    batch = {k: torch.from_numpy(v).long() for k, v in np_batch.items()}
    policy = ExecutionPolicy(backend=backend)
    z = _from_numpy(z_np)
    seen = []

    def loss_fn(t):
        seen.append(float(TM.loss_fn(TM.merge_params(t, frozen), TCFG,
                                     batch, policy=policy)))
        return torch.tensor(seen[-1])

    train, frozen = TM.split_params(params)
    estimator.spsa_grad_from_loss(loss_fn, train, 0, sampler=_Fixed(z),
                                  eps=EPS)
    lp, lm = seen
    np.testing.assert_allclose([lp, lm], [jlp, jlm], rtol=1e-5, atol=1e-5)
    loss, grads = estimator.spsa_grad(params, TCFG, batch, 0,
                                      sampler=_Fixed(z), eps=EPS,
                                      policy=policy)
    assert float(loss) == pytest.approx(0.5 * (lp + lm), rel=1e-6)
    proj, jproj = (lp - lm) / (2 * EPS), (jlp - jlm) / (2 * EPS)
    bound = (abs(lp - jlp) + abs(lm - jlm)) / (2 * EPS) + 1e-6
    assert abs(proj - jproj) <= bound, (proj, jproj, bound)
    got, zl = _leaves(grads), _leaves(z)
    assert got.keys() == jgrads.keys()
    for path, g in got.items():
        # the estimate is proj · z, the reference's jproj · z
        np.testing.assert_allclose(g.numpy(), proj * zl[path].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=path)
        np.testing.assert_allclose(
            g.numpy(), jgrads[path], rtol=0,
            atol=bound * float(zl[path].abs().max()) + 1e-6, err_msg=path)
    assert grads["embed"]["tok"] is None


def _toy():
    rng = np.random.default_rng(0)
    train = {"a": torch.from_numpy(rng.standard_normal((3, 4, 2))
                                   .astype(np.float32)),
             "w": None}
    target = torch.from_numpy(rng.standard_normal((3, 4, 2))
                              .astype(np.float32))
    return train, lambda t: ((t["a"] - target) ** 2).sum()


def test_multi_query_seeds_are_folded_from_the_step_seed():
    train, loss = _toy()
    dense = samplers.DenseSampler()
    l4, g4 = estimator.spsa_grad_from_loss(loss, train, 9, sampler=dense,
                                           queries=4)
    singles = [estimator.spsa_grad_from_loss(
        loss, train, samplers.fold_in(9, q), sampler=dense)
        for q in range(4)]
    acc = singles[0][1]["a"]
    for _, g in singles[1:]:
        acc = acc + g["a"]
    assert torch.equal(g4["a"], acc * 0.25) and g4["w"] is None
    lsum = singles[0][0]
    for l, _ in singles[1:]:
        lsum = lsum + l
    assert torch.equal(l4, lsum * 0.25)
    # the estimate points along the true gradient on a quadratic
    true = torch.autograd.functional.jacobian(
        lambda a: loss({"a": a}), train["a"])
    _, g64 = estimator.spsa_grad_from_loss(loss, train, 1, sampler=dense,
                                           queries=64)
    assert float(torch.nn.functional.cosine_similarity(
        g64["a"].reshape(-1), true.reshape(-1), 0)) > 0.5
    with pytest.raises(ValueError, match="queries"):
        estimator.spsa_grad_from_loss(loss, train, 0, sampler=dense,
                                      queries=0)


def test_probe_forwards_run_without_grad(np_params, np_batch):
    params = bridge.from_numpy_tree(np_params)
    batch = {k: torch.from_numpy(v).long() for k, v in np_batch.items()}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(1) or t, lambda t: t):
        loss, grads = estimator.spsa_grad(params, TCFG, batch, 1)
    assert not saved and not loss.requires_grad
    # the core.mezo shim is the dense sampler, one query
    l2, g2 = mezo.spsa_grad(params, TCFG, batch, 1)
    assert torch.equal(loss, l2)
    assert all(torch.equal(u, v) for u, v in zip(
        _leaves(grads).values(), _leaves(g2).values()))
    p1, l1 = estimator.train_step(params, TCFG, batch, 1, 0.5)
    p2, l3 = mezo.train_step(params, TCFG, batch, 1, 0.5)
    assert torch.equal(l1, l3) and torch.equal(
        p1["blocks"]["mlp"]["up"]["a"], p2["blocks"]["mlp"]["up"]["a"])


# --------------------------------------------------------------- Table 3


def _np_grad_tree(rng, with_none=True):
    return {"blocks": {"q": {"a": rng.standard_normal((3, 6, 2)),
                             "b": rng.standard_normal((3, 2, 6)),
                             "w": None if with_none else
                             rng.standard_normal((3, 6, 6))}},
            "head": None}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(np.asarray(tree, np.float32))


def test_gradient_metrics_match_reference():
    rng = np.random.default_rng(2)
    est, true = _np_grad_tree(rng), _np_grad_tree(rng)
    est["blocks"]["q"]["a"][0] = -true["blocks"]["q"]["a"][0]
    got = gradcheck.gradient_metrics(_as(est, torch.from_numpy),
                                     _as(true, torch.from_numpy))
    want = jgradcheck.gradient_metrics(_as(est, jnp.asarray),
                                       _as(true, jnp.asarray))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    rows = gradcheck.per_layer_metrics(_as(est, torch.from_numpy)["blocks"],
                                       _as(true, torch.from_numpy)["blocks"],
                                       3)
    jrows = jgradcheck.per_layer_metrics(_as(est, jnp.asarray)["blocks"],
                                         _as(true, jnp.asarray)["blocks"], 3)
    assert [r.keys() for r in rows] == [r.keys() for r in jrows]
    for r, jr in zip(rows, jrows):
        assert r["layer"] == jr["layer"]
        for k in ("cosine_sim", "sign_agree", "rel_error"):
            np.testing.assert_allclose(r[k], jr[k], rtol=1e-6, atol=1e-7)


#: the reference's probe_over_steps keys (``repro/zo/gradquality.py``)
OVER_STEPS_KEYS = {"steps", "probes", "cosine_mean", "cosine_std",
                   "cosine_sem", "cosine_abs_mean", "sign_agree_mean",
                   "rel_error_mean", "per_layer_cosine_mean"}


def test_probe_reports_the_references_keys(np_params, np_batch):
    params = bridge.from_numpy_tree(np_params)
    batch = {k: torch.from_numpy(v).long() for k, v in np_batch.items()}
    assert gradquality.zo_engine_names() == ZO_ENGINES
    out = gradquality.probe("mezo", params, TCFG, batch, 3)
    assert set(out) == {"global", "per_layer"}
    assert set(out["global"]) == {"cosine_sim", "sign_agree", "rel_error"}
    assert len(out["per_layer"]) == TCFG.n_layers
    assert [r["layer"] for r in out["per_layer"]] == [0, 1, 2]
    assert abs(out["global"]["cosine_sim"]) < 0.2
    # an exact engine against the reference engine: cosine 1
    same = gradquality.probe("mesp_cuda", params, TCFG, batch, 3)
    assert same["global"]["cosine_sim"] == pytest.approx(1.0, abs=1e-5)
    assert same["global"]["rel_error"] < 1e-4


def test_probe_over_steps_reports_the_references_keys():
    cfg = ArchConfig(name="zo-tiny", family="dense", n_layers=2, d_model=32,
                     n_heads=2, n_kv_heads=1, d_ff=48, vocab=31,
                     dtype="float32")
    out = gradquality.probe_over_steps(["mezo", "mezo_block"], cfg, steps=2,
                                       warmup=2, seq=16, batch=1, probes=2)
    assert set(out) == {"mezo", "mezo_block"}
    for name, rec in out.items():
        assert set(rec) == OVER_STEPS_KEYS, name
        assert rec["steps"] == 2 and rec["probes"] == 2
        assert len(rec["per_layer_cosine_mean"]) == 2
        assert all(np.isfinite(v) for k, v in rec.items()
                   if k != "per_layer_cosine_mean")


# -------------------------------------------------------------- engines


def test_zo_engine_step_seeds_come_from_the_spec_seed_and_step(np_params,
                                                              np_batch):
    params = bridge.from_numpy_tree(np_params)
    batch = {k: torch.from_numpy(v).long() for k, v in np_batch.items()}
    opt = optimizers.make_optimizer("sgd", 1e-2)
    eng = get_engine("mezo")
    assert eng.backend is None
    runs = []
    for seed in (0, 0, 1):
        step = eng.build_step(types.SimpleNamespace(seed=seed), TCFG, opt,
                              PLAIN)
        p, s, _ = step(params, opt.init(params), batch)
        p, s, _ = step(p, s, batch)
        runs.append(p["blocks"]["attn"]["q"]["a"])
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                              runs[2])
    # step 1's probe is fold_in(seed, 1), not step 0's again
    l0, g0 = estimator.spsa_grad(params, TCFG, batch,
                                 samplers.fold_in(0, 0))
    one = eng.build_step(types.SimpleNamespace(seed=0), TCFG, opt, PLAIN)
    p1, _, l1 = one(params, opt.init(params), batch)
    assert torch.equal(l0, l1)


@pytest.mark.parametrize("engine", ZO_ENGINES)
def test_train_cli_zo_engines_train(engine):
    run = ["--reduced", "--device", "cpu", "--seq", "32", "--steps", "2",
           "--engine", engine, "--lr", "1e-2"]
    out = ttrain.train(run)
    init = TM.init_params(out["cfg"],
                          generator=torch.Generator().manual_seed(0))
    assert out["policy"].backend == "plain"
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    mask = _leaves(TM.trainable_mask(init))
    got, before = _leaves(out["params"]), _leaves(init)
    assert any(not torch.equal(got[k], before[k]) for k in got if mask[k])
    assert all(torch.equal(got[k], before[k]) for k in got if not mask[k])
