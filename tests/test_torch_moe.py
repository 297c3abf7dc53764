"""The port's MoE training slice against the JAX reference (f32, CPU).

1. ``core/structured``'s LoRA Functions over per-expert stacks (x [E, C, K],
   w0 [E, K, N]) against the reference's custom_vjps: outputs and the x, a,
   b gradients at 1e-5, and the saved-tensor set (h not saved by
   ``lora_linear``).
2. The grouped kernels' plain versions against the Pallas kernels in
   interpret mode: the forward over an expert stack (#8 with Ew = E), dx
   (#11) and dA/dB (#12), on a ragged gid with an empty group; and
   ``kops.lora_grouped_linear`` against the reference's dispatch (E 3, C 13,
   which pads to bm 16; E 4, C 72).
3. Routing: the stable-sort top-k against ``jax.lax.top_k`` on 2048 rows of
   64 bf16-rounded router logits, which tie; ``moe_mlp`` and
   ``aux_load_balance_loss`` against the reference.
4. The model: loss and every LoRA leaf of reduced ``olmoe-1b-7b`` and
   ``deepseek-moe-16b`` against ``repro.core.mesp.value_and_grad`` (weights
   from the reference's ``init_params`` with B redrawn at 0.02, bridged
   through numpy): ``cuda`` against ``pallas`` in interpret mode,
   ``structured``, ``plain`` and ``store_h`` against their namesakes, at
   relative L2 1e-5 per leaf.
5. No copy of an expert stack on the ``cuda`` path: a ``TorchDispatchMode``
   records every floating tensor any op makes, with recording suspended
   inside the three grouped kernel wrappers (whose plain versions gather
   each tile's W0 by nature); the saved-tensor contract with remat off.
6. The CLI: one f32 loss curve under every engine; ``--quantize`` taken
   (``test_torch_moe_quant.py`` holds the quantized base).

The tests marked ``cuda`` hold the three CUDA kernels against their plain
versions on a card and skip without one. JAX is imported only inside the
parity fixtures, so the card tests run where JAX is not installed.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.core import mesp
from repro_torch.core import structured as TS
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import lora_grouped as tlg
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
#: the port's backend -> the reference backend it is held against
JAX_BACKEND = {"cuda": "pallas", "structured": "structured",
               "plain": "plain", "store_h": "store_h"}
BATCH, SEQ = 2, 48


@pytest.fixture(scope="module")
def jx():
    """The reference's modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api.policy import ExecutionPolicy as JaxPolicy
    from repro.configs import get_config as jax_config
    from repro.core import mesp as jmesp
    from repro.core import structured as JS
    from repro.kernels import lora_grouped, ops
    from repro.models import model as JM
    from repro.models import moe as jmoe
    return SimpleNamespace(jax=jax, jnp=jnp, Policy=JaxPolicy,
                           config=jax_config, mesp=jmesp, S=JS,
                           lg=lora_grouped, ops=ops, M=JM, moe=jmoe)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jvjp(jx, fn, inputs, grad_of, cot):
    """Output and the gradients wrt ``grad_of`` of a JAX function."""
    jin = [jx.jnp.asarray(x) for x in inputs]

    def f(*d):
        return fn(*[d[grad_of.index(i)] if i in grad_of else jin[i]
                    for i in range(len(jin))])
    out, vjp = jx.jax.vjp(f, *[jin[i] for i in grad_of])
    return np.asarray(out), [np.asarray(g) for g in vjp(jx.jnp.asarray(cot))]


def _tvjp(fn, inputs, grad_of, cot):
    tin = [torch.from_numpy(x).requires_grad_(i in grad_of)
           for i, x in enumerate(inputs)]
    out = fn(*tin)
    grads = torch.autograd.grad(out, [tin[i] for i in grad_of],
                                torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _stack_inputs(seed, E, C, K, N, r):
    """x [E,C,K], w0 [E,K,N], a [E,K,r], b [E,r,N] (nonzero), cot [E,C,N]."""
    rng = np.random.default_rng(seed)
    return (_rand(rng, E, C, K, scale=0.5), _rand(rng, E, K, N, scale=K ** -0.5),
            _rand(rng, E, K, r, scale=0.4), _rand(rng, E, r, N, scale=0.3),
            _rand(rng, E, C, N, scale=0.5))


# ------------------------------------------------ structured Functions


@pytest.mark.parametrize("name", ["lora_linear", "lora_linear_store_h"])
def test_structured_lora_takes_expert_stacks(jx, name):
    """x [3, 5, 8] over w0 [3, 8, 6]: the reference's ``w0.ndim`` branch
    (per-expert batched dA/dB); the port's Function saves h only under
    ``store_h``."""
    x, w0, a, b, cot = _stack_inputs(30, 3, 5, 8, 6, 2)
    jfn, tfn = getattr(jx.S, name), getattr(TS, name)
    want, jgrads = _jvjp(jx, lambda *t: jfn(*t, None, 2.0), [x, w0, a, b],
                         [0, 2, 3], cot)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        got, tgrads = _tvjp(lambda *t: tfn(*t, None, 2.0), [x, w0, a, b],
                            [0, 2, 3], cot)
    np.testing.assert_allclose(got, want, **TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **TOL)
    h = (3, 5, 2)
    want_saved = [x.shape, w0.shape, a.shape, b.shape] + (
        [h] if name == "lora_linear_store_h" else [])
    assert sorted(saved) == sorted(want_saved), saved


# --------------------------------------------- grouped kernels, plain


def _gid_inputs(seed, M, K, N, E, r):
    rng = np.random.default_rng(seed)
    return (_rand(rng, M, K, scale=0.5), _rand(rng, E, K, N, scale=K ** -0.5),
            _rand(rng, E, K, r, scale=0.4), _rand(rng, E, r, N, scale=0.3),
            _rand(rng, M, N, scale=0.5))


# (M, K, N, E, r, bm, gid): ragged groups (tile counts 2, 0, 3, 1), group 1
# empty; a single expert owning every tile; odd K and N, ranks 3 and 16
RAGGED_CASES = [
    (48, 40, 24, 4, 4, 8, [0, 0, 2, 2, 2, 3]),
    (24, 33, 17, 3, 3, 8, [2, 2, 2]),
    (32, 72, 129, 2, 16, 16, [0, 1]),
]


@pytest.mark.parametrize("M,K,N,E,r,bm,gid", RAGGED_CASES)
def test_grouped_train_plain_versions_match_pallas_kernels(
        jx, M, K, N, E, r, bm, gid):
    """#8 (Ew = E), #11 and #12's plain versions against the Pallas kernels
    in interpret mode; an empty group's dA and dB are zero in both."""
    jnp = jx.jnp
    x, w0, a, b, g = _gid_inputs(31, M, K, N, E, r)
    jg = jnp.asarray(gid, jnp.int32)
    tx, tw, ta, tb, tgr = _t(x, w0, a, b, g)
    tgid = torch.tensor(gid, dtype=torch.int32)
    want = jx.lg.lora_grouped(jnp.asarray(x), jnp.asarray(w0), jnp.asarray(a),
                              jnp.asarray(b), jg, 2.0, bm=bm, interpret=True)
    got = tlg.lora_grouped_gemm(tx, tw, ta, tb, tgid, 2.0, bm=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jx.lg.lora_grouped_dx(jnp.asarray(g), jnp.asarray(w0),
                                 jnp.asarray(a), jnp.asarray(b), jg, 2.0,
                                 bm=bm, interpret=True)
    got = tlg.lora_grouped_dx(tgr, tw, ta, tb, tgid, 2.0, bm=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wda, wdb = jx.lg.lora_grouped_dab(jnp.asarray(x), jnp.asarray(g),
                                      jnp.asarray(a), jnp.asarray(b), jg,
                                      2.0, bm=bm, interpret=True)
    da, db = tlg.lora_grouped_dab(tx, tgr, ta, tb, tgid, 2.0, bm=bm)
    np.testing.assert_allclose(da.numpy(), np.asarray(wda), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(wdb), **TOL)
    for e in set(range(E)) - set(gid):
        assert not da[e].any() and not db[e].any()
    # a shared [K, N] base is the decode kernel's, not these
    with pytest.raises(ValueError, match="per-expert stack"):
        tlg.lora_grouped_gemm(tx, tw[0], ta, tb, tgid, 2.0, bm=bm)
    with pytest.raises(ValueError, match="per-expert stack"):
        tlg.lora_grouped_dx(tgr, tw[0], ta, tb, tgid, 2.0, bm=bm)


def test_grouped_train_plain_versions_mark_bad_gid_and_split_groups():
    """A gid outside [0, E) gives NaN rows (forward, dx) and adds its tile
    to no group (dA/dB); a group whose tiles are not one run gets NaN dA and
    dB, as the kernel does."""
    x, w0, a, b, g = _t(*_gid_inputs(32, 32, 24, 16, 3, 4))
    gid = torch.tensor([0, 7, 1, -1], dtype=torch.int32)
    y = tlg.lora_grouped_gemm(x, w0, a, b, gid, 2.0, bm=8)
    dx = tlg.lora_grouped_dx(g, w0, a, b, gid, 2.0, bm=8)
    for out in (y, dx):
        bad = out.reshape(4, 8, -1).isnan().all(-1).all(-1)
        assert bad.tolist() == [False, True, False, True]
        assert torch.isfinite(out.reshape(4, 8, -1)[[0, 2]]).all()
    da, db = tlg.lora_grouped_dab(x, g, a, b, gid, 2.0, bm=8)
    good = torch.tensor([0, 2])
    want = tlg.lora_grouped_dab(x.reshape(4, 8, -1)[good].reshape(16, -1),
                                g.reshape(4, 8, -1)[good].reshape(16, -1),
                                a, b, torch.tensor([0, 1], dtype=torch.int32),
                                2.0, bm=8)
    torch.testing.assert_close(da, want[0])
    torch.testing.assert_close(db, want[1])
    da, db = tlg.lora_grouped_dab(x, g, a, b, torch.tensor(
        [1, 0, 1, 2], dtype=torch.int32), 2.0, bm=8)
    assert da[1].isnan().all() and db[1].isnan().all()
    assert torch.isfinite(da[[0, 2]]).all() and torch.isfinite(db[[0, 2]]).all()


@pytest.mark.parametrize("E,C,K,N,r", [(3, 13, 24, 20, 4), (4, 72, 40, 33, 8)])
def test_lora_grouped_linear_matches_reference_dispatch(jx, E, C, K, N, r):
    """The port's autograd Function against the reference's custom_vjp in
    interpret mode: C 13 pads to one tile of 16, C 72 is one tile of 72
    (two 64-row blocks on the card). Outputs and the x, a, b gradients at
    1e-5."""
    x, w0, a, b, cot = _stack_inputs(33, E, C, K, N, r)
    pol = jx.Policy(backend="pallas", interpret=True)
    want, jgrads = _jvjp(
        jx, lambda *t: jx.ops.lora_grouped_linear(*t, 2.0, policy=pol),
        [x, w0, a, b], [0, 2, 3], cot)
    got, tgrads = _tvjp(lambda *t: tops.lora_grouped_linear(*t, 2.0),
                        [x, w0, a, b], [0, 2, 3], cot)
    assert got.shape == (E, C, N)
    np.testing.assert_allclose(got, want, **TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **TOL)


def test_lora_grouped_linear_saves_no_h_and_refuses_quantized_stacks():
    """The Function saves x, the stack itself (no copy), A and B, never h.
    A quantized stack is no longer refused: it is taken, and its codes and
    scale are saved in place (``test_torch_moe_quant.py`` holds it against
    the reference)."""
    x, w0, a, b, _ = _t(*_stack_inputs(34, 3, 13, 24, 20, 4))
    x.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        tops.lora_grouped_linear(x, w0, a, b, 2.0)
    assert [tuple(t.shape) for t in saved] == [x.shape, w0.shape, a.shape,
                                               b.shape]
    assert saved[1] is w0                        # the stack itself, no copy
    q = {"q": torch.zeros(3, 24, 20, dtype=torch.int8),
         "scale": torch.ones(3, 1, 20)}
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = tops.lora_grouped_linear(x, q, a, b, 2.0)
    assert y.shape == (3, 13, 20)
    assert saved[1] is q["q"] and saved[2] is q["scale"]
    assert [tuple(t.shape) for t in saved] == [x.shape, (3, 24, 20),
                                               (3, 1, 20), a.shape, b.shape]


# ---------------------------------------------------------------- routing


def test_stable_top_k_matches_lax_top_k_on_ties(jx):
    """2048 rows of 64 bf16-rounded logits (as ``x @ router`` rounds in
    the model dtype), softmaxed in f32: the same expert set and order in
    every row as ``jax.lax.top_k``, which takes the lower index on a tie."""
    rng = np.random.default_rng(35)
    logits = torch.from_numpy(_rand(rng, 2048, 64, scale=2.0)).bfloat16()
    probs = torch.softmax(logits.float(), -1)
    jv, ji = jx.jax.lax.top_k(jx.jnp.asarray(probs.numpy()), 8)
    tv, ti = tmoe.top_k(probs, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the case has ties inside the top 8 of many rows
    assert int((tv[:, 1:] == tv[:, :-1]).any(-1).sum()) > 100


def _moe_case(jx, arch):
    jcfg = jx.config(arch).reduced()
    tcfg = get_config(arch).reduced()
    p = jx.jax.tree_util.tree_map(
        np.asarray, jx.moe.moe_params(jx.jax.random.PRNGKey(1), jcfg))
    p = _redraw_b(p, np.random.default_rng(36))
    x = _rand(np.random.default_rng(37), BATCH, SEQ, jcfg.d_model)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(jx, arch, backend):
    """Output and the input gradient (through the routing weights and every
    expert) of one MoE MLP, deepseek's with its shared expert."""
    jcfg, tcfg, p, x = _moe_case(jx, arch)
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, p)
    tp = bridge.from_numpy_tree(p)
    pol = jx.Policy(backend=JAX_BACKEND[backend],
                    interpret=True if backend == "cuda" else None)
    cot = _rand(np.random.default_rng(38), *x.shape)
    want, (jdx,) = _jvjp(jx, lambda x: jx.moe.moe_mlp(jp, x, jcfg,
                                                      policy=pol),
                         [x], [0], cot)
    got, (tdx,) = _tvjp(lambda x: tmoe.moe_mlp(
        tp, x, tcfg, policy=ExecutionPolicy(backend=backend)), [x], [0], cot)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(tdx, jdx, **TOL)


def test_aux_load_balance_loss_matches_reference(jx):
    jcfg, tcfg, p, x = _moe_case(jx, "olmoe-1b-7b")
    want = jx.moe.aux_load_balance_loss(
        jx.jax.tree_util.tree_map(jx.jnp.asarray, p), jx.jnp.asarray(x), jcfg)
    got = tmoe.aux_load_balance_loss(bridge.from_numpy_tree(p),
                                     torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_capacity_and_configs_match_reference(jx):
    for arch in ARCHS:
        j, t = jx.config(arch), get_config(arch)
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert (t.n_params(), t.n_active_params()) == (j.n_params(),
                                                       j.n_active_params())
        assert dataclasses.asdict(t.reduced().moe) == dataclasses.asdict(
            j.reduced().moe)
        for n in (1, 48, 256, 4096):
            assert tmoe._capacity(n, t.moe) == jx.moe._capacity(n, j.moe)
    # OLMoE at the paper's seq 256: 40 slots an expert, one tile of 40
    assert tmoe._capacity(256, get_config("olmoe-1b-7b").moe) == 40
    assert tops.grouped_bm(40) == 40 and tops.grouped_bm(72) == 72
    assert tops.grouped_bm(13) == 16 and tops.grouped_bm(300) == 128


# ------------------------------------------------------------------ model


def test_full_width_init_scales_match_reference(jx):
    """At OLMoE's full widths (d 2048, d_expert 1024, rank 8; 1 layer, 4
    experts and a 2,048-token vocab to keep it small), every leaf of the
    port's ``init_params`` has the reference's shape and scale: the router
    at d^-0.5, each expert's W0 at d_in^-0.5 and A at r^-0.5, B zero, the
    untied head at d^-0.5, the norms one."""
    def cut(c):
        return dataclasses.replace(c, n_layers=1, vocab=2048, dtype="float32",
                                   moe=dataclasses.replace(c.moe, n_experts=4))
    tcfg, jcfg = cut(get_config("olmoe-1b-7b")), cut(jx.config("olmoe-1b-7b"))
    got = _leaves(TM.init_params(tcfg,
                                 generator=torch.Generator().manual_seed(0)))
    want = _leaves(jx.M.init_params(jx.jax.random.PRNGKey(0), jcfg))
    assert got.keys() == want.keys()
    d, f, r = tcfg.d_model, tcfg.moe.d_expert, tcfg.lora.rank
    formula = {"/blocks/moe/router": d ** -0.5, "/embed/head": d ** -0.5,
               "/blocks/moe/gate/w": d ** -0.5, "/blocks/moe/up/w": d ** -0.5,
               "/blocks/moe/down/w": f ** -0.5, "/blocks/moe/gate/a": r ** -0.5,
               "/blocks/moe/down/a": r ** -0.5}
    assert formula.keys() <= want.keys()
    for path, w in want.items():
        t, w = got[path].numpy(), np.asarray(w)
        assert t.shape == w.shape, path
        if not w.std():      # B zero, norms one
            np.testing.assert_array_equal(t, w, err_msg=path)
            continue
        # 4 experts' router is 8,192 draws: its std is known within ~1 %
        np.testing.assert_allclose(t.std(), w.std(), rtol=0.05, err_msg=path)
        if path in formula:
            np.testing.assert_allclose(t.std(), formula[path], rtol=0.05,
                                       err_msg=path)
    assert got["/blocks/moe/gate/w"].shape == (1, 4, d, f)



def _redraw_b(tree, rng):
    """Every LoRA B redrawn at 0.02, as B is after fine-tuning from zero
    (``test_torch_train.py``: the reference's own backends agree per leaf
    at 1e-5 there)."""
    return {k: (_redraw_b(v, rng) if isinstance(v, dict) else
                _rand(rng, *v.shape, scale=0.02) if k == "b" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def np_models(jx):
    """{arch: numpy params} from the reference's ``init_params``."""
    return {arch: _redraw_b(jx.jax.tree_util.tree_map(
        np.asarray, jx.M.init_params(jx.jax.random.PRNGKey(0),
                                     jx.config(arch).reduced())),
        np.random.default_rng(1)) for arch in ARCHS}


@pytest.fixture(scope="module")
def np_batch():
    return next(tpipe.make_batch_iterator(256, SEQ, BATCH, seed=3,
                                          n_tokens=4096))


def _tbatch(np_batch):
    return {k: torch.from_numpy(v).long() for k, v in np_batch.items()}


def test_bridge_carries_moe_trees_unchanged(np_models):
    """router, expert stacks [L, E, ·, ·], the untied head, block0 and the
    shared experts: same keys, shapes and values, in f32 and bf16."""
    for arch, npp in np_models.items():
        for dtype in (None, torch.bfloat16):
            got = _leaves(bridge.from_numpy_tree(npp, dtype=dtype))
            want = _leaves(npp)
            assert got.keys() == want.keys()
            for path, w in want.items():
                t = got[path]
                assert tuple(t.shape) == w.shape, path
                assert t.dtype == (dtype or torch.float32)
                np.testing.assert_array_equal(
                    t.float().numpy(), torch.from_numpy(w).to(
                        dtype or torch.float32).float().numpy())
        keys = _leaves(npp).keys()
        assert "/embed/head" in keys and "/blocks/moe/router" in keys
        assert ("/block0/mlp/down/w" in keys) == (arch == "deepseek-moe-16b")


@pytest.fixture(scope="module")
def jax_runs(jx, np_models, np_batch):
    """{(arch, backend): (loss, {path: grad or None})} from the reference's
    ``mesp.value_and_grad``."""
    jb = {k: jx.jnp.asarray(v) for k, v in np_batch.items()}
    out = {}
    for arch, npp in np_models.items():
        jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, npp)
        for backend, jbackend in JAX_BACKEND.items():
            loss, grads = jx.mesp.value_and_grad(
                jp, jx.config(arch).reduced(), jb, policy=jx.Policy(
                    backend=jbackend,
                    interpret=True if backend == "cuda" else None))
            out[(arch, backend)] = (float(loss), {
                k: None if v is None else np.asarray(v)
                for k, v in _leaves(grads).items()})
    return out


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_value_and_grad_matches_reference(np_models, np_batch, jax_runs,
                                              arch, backend):
    """Loss at rtol 1e-5 and every LoRA leaf at relative L2 1e-5 (cuda
    against pallas in interpret mode); no kernel launches on the CPU."""
    cfg = get_config(arch).reduced()
    tops.reset_launch_counts()
    loss, grads = mesp.value_and_grad(
        bridge.from_numpy_tree(np_models[arch]), cfg, _tbatch(np_batch),
        policy=ExecutionPolicy(backend=backend))
    assert set(tops.launch_counts().values()) == {0}
    jloss, jgrads = jax_runs[(arch, backend)]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    tg = _leaves(grads)
    assert tg.keys() == jgrads.keys()
    n_lora = 0
    for path, jg in jgrads.items():
        if jg is None:
            assert tg[path] is None, path
            continue
        n_lora += 1
        assert np.abs(jg).max() > 0, path
        err = _rel(tg[path].numpy(), jg)
        assert err <= 1e-5, (path, err)
    # olmoe: 4 attention + 3 expert linears; deepseek adds block0's 7 and
    # the 3 shared experts'
    assert n_lora == {"olmoe-1b-7b": 14, "deepseek-moe-16b": 34}[arch]


def test_moe_value_and_grad_repeats_bitwise():
    """Two calls route, recompute (remat) and reduce the same way: the same
    loss and gradients to the bit."""
    cfg = get_config("olmoe-1b-7b").reduced()
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(2))
    batch = _tbatch(next(tpipe.make_batch_iterator(cfg.vocab, SEQ, BATCH,
                                                   seed=4, n_tokens=4096)))
    pol = ExecutionPolicy(backend="cuda")
    l1, g1 = mesp.value_and_grad(params, cfg, batch, policy=pol)
    l2, g2 = mesp.value_and_grad(params, cfg, batch, policy=pol)
    assert torch.equal(l1, l2)
    for path, g in _leaves(g1).items():
        other = _leaves(g2)[path]
        assert (g is None and other is None) or torch.equal(g, other), path


def test_moe_refuses_quantize_and_decode():
    """MoE decode takes no adapter routing (the reference's refusal: the
    expert stacks already take the group axis); its cache and a plain
    decode step work. A quantized MoE base is taken:
    ``init_params(quantize="nf4")`` gives packed expert leaves, and the CLI
    trains one step with ``--quantize int8``."""
    cfg = get_config("olmoe-1b-7b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(cfg, generator=gen, quantize="nf4")
    L, E, d, f = cfg.n_layers, cfg.moe.n_experts, cfg.d_model, \
        cfg.moe.d_expert
    moe = p["blocks"]["moe"]
    gate, down = moe["gate"]["w"], moe["down"]["w"]
    assert gate["q4"].shape == (L, E, d // 2, f) and gate["q4"].dtype == \
        torch.uint8
    assert down["q4"].shape == (L, E, f // 2, d)
    assert gate["scale"].shape == (L, E, 1, f) and gate["code"].shape == (
        L, E, 16)
    assert moe["router"].dtype == torch.float32
    cache = TM.init_cache(cfg, 2, 16)
    assert cache["blocks"]["len"].shape == (L, 2)
    toks = torch.ones((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="adapter routing unsupported"):
        TM.decode_step(p, cfg, cache, toks,
                       adapter_tiles=torch.zeros(1, dtype=torch.int32))
    logits, _ = TM.decode_step(p, cfg, cache, toks,
                               policy=ExecutionPolicy(quantize="nf4"))
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    out = ttrain.train(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                        "cpu", "--steps", "1", "--seq", "16", "--quantize",
                        "int8"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert out["params"]["blocks"]["moe"]["up"]["w"]["q"].dtype == torch.int8


# ---------------------------------------- no stack copy, saved tensors


class _FloatOutputs(TorchDispatchMode):
    """Shapes of the floating tensors every op outputs, except while
    ``paused`` and except views of the ``params`` (the per-layer views of
    the stacked weights are no copy)."""

    def __init__(self, params):
        super().__init__()
        self.paused, self.shapes = 0, []
        self.stores = {t.untyped_storage().data_ptr()
                       for t in _leaves(params).values()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.untyped_storage().data_ptr() not in self.stores:
                    self.shapes.append(tuple(t.shape))
        return out


_GROUPED = ("lora_grouped_gemm", "lora_grouped_dx", "lora_grouped_dab")
#: batch 2 x seq 64: 40 slots an expert, so the [E, B·C, ·] buffers (80
#: rows) have the shape of no weight stack and no A stack
SHAPE_SEQ = 64


@pytest.mark.parametrize("pause", [True, False])
def test_cuda_path_makes_no_copy_of_an_expert_stack(monkeypatch, pause):
    """Under ``cuda`` no op outside the grouped wrappers outputs a tensor of
    an expert stack's shape ([E, d, f], [E, f, d], a transpose or a
    per-tile gather): W0 is read in place. With recording inside the
    wrappers too, their plain versions' per-tile gathers are seen, which
    shows that the check can see one."""
    cfg = get_config("olmoe-1b-7b").reduced()
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(3))
    batch = _tbatch(next(tpipe.make_batch_iterator(
        cfg.vocab, SHAPE_SEQ, BATCH, seed=5, n_tokens=4096)))
    mode = _FloatOutputs(params)
    if pause:
        for name in _GROUPED:
            fn = getattr(tlg, name)

            def wrapped(*args, _fn=fn, **kw):
                mode.paused += 1
                try:
                    return _fn(*args, **kw)
                finally:
                    mode.paused -= 1
            monkeypatch.setattr(tlg, name, wrapped)
    with mode:
        mesp.value_and_grad(params, cfg, batch,
                            policy=ExecutionPolicy(backend="cuda"))
    stacks = [s for s in mode.shapes if s in ((E, d, f), (E, f, d))]
    assert not stacks if pause else stacks


@pytest.mark.parametrize("backend,saves_h", [
    ("cuda", False), ("structured", False), ("store_h", True),
    ("plain", True)])
def test_moe_saved_tensors_follow_the_residual_contract(backend, saves_h):
    """remat off: MeSP saves no expert h [E, B·C, r]; store_h and MeBP
    (autograd) do."""
    cfg = get_config("olmoe-1b-7b").reduced()
    E, r = cfg.moe.n_experts, cfg.lora.rank
    C = tmoe._capacity(SHAPE_SEQ, cfg.moe)
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(3))
    batch = _tbatch(next(tpipe.make_batch_iterator(
        cfg.vocab, SHAPE_SEQ, BATCH, seed=5, n_tokens=4096)))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        mesp.value_and_grad(params, cfg, batch, policy=ExecutionPolicy(
            backend=backend, remat=False))
    assert ((E, BATCH * C, r) in shapes) == saves_h, backend


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_losses():
    run = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
           "--steps", "3", "--seq", str(SEQ)]
    return {e: ttrain.train(run + ["--engine", e])["losses"]
            for e in ("mesp_cuda", "mesp", "mebp", "store_h")}


@pytest.mark.parametrize("engine", ["mesp", "mebp", "store_h"])
def test_moe_train_cli_engines_give_one_loss_curve(cli_losses, engine):
    assert len(cli_losses[engine]) == 3
    assert all(np.isfinite(cli_losses[engine]))
    np.testing.assert_allclose(cli_losses[engine], cli_losses["mesp_cuda"],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


def _close_scaled(got, want, tol):
    """assert_close with the absolute floor taken relative to the output's
    largest magnitude (at least 1): dA and dB are sums over a group's
    rows."""
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# (M, K, N, E, r, bm, gid): the path's tiling (bm 40, every expert one
# tile), C 13 padded to 16, a tile of 72 over two 64-row blocks, odd K and
# N, ranks 3 and 16, ragged groups with an empty one; then the bf16
# forward's row-fragment boundaries (bm 16: one m16 fragment; 40 and 48:
# three; 64: four; 65: a 64-row part and a 1-row one), r 32 at bm 40
# (h over two groups of A columns), and DeepSeekMoE's expert widths (d_expert
# 1408: half a 256-column tile at the edge)
CARD_CASES = RAGGED_CASES + [
    (320, 2048, 1024, 8, 8, 40, list(range(8))),
    (160, 1024, 2048, 8, 8, 40, [7, 6, 5, 4]),
    (48, 300, 130, 3, 3, 16, [0, 1, 2]),
    (144, 97, 131, 2, 16, 72, [1, 0]),
    (64, 2048, 1024, 4, 8, 16, [0, 1, 2, 3]),
    (96, 512, 384, 2, 8, 48, [0, 1]),
    (128, 512, 384, 2, 8, 64, [1, 0]),
    (130, 512, 384, 2, 8, 65, [0, 1]),
    (120, 1024, 2048, 3, 32, 40, [0, 1, 2]),
    (80, 2048, 1408, 2, 8, 40, [0, 1]),
    (80, 1408, 2048, 2, 8, 40, [1, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,E,r,bm,gid", CARD_CASES)
def test_grouped_train_kernels_match_plain_on_card(M, K, N, E, r, bm, gid,
                                                   dtype):
    """f32: summation order only. bf16: one output rounding, doubled where
    a rounding of h or dh flips, with an absolute floor for outputs near
    zero."""
    _need_card()
    dt = getattr(torch, dtype)
    x, w0, a, b, g = [t.to(dt).cuda() for t in _t(*_gid_inputs(
        40, M, K, N, E, r))]
    gid = torch.tensor(gid, dtype=torch.int32, device="cuda")
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    before = [getattr(tlg, n).launches for n in _GROUPED]
    y = tlg.lora_grouped_gemm(x, w0, a, b, gid, 2.0, bm=bm)
    dx = tlg.lora_grouped_dx(g, w0, a, b, gid, 2.0, bm=bm)
    da, db = tlg.lora_grouped_dab(x, g, a, b, gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert [getattr(tlg, n).launches for n in _GROUPED] == [
        c + 1 for c in before]
    assert y.dtype == dx.dtype == da.dtype == db.dtype == dt
    wda, wdb = tlg.lora_grouped_dab_ref(x, g, a, b, gid, 2.0, bm=bm)
    for got, want in (
            (y, tlg.lora_grouped_gemm_ref(x, w0, a, b, gid, 2.0, bm=bm)),
            (dx, tlg.lora_grouped_dx_ref(g, w0, a, b, gid, 2.0, bm=bm)),
            (da, wda), (db, wdb)):
        _close_scaled(got, want, tol)
    # deterministic: the partials are added in a fixed order
    da2, db2 = tlg.lora_grouped_dab(x, g, a, b, gid, 2.0, bm=bm)
    assert torch.equal(da, da2) and torch.equal(db, db2)


# the bf16 dA/dB's card cases (M, K, N, E, r, bm, gid): the path's gate/up
# and down (E 64, C = bm 40: one cluster a group); runs of three and two
# 128-row tiles (a cluster walks several chunks, the two slabs in turn);
# bm 8, 16, 63, 64 and 65 (chunks of one to four m16 fragments, a tile over
# two chunks); r 1, 16 and 32 (32 at 2048 x 1024: more members, no second
# pass); odd, unaligned K and N (x, g and B element by element); an empty
# group
DAB_CARD_CASES = [
    (2560, 2048, 1024, 64, 8, 40, list(range(64))),
    (2560, 1024, 2048, 64, 8, 40, list(range(64))),
    (640, 512, 384, 2, 8, 128, [0, 0, 0, 1, 1]),
    (24, 300, 130, 3, 1, 8, [2, 0, 0]),
    (64, 97, 131, 2, 16, 16, [1, 1, 0, 0]),
    (126, 97, 131, 2, 8, 63, [0, 1]),
    (128, 896, 896, 2, 32, 64, [1, 0]),
    (195, 640, 512, 4, 8, 65, [0, 3, 1]),
    (120, 2048, 1024, 3, 32, 40, [2, 1, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [2.0, 1.5])
@pytest.mark.parametrize("M,K,N,E,r,bm,gid", DAB_CARD_CASES)
def test_grouped_dab_bf16_matches_plain_on_card(M, K, N, E, r, bm, gid,
                                                scale):
    """The bf16 dA/dB on tensor cores (one launch, a cluster a group, no
    workspace) against its plain version at the bf16 card tolerance; at s
    1.5 round(s g) really rounds. Two launches give the same bits."""
    _need_card()
    x, _, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(*_gid_inputs(
        46, M, K, N, E, r))]
    gid = torch.tensor(gid, dtype=torch.int32, device="cuda")
    before = tlg.lora_grouped_dab.launches
    da, db = tlg.lora_grouped_dab(x, g, a, b, gid, scale, bm=bm)
    torch.cuda.synchronize()
    assert tlg.lora_grouped_dab.launches == before + 1
    wda, wdb = tlg.lora_grouped_dab_ref(x, g, a, b, gid, scale, bm=bm)
    for got, want in ((da, wda), (db, wdb)):
        _close_scaled(got, want, dict(rtol=2.0 ** -6, atol=1e-2))
    da2, db2 = tlg.lora_grouped_dab(x, g, a, b, gid, scale, bm=bm)
    assert torch.equal(da, da2) and torch.equal(db, db2)
    plan = tlg.dab_plan(M, K, N, E, r, bm=bm)
    assert 1 <= plan["members"] <= 8 and plan["sub_runs"] == 1
    assert plan["workspace"] == 0 and plan["counts"] == 0
    assert 0 < plan["smem_bytes"] <= 232448


# (M, K, N, E, r, bm): the path's gate/up tiling and the odd edge, whose x,
# W0 and B rows are loaded element by element
REPEAT_CASES = [(320, 2048, 1024, 8, 8, 40), (120, 97, 131, 3, 8, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,E,r,bm", REPEAT_CASES)
def test_grouped_forward_bf16_is_bitwise_on_repeat(M, K, N, E, r, bm):
    """The bf16 forward on tensor cores sums in a fixed order: two launches
    on the same inputs give the same bits."""
    _need_card()
    x, w0, a, b, _ = [t.to(torch.bfloat16).cuda() for t in _t(*_gid_inputs(
        43, M, K, N, E, r))]
    gid = torch.arange(E, dtype=torch.int32, device="cuda")
    y1 = tlg.lora_grouped_gemm(x, w0, a, b, gid, 2.0, bm=bm)
    y2 = tlg.lora_grouped_gemm(x, w0, a, b, gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y1).all())
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,E,r,bm", REPEAT_CASES)
def test_grouped_dx_bf16_is_bitwise_on_repeat(M, K, N, E, r, bm):
    """The bf16 dx runs its tensor-core body (the f32 dx its CUDA-core
    one) and sums in a fixed order: two launches on the same inputs give
    the same bits."""
    _need_card()
    _, w0, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(*_gid_inputs(
        44, M, K, N, E, r))]
    gid = torch.arange(E, dtype=torch.int32, device="cuda")
    d1 = tlg.lora_grouped_dx(g, w0, a, b, gid, 2.0, bm=bm)
    d2 = tlg.lora_grouped_dx(g, w0, a, b, gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d1).all())
    assert torch.equal(d1, d2)
    plan = tlg.dx_plan(torch.bfloat16, bm=bm)
    assert plan["tensor_cores"] and plan["row_fragments"] == 3
    assert plan["smem_bytes"] > 0
    tlg.lora_grouped_dx(g.float(), w0.float(), a.float(), b.float(), gid,
                        2.0, bm=bm)
    torch.cuda.synchronize()
    assert tlg.dx_plan(torch.float32, bm=bm) == {
        "tensor_cores": False, "row_fragments": 0, "smem_bytes": 0}


@pytest.mark.cuda
def test_grouped_dx_bf16_marks_bad_gid_as_plain():
    """A gid outside [0, E) gives NaN rows on the plain version's entries
    in the bf16 dx too, at one and at two 64-row parts a tile."""
    _need_card()
    for M, bm in ((32, 8), (260, 65)):
        _, w0, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
            *_gid_inputs(45, M, 24, 16, 3, 4))]
        gid = torch.tensor([0, 7, 1, -1][:M // bm], dtype=torch.int32,
                           device="cuda")
        got = tlg.lora_grouped_dx(g, w0, a, b, gid, 2.0, bm=bm)
        want = tlg.lora_grouped_dx_ref(g, w0, a, b, gid, 2.0, bm=bm)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        _close_scaled(got.nan_to_num(), want.nan_to_num(),
                      dict(rtol=2.0 ** -6, atol=1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_train_kernels_mark_bad_gid_and_reject_bad_input(dtype):
    """A gid outside [0, E) gives NaN rows (forward, dx) and adds its tile
    to no group (dA/dB); a group whose tiles are not one run gets NaN in
    its dA and dB, an empty group zeros: on exactly the plain version's
    entries, in f32 (rtol = atol = 1e-4) and bf16 (the card tolerance of
    the bf16 kernels, its floor relative to the largest output). The bad
    input is rejected in f32."""
    _need_card()
    dt = getattr(torch, dtype)
    x, w0, a, b, g = [t.to(dt).cuda() for t in _t(*_gid_inputs(
        41, 32, 24, 16, 3, 4))]
    for gid in ([0, 7, 1, -1], [1, 0, 1, 2]):
        gid = torch.tensor(gid, dtype=torch.int32, device="cuda")
        outs = (tlg.lora_grouped_gemm(x, w0, a, b, gid, 2.0, bm=8),
                tlg.lora_grouped_dx(g, w0, a, b, gid, 2.0, bm=8),
                *tlg.lora_grouped_dab(x, g, a, b, gid, 2.0, bm=8))
        torch.cuda.synchronize()
        wants = (tlg.lora_grouped_gemm_ref(x, w0, a, b, gid, 2.0, bm=8),
                 tlg.lora_grouped_dx_ref(g, w0, a, b, gid, 2.0, bm=8),
                 *tlg.lora_grouped_dab_ref(x, g, a, b, gid, 2.0, bm=8))
        for got, want in zip(outs, wants):
            assert torch.equal(got.isnan(), want.isnan())
            if dtype == "float32":
                torch.testing.assert_close(got.nan_to_num(),
                                           want.nan_to_num(), rtol=1e-4,
                                           atol=1e-4)
            else:
                _close_scaled(got.nan_to_num(), want.nan_to_num(),
                              dict(rtol=2.0 ** -6, atol=1e-2))
        if gid.tolist() == [0, 7, 1, -1]:   # group 2 has no tile
            assert not outs[2][2].any() and not outs[3][2].any()
    if dtype == "bfloat16":
        return
    gid = torch.arange(4, dtype=torch.int32, device="cuda") % 3
    with pytest.raises(TypeError, match="int32"):
        tlg.lora_grouped_gemm(x, w0, a, b, gid.long(), 2.0, bm=8)
    with pytest.raises(ValueError, match="rank"):
        tlg.lora_grouped_dx(g, w0, torch.zeros(3, 24, 33, device="cuda"),
                            torch.zeros(3, 33, 16, device="cuda"), gid, 2.0,
                            bm=8)
    with pytest.raises(ValueError, match="tiles"):
        tlg.lora_grouped_dab(x, g, a, b, gid, 2.0, bm=7)
    with pytest.raises(ValueError, match="contiguous"):
        tlg.lora_grouped_gemm(x, w0.mT.contiguous().mT, a, b, gid, 2.0, bm=8)
    with pytest.raises(ValueError, match=r"w0 \[E,K,N\]"):
        tlg.lora_grouped_gemm(x, w0[0], a, b, gid, 2.0, bm=8)
