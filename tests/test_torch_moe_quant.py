"""The port's MoE training over a quantized frozen base (int8, packed int4 /
nf4 expert stacks) against the JAX reference (f32, CPU), and the standalone
RoPE kernel's plain version against the reference's ``rope_apply``.

1. Format: ``core/quant`` and the bridge over [L, E, K, N] expert stacks
   give the reference's bytes; ``init_params(quantize=m)`` equals
   ``quantize_params(init_params(), m)`` bit for bit, dense and MoE.
2. Kernels: the plain versions of the four quantized grouped training
   wrappers (``lora_grouped_gemm_q``/``_q4``, ``lora_grouped_dx_q``/``_q4``)
   against the reference's ``lora_grouped_q``/``_q4``/``_dx_q``/``_dx_q4``
   with a per-expert base (Ew = E) in interpret mode, on ragged gids with an
   odd K; ``kops.lora_grouped_linear`` over a quantized leaf against the
   reference's dispatch, forward and VJP; what it saves (x, the codes, the
   scale, A and B, never h).
3. Model: loss and every LoRA leaf of reduced ``olmoe-1b-7b`` and
   ``deepseek-moe-16b`` over int8 and nf4 bases (int4 too for one) against
   ``repro.core.mesp.value_and_grad``: ``cuda`` against ``pallas`` in
   interpret mode, ``structured``, ``plain`` and ``store_h`` against their
   namesakes, at relative L2 1e-5 per leaf.
4. No float copy of an expert stack on the ``cuda`` path over codes (a
   ``TorchDispatchMode``, recording paused inside the grouped wrappers,
   whose plain versions widen each tile's codes by nature).
5. The CLI: one f32 loss curve under every engine with ``--quantize nf4``.
6. RoPE: ``kernels.rope.rope_apply`` (forward and gradient) against the
   reference's ``rope_apply`` in interpret mode, bit for bit in f32.

The tests marked ``cuda`` hold the four CUDA kernels and the RoPE kernel
against their plain versions on a card and skip without one. JAX is
imported only inside the parity fixtures, so the card tests run where JAX
is not installed.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.core import mesp
from repro_torch.core import quant as tq
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import lora_grouped as tlg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rope as trope
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
METHODS = ("int8", "int4", "nf4")
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
    from repro.core import quant as jquant
    from repro.kernels import lora_grouped, ops, rope
    from repro.models import model as JM
    return SimpleNamespace(jax=jax, jnp=jnp, Policy=JaxPolicy,
                           config=jax_config, mesp=jmesp, quant=jquant,
                           lg=lora_grouped, ops=ops, rope=rope, M=JM)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_same_bytes(got, want):
    """Two numpy trees with the same keys, dtypes, shapes and bytes."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert g[path].shape == w[path].shape, path
        assert g[path].tobytes() == w[path].tobytes(), path


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _key(method):
    return "q" if method == "int8" else "q4"


# ------------------------------------------------------------------ format


@pytest.fixture(scope="module")
def np_dense(jx):
    """{arch: the reference's dense init_params(PRNGKey(0)) as numpy}."""
    return {arch: _np(jx.M.init_params(jx.jax.random.PRNGKey(0),
                                       jx.config(arch).reduced()))
            for arch in ARCHS}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_gives_the_reference_bytes_on_expert_stacks(
        jx, np_dense, arch, method):
    """The port's ``quantize_params`` of the bridged dense tree against the
    reference's ``init_params(quantize=)``: the same bytes in every leaf
    (expert stacks [L, E, K, N] -> codes [L, E, ·, N], scale [L, E, 1, N],
    code [L, E, 16], kpad where K is odd); the router, embedding and head
    stay dense. ``maybe_dequant``, ``packed_k``, ``tree_method`` and
    ``tree_bytes`` agree with the reference on them."""
    want = _np(jx.M.init_params(jx.jax.random.PRNGKey(0),
                                jx.config(arch).reduced(), quantize=method))
    tree = tq.quantize_params(bridge.from_numpy_tree(np_dense[arch]), method)
    _assert_same_bytes(bridge.to_numpy_tree(tree), want)
    L, E = want["blocks"]["moe"]["router"].shape[0], \
        want["blocks"]["moe"]["router"].shape[-1]
    for name in ("gate", "up", "down"):
        leaf, jleaf = tree["blocks"]["moe"][name]["w"], \
            want["blocks"]["moe"][name]["w"]
        assert leaf["scale"].shape[:2] == (L, E)
        if method != "int8":
            assert tq.packed_k(leaf) == jx.quant.packed_k(jleaf)
        np.testing.assert_array_equal(
            tq.maybe_dequant(leaf, torch.float32).numpy(),
            np.asarray(jx.quant.maybe_dequant(
                jx.jax.tree_util.tree_map(jx.jnp.asarray, jleaf),
                jx.jnp.float32)))
    assert tree["blocks"]["moe"]["router"].dtype == torch.float32
    assert tq.tree_method(tree) == method
    assert tq.tree_bytes(tree) == sum(a.nbytes for a in _leaves(want).values())
    assert tq.tree_bytes(tree, frozen_base=True) == sum(
        a.nbytes for p, a in _leaves(want).items()
        if "/w/" in p or p.endswith("/w"))


@pytest.mark.parametrize("method", METHODS)
def test_bridge_carries_quantized_expert_stacks(jx, method):
    """The reference's quantized MoE tree (deepseek: block0, shared experts,
    expert stacks) through ``bridge`` and back, in f32 and under a bf16
    cast: codes keep int8 / uint8, scale and code stay f32, the bytes are
    the reference's; the LoRA factors take the cast."""
    want = _np(jx.M.init_params(jx.jax.random.PRNGKey(1),
                                jx.config("deepseek-moe-16b").reduced(),
                                quantize=method))
    _assert_same_bytes(bridge.to_numpy_tree(bridge.from_numpy_tree(want)),
                       want)
    got = bridge.from_numpy_tree(want, dtype=torch.bfloat16)
    w = got["blocks"]["moe"]["gate"]["w"]
    assert w[_key(method)].dtype == (torch.int8 if method == "int8"
                                     else torch.uint8)
    assert w["scale"].dtype == torch.float32
    if method == "nf4":
        assert w["code"].dtype == torch.float32
        assert w["code"].shape == (*w["scale"].shape[:2], 16)
    assert got["blocks"]["moe"]["gate"]["a"].dtype == torch.bfloat16
    for path, leaf in _leaves(bridge.to_numpy_tree(got)).items():
        if "/w/" in path:
            np.testing.assert_array_equal(leaf, _leaves(want)[path])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ("qwen2.5-0.5b",) + ARCHS)
def test_init_params_quantize_equals_quantize_params(arch, method):
    """On the CPU the draws are the same with and without ``quantize`` (the
    quantized expert stacks one matrix at a time, the dense ones whole), so
    quantizing as drawing gives ``quantize_params`` of the dense tree, bit
    for bit."""
    cfg = get_config(arch).reduced()
    made = TM.init_params(cfg, generator=torch.Generator().manual_seed(5),
                          quantize=method)
    want = tq.quantize_params(TM.init_params(
        cfg, generator=torch.Generator().manual_seed(5)), method)
    g, w = _leaves(made), _leaves(want)
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert torch.equal(g[path], w[path]), path
    assert tq.tree_method(made) == method


# ------------------------------------------------- grouped kernels, plain


def _codes_inputs(seed, M, K, N, E, r, method):
    """x [M,K], the codes and scale of W0 [E,K,N] in ``method``'s format
    (the port's ``quantize_leaf``: the reference's bytes), a [E,K,r],
    b [E,r,N] (nonzero), g [M,N]; numpy."""
    rng = np.random.default_rng(seed)
    x, w = _rand(rng, M, K, scale=0.5), _rand(rng, E, K, N, scale=K ** -0.5)
    leaf = tq.quantize_leaf(torch.from_numpy(w), method)
    return (x, leaf[_key(method)].numpy(), leaf["scale"].numpy(),
            _rand(rng, E, K, r, scale=0.4), _rand(rng, E, r, N, scale=0.3),
            _rand(rng, M, N, scale=0.5))


def _port_calls(method):
    """(forward, dx) of the port's quantized grouped wrappers."""
    if method == "int8":
        return tlg.lora_grouped_gemm_q, tlg.lora_grouped_dx_q
    return (functools.partial(tlg.lora_grouped_gemm_q4, method=method),
            functools.partial(tlg.lora_grouped_dx_q4, method=method))


# (M, K, N, E, r, bm, gid): ragged groups (tile counts 2, 0, 3, 1), group 1
# empty; one expert owning every tile with odd K and N, rank 3; odd K 129
# over two groups, rank 16
RAGGED_CASES = [
    (48, 40, 24, 4, 4, 8, [0, 0, 2, 2, 2, 3]),
    (24, 33, 17, 3, 3, 8, [2, 2, 2]),
    (32, 129, 72, 2, 16, 16, [0, 1]),
]


@pytest.mark.parametrize("M,K,N,E,r,bm,gid", RAGGED_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_quantized_grouped_plain_versions_match_pallas_kernels(
        jx, method, M, K, N, E, r, bm, gid):
    """#9′ / #10′ (Ew = E) and #11q's plain versions against the Pallas
    kernels in interpret mode, at 1e-5 in f32."""
    jnp = jx.jnp
    x, q, s, a, b, g = _codes_inputs(50, M, K, N, E, r, method)
    jin = [jnp.asarray(t) for t in (x, q, s, a, b, g)]
    jg = jnp.asarray(gid, jnp.int32)
    tin = [torch.from_numpy(t) for t in (x, q, s, a, b, g)]
    tgid = torch.tensor(gid, dtype=torch.int32)
    kw = {} if method == "int8" else {"method": method}
    jfwd, jdx = ((jx.lg.lora_grouped_q, jx.lg.lora_grouped_dx_q)
                 if method == "int8" else
                 (jx.lg.lora_grouped_q4, jx.lg.lora_grouped_dx_q4))
    fwd, dx = _port_calls(method)
    want = jfwd(jin[0], *jin[1:5], jg, 2.0, bm=bm, interpret=True, **kw)
    got = fwd(tin[0], *tin[1:5], tgid, 2.0, bm=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jdx(jin[5], *jin[1:5], jg, 2.0, bm=bm, interpret=True, **kw)
    got = dx(tin[5], *tin[1:5], tgid, 2.0, bm=bm)
    assert got.shape == (M, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_quantized_grouped_plain_versions_mark_bad_gid(method):
    """A gid outside [0, E) gives NaN rows in the forward and dx, the other
    rows finite, as the kernels do."""
    x, q, s, a, b, g = (torch.from_numpy(t) for t in _codes_inputs(
        51, 32, 25, 16, 3, 4, method))
    gid = torch.tensor([0, 7, 1, -1], dtype=torch.int32)
    fwd, dx = _port_calls(method)
    for out in (fwd(x, q, s, a, b, gid, 2.0, bm=8),
                dx(g, q, s, a, b, gid, 2.0, bm=8)):
        bad = out.reshape(4, 8, -1).isnan().all(-1).all(-1)
        assert bad.tolist() == [False, True, False, True]
        assert torch.isfinite(out.reshape(4, 8, -1)[[0, 2]]).all()


def _stack_leaf_inputs(seed, E, C, K, N, r):
    """x [E,C,K], w0 [E,K,N], a [E,K,r], b [E,r,N] (nonzero), cot [E,C,N]."""
    rng = np.random.default_rng(seed)
    return (_rand(rng, E, C, K, scale=0.5),
            _rand(rng, E, K, N, scale=K ** -0.5),
            _rand(rng, E, K, r, scale=0.4), _rand(rng, E, r, N, scale=0.3),
            _rand(rng, E, C, N, scale=0.5))


@pytest.mark.parametrize("E,C,K,N,r", [(3, 13, 25, 20, 4), (4, 72, 40, 33, 8)])
@pytest.mark.parametrize("method", METHODS)
def test_lora_grouped_linear_over_codes_matches_reference_dispatch(
        jx, method, E, C, K, N, r):
    """``kops.lora_grouped_linear`` over a quantized expert leaf against the
    reference's ``_grouped_dispatch`` in interpret mode: output and the x,
    a, b gradients at 1e-5 (C 13 pads to a tile of 16, K 25 is odd)."""
    x, w0, a, b, cot = _stack_leaf_inputs(52, E, C, K, N, r)
    jleaf = jx.quant.quantize_leaf(jx.jnp.asarray(w0), method)
    tleaf = bridge.from_numpy_tree(_np(jleaf))
    pol = jx.Policy(backend="pallas", interpret=True)
    jnp = jx.jnp

    def jf(x, a, b):
        return jx.ops.lora_grouped_linear(x, jleaf, a, b, 2.0, policy=pol)
    want, vjp = jx.jax.vjp(jf, *(jnp.asarray(t) for t in (x, a, b)))
    jgrads = vjp(jnp.asarray(cot))
    tin = [torch.from_numpy(t).requires_grad_(True) for t in (x, a, b)]
    got = tops.lora_grouped_linear(tin[0], tleaf, tin[1], tin[2], 2.0)
    tgrads = torch.autograd.grad(got, tin, torch.from_numpy(cot))
    assert got.shape == (E, C, N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_lora_grouped_linear_saves_codes_not_h(method):
    """Over a quantized stack the Function saves exactly x, the codes, the
    scale, A and B: the codes and scale themselves, no copy, and never h
    [E, C, r]."""
    x, w0, a, b, _ = (torch.from_numpy(t) for t in _stack_leaf_inputs(
        53, 3, 13, 25, 20, 4))
    leaf = tq.quantize_leaf(w0, method)
    x.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        tops.lora_grouped_linear(x, leaf, a, b, 2.0)
    assert [tuple(t.shape) for t in saved] == [
        x.shape, leaf[_key(method)].shape, leaf["scale"].shape, a.shape,
        b.shape]
    assert saved[1] is leaf[_key(method)] and saved[2] is leaf["scale"]
    if method != "int8":       # without kpad the codes claim K = 26
        bad = {k: v for k, v in leaf.items() if k != "kpad"}
        with pytest.raises(ValueError, match="K=26"):
            tops.lora_grouped_linear(x, bad, a, b, 2.0)


# ------------------------------------------------------------------ model


def _redraw_b(tree, rng):
    """Every LoRA B redrawn at 0.02, as in ``test_torch_moe.py``."""
    return {k: (_redraw_b(v, rng) if isinstance(v, dict) else
                _rand(rng, *v.shape, scale=0.02) if k == "b" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def np_qmodels(jx):
    """(arch, method) -> the reference's init_params(quantize=method) as
    numpy, every LoRA B redrawn at 0.02; made on first use."""
    @functools.lru_cache(maxsize=None)
    def make(arch, method):
        return _redraw_b(_np(jx.M.init_params(
            jx.jax.random.PRNGKey(0), jx.config(arch).reduced(),
            quantize=method)), np.random.default_rng(1))
    return make


@pytest.fixture(scope="module")
def np_batch():
    return next(tpipe.make_batch_iterator(256, SEQ, BATCH, seed=3,
                                          n_tokens=4096))


@pytest.fixture(scope="module")
def jax_runs(jx, np_qmodels, np_batch):
    """(arch, method, port backend) -> the reference's (loss, {path: grad
    or None}), jitted as its trainer runs it; made on first use."""
    @functools.lru_cache(maxsize=None)
    def run(arch, method, backend):
        jnp = jx.jnp
        jp = jx.jax.tree_util.tree_map(jnp.asarray, np_qmodels(arch, method))
        jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
        pol = jx.Policy(backend=JAX_BACKEND[backend],
                        interpret=True if backend == "cuda" else None)
        cfg = jx.config(arch).reduced()
        loss, grads = jx.jax.jit(lambda p, b: jx.mesp.value_and_grad(
            p, cfg, b, policy=pol))(jp, jb)
        return float(loss), {k: None if v is None else np.asarray(v)
                             for k, v in _leaves(grads).items()}
    return run


# every arch over int8 and nf4 under every backend; int4 for olmoe's cuda
MODEL_CASES = [(arch, method, backend) for arch in ARCHS
               for method in ("int8", "nf4") for backend in JAX_BACKEND] + [
    ("olmoe-1b-7b", "int4", "cuda")]


@pytest.mark.parametrize("arch,method,backend", MODEL_CASES)
def test_quantized_moe_value_and_grad_matches_reference(
        np_qmodels, np_batch, jax_runs, arch, method, backend):
    """Loss at rtol 1e-5 and every LoRA leaf at relative L2 1e-5; no kernel
    launches on the CPU."""
    cfg = get_config(arch).reduced()
    params = bridge.from_numpy_tree(np_qmodels(arch, method))
    assert tq.tree_method(params) == method
    tops.reset_launch_counts()
    loss, grads = mesp.value_and_grad(
        params, cfg, {k: torch.from_numpy(v).long()
                      for k, v in np_batch.items()},
        policy=ExecutionPolicy(backend=backend, quantize=method))
    assert set(tops.launch_counts().values()) == {0}
    jloss, jgrads = jax_runs(arch, method, backend)
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
    assert n_lora == {"olmoe-1b-7b": 14, "deepseek-moe-16b": 34}[arch]


# ---------------------------------------- no stack copy over the codes


class _FloatOutputs(TorchDispatchMode):
    """Shapes of the floating tensors every op outputs, except while
    ``paused`` and except views of the ``params``."""

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


_GROUPED_Q = ("lora_grouped_gemm_q", "lora_grouped_gemm_q4",
              "lora_grouped_dx_q", "lora_grouped_dx_q4", "lora_grouped_dab")
#: batch 2 x seq 64: 40 slots an expert, so the [E, B·C, ·] buffers (80
#: rows) have the shape of no weight stack and no A stack
SHAPE_SEQ = 64


@pytest.mark.parametrize("pause", [True, False])
@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_cuda_path_makes_no_float_expert_stack_from_codes(monkeypatch,
                                                          method, pause):
    """Under ``cuda`` over an int8 or nf4 base no op outside the quantized
    grouped wrappers outputs a float tensor of an expert stack's shape
    ([E, d, f], [E, f, d]): the codes are read in place, never dequantized.
    With recording inside the wrappers too, their plain versions' per-tile
    widening of the codes is seen, which shows that the check can see
    one."""
    cfg = get_config("olmoe-1b-7b").reduced()
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            quantize=method)
    batch = {k: torch.from_numpy(v).long() for k, v in next(
        tpipe.make_batch_iterator(cfg.vocab, SHAPE_SEQ, BATCH, seed=5,
                                  n_tokens=4096)).items()}
    mode = _FloatOutputs(params)
    if pause:
        for name in _GROUPED_Q:
            fn = getattr(tlg, name)

            def wrapped(*args, _fn=fn, **kw):
                mode.paused += 1
                try:
                    return _fn(*args, **kw)
                finally:
                    mode.paused -= 1
            monkeypatch.setattr(tlg, name, wrapped)
    with mode:
        mesp.value_and_grad(params, cfg, batch, policy=ExecutionPolicy(
            backend="cuda", quantize=method))
    stacks = [s for s in mode.shapes if s in ((E, d, f), (E, f, d))]
    assert not stacks if pause else stacks
    # the mode sees the backward: dA of the attention's LoRA, [d, r]
    assert (d, cfg.lora.rank) in mode.shapes


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_runs():
    run = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
           "--steps", "3", "--seq", str(SEQ), "--quantize", "nf4"]
    return {e: ttrain.train(run + ["--engine", e])
            for e in ("mesp_cuda", "mesp", "mebp", "store_h")}


@pytest.mark.parametrize("engine", ["mesp", "mebp", "store_h"])
def test_quantized_moe_cli_engines_give_one_loss_curve(cli_runs, engine):
    want = cli_runs["mesp_cuda"]["losses"]
    assert len(want) == 3 and all(np.isfinite(want))
    np.testing.assert_allclose(cli_runs[engine]["losses"], want, rtol=1e-5,
                               atol=1e-5)
    assert cli_runs[engine]["policy"].quantize == "nf4"
    w = cli_runs[engine]["params"]["blocks"]["moe"]["gate"]["w"]
    assert tq.packed_method(w) == "nf4" and w["q4"].ndim == 4


# -------------------------------------------------------------------- RoPE


# (B, N, H, D): qwen's heads at a short N, OLMoE's head_dim, an odd N
ROPE_CASES = [(1, 24, 14, 64), (2, 16, 4, 128), (1, 33, 3, 16)]


@pytest.mark.parametrize("B,N,H,D", ROPE_CASES)
def test_rope_apply_matches_reference(jx, B, N, H, D):
    """Forward and the gradient (the same rotation at −θ) of the port's
    ``rope_apply`` (plain version on the CPU) against the reference's
    ``rope_apply`` in interpret mode, on the same f32 tables, at 1e-6
    absolute: the jitted interpreter lets XLA contract a product and the
    sum into one FMA, which moves about a quarter of the outputs by an ulp.
    Against the reference's eager rotation (``apply_rope_tables``), which
    rounds each product and the sum apart as the kernel does: bit for bit.
    The tables themselves agree at 1e-6."""
    jnp = jx.jnp
    rng = np.random.default_rng(54)
    x, cot = _rand(rng, B, N, H, D), _rand(rng, B, N, H, D)
    pos = np.arange(N, dtype=np.int32)
    jcos, jsin = jx.rope.rope_tables(jnp.asarray(pos), 10000.0, D)
    tcos, tsin = trope.rope_tables(torch.from_numpy(pos), 10000.0, D)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    cos, sin = np.asarray(jcos), np.asarray(jsin)
    want, vjp = jx.jax.vjp(
        lambda t: jx.rope.rope_apply(t, jnp.asarray(cos), jnp.asarray(sin),
                                     True), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = trope.rope_apply(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    (tdx,) = torch.autograd.grad(got, tx, torch.from_numpy(cot))
    ulp = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ulp)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **ulp)
    heads = lambda t: jnp.asarray(t).transpose(0, 2, 1, 3)  # [B, H, N, D]
    for c, sn, t, out in ((cos, sin, x, got), (cos, -sin, cot, tdx)):
        eager = np.asarray(jx.rope.apply_rope_tables(heads(t), c, sn))
        np.testing.assert_array_equal(out.detach().numpy(),
                                      eager.transpose(0, 2, 1, 3))
    assert trope.rope_fwd.launches == 0


# ------------------------------------------------------------- card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


def _close_scaled(got, want, tol):
    """assert_close with the absolute floor taken relative to the output's
    largest magnitude (at least 1), NaN on the same entries."""
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    scale = max(1.0, float(want[ok].float().abs().max()))
    torch.testing.assert_close(got[ok].float(), want[ok].float(),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)


# (M, K, N, E, r, bm, gid): the path's tiling (bm 40, gate/up and down),
# C 13 padded to 16, a 72-row tile over two blocks, odd K with a ragged N,
# ranks 3 and 16, an empty group, a bad gid; then the bf16 forward's
# row-fragment boundaries (bm 16 above; 48: three m16 fragments; 64: four;
# 65: a 64-row part and a 1-row one), r 32 at bm 40, and DeepSeekMoE's
# expert widths (d_expert 1408)
CARD_CASES = RAGGED_CASES + [
    (320, 2048, 1024, 8, 8, 40, list(range(8))),
    (160, 1024, 2048, 8, 8, 40, [7, 6, 5, 4]),
    (64, 2048, 1024, 4, 8, 16, [0, 1, 2, 3]),
    (144, 1024, 2048, 2, 16, 72, [1, 0]),
    (120, 97, 131, 3, 3, 40, [0, 1, 2]),
    (160, 256, 192, 4, 8, 40, [0, 70, 1, -1]),
    (96, 512, 384, 2, 8, 48, [0, 1]),
    (128, 512, 384, 2, 8, 64, [1, 0]),
    (130, 511, 384, 2, 8, 65, [0, 1]),
    (120, 1024, 2048, 3, 32, 40, [0, 1, 2]),
    (80, 2048, 1408, 2, 8, 40, [0, 1]),
    (80, 1408, 2048, 2, 8, 40, [1, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,E,r,bm,gid", CARD_CASES)
def test_quantized_grouped_kernels_match_plain_on_card(M, K, N, E, r, bm,
                                                       gid, method, dtype):
    """f32: summation order only. bf16: one output rounding, doubled where
    a rounding of h, dh or g·s flips, with an absolute floor."""
    _need_card()
    dt = getattr(torch, dtype)
    x, q, s, a, b, g = (torch.from_numpy(t).cuda() for t in _codes_inputs(
        55, M, K, N, E, r, method))
    x, a, b, g = (t.to(dt) for t in (x, a, b, g))
    gid = torch.tensor(gid, dtype=torch.int32, device="cuda")
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    fwd, dx_fn = _port_calls(method)
    names = ("lora_grouped_gemm_q", "lora_grouped_dx_q") if \
        method == "int8" else ("lora_grouped_gemm_q4", "lora_grouped_dx_q4")
    before = [getattr(tlg, n).launches for n in names]
    y = fwd(x, q, s, a, b, gid, 2.0, bm=bm)
    dx = dx_fn(g, q, s, a, b, gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert [getattr(tlg, n).launches for n in names] == [c + 1
                                                         for c in before]
    assert y.dtype == dx.dtype == dt and dx.shape == (M, K)
    refs = (tlg.lora_grouped_gemm_q_ref, tlg.lora_grouped_dx_q_ref) if \
        method == "int8" else (
            functools.partial(tlg.lora_grouped_gemm_q4_ref, method=method),
            functools.partial(tlg.lora_grouped_dx_q4_ref, method=method))
    _close_scaled(y, refs[0](x, q, s, a, b, gid, 2.0, bm=bm), tol)
    _close_scaled(dx, refs[1](g, q, s, a, b, gid, 2.0, bm=bm), tol)


# (M, K, N, E, r, bm): the path's gate/up tiling and an odd K with a ragged
# N, whose codes are loaded byte by byte
REPEAT_CASES = [(320, 2048, 1024, 8, 8, 40), (120, 97, 131, 3, 8, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,E,r,bm", REPEAT_CASES)
def test_quantized_grouped_forward_bf16_is_bitwise_on_repeat(M, K, N, E, r,
                                                             bm, method):
    """The bf16 forward over codes, on tensor cores, sums in a fixed order:
    two launches on the same inputs give the same bits."""
    _need_card()
    x, q, s, a, b, _ = (torch.from_numpy(t).cuda() for t in _codes_inputs(
        58, M, K, N, E, r, method))
    x, a, b = (t.to(torch.bfloat16) for t in (x, a, b))
    gid = torch.arange(E, dtype=torch.int32, device="cuda")
    fwd, _ = _port_calls(method)
    y1 = fwd(x, q, s, a, b, gid, 2.0, bm=bm)
    y2 = fwd(x, q, s, a, b, gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y1).all())
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,E,r,bm", REPEAT_CASES)
def test_quantized_grouped_dx_bf16_is_bitwise_on_repeat(M, K, N, E, r, bm,
                                                        method):
    """The bf16 dx over codes runs its tensor-core body (the f32 dx its
    CUDA-core one) and sums in a fixed order: two launches on the same
    inputs give the same bits."""
    _need_card()
    _, q, s, a, b, g = (torch.from_numpy(t).cuda() for t in _codes_inputs(
        59, M, K, N, E, r, method))
    a, b, g = (t.to(torch.bfloat16) for t in (a, b, g))
    gid = torch.arange(E, dtype=torch.int32, device="cuda")
    _, dx = _port_calls(method)
    d1 = dx(g, q, s, a, b, gid, 2.0, bm=bm)
    d2 = dx(g, q, s, a, b, gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d1).all())
    assert torch.equal(d1, d2)
    plan = tlg.dx_plan(torch.bfloat16, method, bm=bm)
    assert plan["tensor_cores"] and plan["row_fragments"] == 3
    assert plan["smem_bytes"] > 0
    dx(g.float(), q, s, a.float(), b.float(), gid, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert tlg.dx_plan(torch.float32, method, bm=bm) == {
        "tensor_cores": False, "row_fragments": 0, "smem_bytes": 0}


@pytest.mark.cuda
def test_quantized_grouped_kernels_reject_bad_input():
    _need_card()
    x, q, s, a, b, g = (torch.from_numpy(t).cuda() for t in _codes_inputs(
        56, 32, 25, 16, 3, 4, "nf4"))
    gid = torch.arange(4, dtype=torch.int32, device="cuda") % 3
    fwd, dx = _port_calls("nf4")
    with pytest.raises(TypeError, match="uint8"):
        fwd(x, q.to(torch.int8), s, a, b, gid, 2.0, bm=8)
    with pytest.raises(ValueError, match="q has shape"):
        fwd(x, q[:, :-1].contiguous(), s, a, b, gid, 2.0, bm=8)
    with pytest.raises(ValueError, match="s has shape"):
        dx(g, q, s[:, :, :8].contiguous(), a, b, gid, 2.0, bm=8)
    with pytest.raises(ValueError, match="unknown packed method"):
        tlg.lora_grouped_gemm_q4(x, q, s, a, b, gid, 2.0, bm=8, method="fp4")
    with pytest.raises(TypeError, match="int8"):
        tlg.lora_grouped_gemm_q(x, q, s, a, b, gid, 2.0, bm=8)


def _placed(t, off):
    """A contiguous copy of ``t`` that starts ``off`` elements into a fresh
    buffer (off 1: its base is off 16-byte alignment)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,D", ROPE_CASES + [
    (1, 256, 16, 128), (2, 7, 3, 10), (1, 40, 1, 128)])
def test_rope_kernel_matches_plain_bitwise_on_card(B, N, H, D, dtype, off):
    """The RoPE kernel and its VJP (the kernel at −sin) equal the plain
    rotation bit for bit: 16-byte units of the half (D 16 one unit in
    bf16), an odd half (D 10) and x and its cotangent off 16-byte alignment
    (element loads), one head and many."""
    _need_card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(57)
    x = _placed(torch.from_numpy(_rand(rng, B, N, H, D)).to(dt).cuda(), off)
    cot = _placed(torch.from_numpy(_rand(rng, B, N, H, D)).to(dt).cuda(), off)
    assert (x.data_ptr() % 16 != 0) == bool(off)
    cos, sin = trope.rope_tables(torch.arange(N, device="cuda"), 1e6, D)
    before = trope.rope_fwd.launches
    xr = _placed(x, off).requires_grad_(True)
    y = trope.rope_apply(xr, cos, sin)
    (dx,) = torch.autograd.grad(y, xr, cot)
    torch.cuda.synchronize()
    assert trope.rope_fwd.launches == before + 2
    assert torch.equal(y, trope.rope_fwd_ref(x, cos, sin))
    assert torch.equal(dx, trope.rope_fwd_ref(cot, cos, -sin))
