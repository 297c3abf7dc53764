"""The port's quantized frozen base (``--quantize int8|int4|nf4``) against
the JAX reference (f32, CPU).

1. Format: ``repro_torch.core.quant`` gives the reference's bytes exactly
   (f32 and bf16 weights, K even and odd, an all-zero column), and the same
   dequantized values.
2. Bridge: quantized reference trees come through ``bridge`` and back with
   equal bytes; ``scale`` and ``code`` stay f32 under a bf16 cast.
3. Kernels: the quantized kernels' plain versions, through the port's
   ``kernels.ops.lora_linear``, against the reference's dispatch (Pallas in
   interpret mode), forward and VJP, at the JAX suite's 2e-5.
4. Model: ``mesp.value_and_grad`` at seq 48 and at seq 96 (flash lengths):
   the port's ``cuda`` backend (plain versions here) against the
   reference's ``pallas``, and ``structured`` against ``structured``; loss
   at rtol 1e-5, each LoRA gradient leaf at relative L2 1e-5, B drawn at
   0.02 as in ``test_torch_train.py``.
5. No dense W0 on the kernel path: a ``TorchDispatchMode`` records every
   floating tensor any op makes during ``value_and_grad``, with recording
   suspended inside the four quantized kernel wrappers (whose plain
   versions dequantize by nature). Under ``cuda`` no tensor has a W0 shape;
   under ``structured``, which dequantizes, they are found. This stands in
   for the reference's jaxpr check.
6. CLI: one f32 loss curve under every engine with ``--quantize``.

The tests marked ``cuda`` hold the four CUDA kernels against their plain
versions on a card and skip without one. JAX is imported only inside the
parity fixtures, so the card tests run where JAX is not installed.
"""
import functools
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import mesp
from repro_torch.core import quant as tq
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import lora_fused as tlf
from repro_torch.kernels import lora_pack4 as tlp4
from repro_torch.kernels import lora_quant as tlq
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain

_FIELDS = dict(name="quant-test", family="dense", n_layers=2, d_model=160,
               n_heads=4, n_kv_heads=2, d_ff=192, vocab=97, qkv_bias=True,
               tie_embeddings=True, dtype="float32")
TCFG = ArchConfig(**_FIELDS)
BATCH, SEQ, FLASH_SEQ = 2, 48, 96
METHODS = ("int8", "int4", "nf4")
#: the reference's tolerance for the quantized ops (test_quant_mode.py)
OP_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_BACKEND = {"cuda": "pallas", "structured": "structured"}


@pytest.fixture(scope="module")
def jx():
    """The reference's modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.api.policy import ExecutionPolicy as JaxPolicy
    from repro.configs.base import ArchConfig as JaxArchConfig
    from repro.core import mesp as jmesp
    from repro.core import quant as jquant
    from repro.kernels import ops as jops
    from repro.models import model as JM
    return SimpleNamespace(jax=jax, jnp=jnp, Policy=JaxPolicy, quant=jquant,
                           mesp=jmesp, ops=jops, M=JM,
                           cfg=JaxArchConfig(**_FIELDS))


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


# ------------------------------------------------------------------ format


def _weight(K, N, seed=0):
    """[K, N] f32 with per-column magnitudes over two decades and column 3
    all zero (the scale's 1e-8 floor)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)) * np.exp(rng.standard_normal((1, N)))
    w[:, 3] = 0.0
    return w.astype(np.float32)


@pytest.mark.parametrize("K", [96, 97])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
def test_quantize_leaf_gives_the_reference_bytes(jx, method, dtype, K):
    jnp = jx.jnp
    w = _weight(K, 131)
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    want = _np(jx.quant.quantize_leaf(jw, method))
    got = bridge.to_numpy_tree(tq.quantize_leaf(tw, method))
    _assert_same_bytes(got, want)
    leaf = tq.quantize_leaf(tw, method)
    jleaf = jx.quant.quantize_leaf(jw, method)
    for out in ("float32", "bfloat16"):
        d = tq.maybe_dequant(leaf, getattr(torch, out)).float().numpy()
        jd = np.asarray(jx.quant.maybe_dequant(
            jleaf, getattr(jnp, out)).astype(jnp.float32))
        np.testing.assert_array_equal(d, jd)
    assert d.shape == (K, 131) and np.all(d[:, 3] == 0)
    if method != "int8":
        assert tq.packed_k(leaf) == jx.quant.packed_k(jleaf) == K
        assert tq.packed_method(leaf) == method


@pytest.mark.parametrize("method", METHODS)
def test_quantize_frozen_gives_the_reference_tree(jx, method):
    """Stacked [L, K, N] block leaves (code and kpad broadcast over L),
    every frozen ``w`` quantized and nothing else; re-quantizing an int8
    tree (the degradation ladder's int8 -> 4-bit step) gives the same
    bytes too."""
    jp = jx.M.init_params(jx.jax.random.PRNGKey(0), jx.cfg)
    tp = bridge.from_numpy_tree(_np(jp))
    _assert_same_bytes(bridge.to_numpy_tree(tq.quantize_frozen(
        tp, method=method)), _np(jx.quant.quantize_frozen(jp, method=method)))
    j8 = jx.quant.quantize_frozen(jp, method="int8")
    t8 = tq.quantize_frozen(tp, method="int8")
    _assert_same_bytes(bridge.to_numpy_tree(tq.quantize_params(t8, method)),
                       _np(jx.quant.quantize_params(j8, method)))
    assert tq.quantize_params(tp, "none") is tp
    with pytest.raises(ValueError, match="unknown quantize"):
        tq.quantize_params(tp, "fp8")


def test_pack_and_unpack_nibbles_invert():
    rng = np.random.default_rng(1)
    nib = torch.from_numpy(rng.integers(0, 16, (3, 7, 5)).astype(np.int32))
    packed = tq.pack_nibbles(nib, pad_value=tq.NF4_ZERO_NIBBLE)
    assert packed.shape == (3, 4, 5) and packed.dtype == torch.uint8
    assert torch.equal(tq.unpack_nibbles(packed, 7), nib)
    assert torch.all(tq.unpack_nibbles(packed)[:, 7] == tq.NF4_ZERO_NIBBLE)
    assert torch.equal(tq.sign_extend4(torch.arange(16)),
                       torch.tensor([0, 1, 2, 3, 4, 5, 6, 7,
                                     -8, -7, -6, -5, -4, -3, -2, -1]))


# ------------------------------------------------------------------ bridge


@pytest.mark.parametrize("method", METHODS)
def test_bridge_carries_quantized_leaves(jx, method):
    ref = _np(jx.M.init_params(jx.jax.random.PRNGKey(0), jx.cfg,
                               quantize=method))
    _assert_same_bytes(bridge.to_numpy_tree(bridge.from_numpy_tree(ref)), ref)
    half = bridge.from_numpy_tree(ref, dtype=torch.bfloat16)
    w = half["blocks"]["mlp"]["down"]["w"]
    assert w["scale"].dtype == torch.float32
    assert w["q" if method == "int8" else "q4"].dtype == (
        torch.int8 if method == "int8" else torch.uint8)
    if method == "nf4":
        assert w["code"].dtype == torch.float32 and w["code"].shape == (2, 16)
    assert half["blocks"]["mlp"]["down"]["a"].dtype == torch.bfloat16
    assert half["embed"]["tok"].dtype == torch.bfloat16
    got = _leaves(bridge.to_numpy_tree(half))
    for path, want in _leaves(ref).items():
        if "/w/" in path:   # the quantized leaf keeps its bytes under bf16
            assert got[path].tobytes() == want.tobytes(), path


# ------------------------------------------------- kernels' plain versions


def _op_inputs(seed, M, K, N, r, method):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return (f(M, K, sc=0.3), f(K, N, sc=0.05), f(K, r, sc=0.3),
            f(r, N, sc=0.3), f(M, N, sc=0.3))


# (M, K, N): the shapes of test_quant_mode.py's op checks (odd K included)
OP_CASES = [(192, 160, 200), (50, 97, 131)]


@pytest.mark.parametrize("M,K,N", OP_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_quantized_ops_match_reference_vjp(jx, method, M, K, N):
    """``lora_linear`` on a quantized leaf: the port's dispatch (the plain
    versions of the quantized kernels here) against the reference's
    (Pallas in interpret mode), output and the VJP wrt x, A and B."""
    jax, jnp = jx.jax, jx.jnp
    x, w, a, b, g = _op_inputs(7, M, K, N, 8, method)
    jleaf = jx.quant.quantize_leaf(jnp.asarray(w), method)
    pol = jx.Policy(backend="pallas", interpret=True)
    jy, vjp = jax.vjp(lambda x, a, b: jx.ops.lora_linear(
        x, jleaf, a, b, None, 2.0, policy=pol), *map(jnp.asarray, (x, a, b)))
    jgrads = vjp(jnp.asarray(g))
    leaf = bridge.from_numpy_tree(_np(jleaf))
    tx, ta, tb = (torch.from_numpy(t).requires_grad_(True) for t in (x, a, b))
    tops.reset_launch_counts()
    y = tops.lora_linear(tx, leaf, ta, tb, None, 2.0)
    grads = torch.autograd.grad(y, (tx, ta, tb), torch.from_numpy(g))
    assert set(tops.launch_counts().values()) == {0}   # CPU: plain versions
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **OP_TOL)
    for t, j in zip(grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **OP_TOL)


@pytest.mark.parametrize("scale", [2.0, 1.5])
@pytest.mark.parametrize("M,K,N", OP_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_quantized_dx_plain_matches_pallas_kernel(jx, method, M, K, N,
                                                  scale):
    """The plain quantized dx against the reference's ``lora_dx_q`` /
    ``lora_dx_q4`` (Pallas in interpret mode) on the same leaf, at the
    model's scale 2 and at 1.5, no power of two: f32, 1e-5."""
    from repro.kernels import lora_pack4 as jlp4
    from repro.kernels import lora_quant as jlq
    jnp = jx.jnp
    x, w, a, b, g = _op_inputs(9, M, K, N, 8, method)
    jleaf = jx.quant.quantize_leaf(jnp.asarray(w), method)
    leaf = bridge.from_numpy_tree(_np(jleaf))
    ja, jb, jg = map(jnp.asarray, (a, b, g))
    ta, tb, tg = map(torch.from_numpy, (a, b, g))
    if method == "int8":
        want = jlq.lora_dx_q(jg, jleaf["q"], jleaf["scale"], ja, jb, scale,
                             interpret=True)
        got = tlq.lora_dx_q(tg, leaf["q"], leaf["scale"], ta, tb, scale)
    else:
        want = jlp4.lora_dx_q4(jg, jleaf["q4"], jleaf["scale"], ja, jb,
                               scale, method=method, interpret=True)
        got = tlp4.lora_dx_q4(tg, leaf["q4"], leaf["scale"], ta, tb, scale,
                              method=method)
    assert got.shape == (M, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_plain_versions_are_the_dequantized_product(method):
    """In f32 each plain version is the dense plain version over the
    dequantized W0, up to where the scale is applied."""
    from repro_torch.kernels import lora_fused as tlf
    x, w, a, b, g = map(torch.from_numpy, _op_inputs(8, 30, 97, 70, 4,
                                                     method))
    leaf = tq.quantize_leaf(w, method)
    wd = tq.maybe_dequant(leaf, torch.float32)
    if method == "int8":
        y = tlq.lora_fused_q_ref(x, leaf["q"], leaf["scale"], a, b)
        dx = tlq.lora_dx_q_ref(g, leaf["q"], leaf["scale"], a, b)
    else:
        y = tlp4.lora_fused_q4_ref(x, leaf["q4"], leaf["scale"], a, b,
                                   method=method)
        dx = tlp4.lora_dx_q4_ref(g, leaf["q4"], leaf["scale"], a, b,
                                 method=method)
    torch.testing.assert_close(y, tlf.lora_fused_ref(x, wd, a, b),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, tlf.lora_dx_ref(g, wd, a, b),
                               rtol=1e-5, atol=1e-5)
    assert dx.shape == (30, 97)


def test_quantized_functions_save_codes_not_w0():
    """The quantized Functions save exactly (x, q|q4, s, a, b): the codes
    and the scale, never h and never a dense W0."""
    x, w, a, b, _ = map(torch.from_numpy, _op_inputs(9, 12, 33, 40, 4,
                                                     "int8"))
    for method in METHODS:
        leaf = tq.quantize_leaf(w, method)
        codes = leaf["q"] if method == "int8" else leaf["q4"]
        tx, ta, tb = (t.clone().requires_grad_(True) for t in (x, a, b))
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append((tuple(t.shape), t.dtype)) or t,
                lambda t: t):
            y = tops.lora_linear(tx.view(3, 4, 33), leaf, ta, tb, None, 2.0)
        assert saved == [((3, 4, 33), torch.float32),
                         (tuple(codes.shape), codes.dtype),
                         ((1, 40), torch.float32), ((33, 4), torch.float32),
                         ((4, 40), torch.float32)], method
        y.sum().backward()
        assert tx.grad is not None and ta.grad is not None


def test_grouped_decode_raises_on_a_quantized_base():
    """The grouped decode path takes a quantized base (its kernels and their
    parity are in tests/test_torch_serve_quant.py), but only a shared
    [K, N] one: a per-expert stack (Ew = E, MoE's) or a packed leaf of
    another K raises under every backend."""
    x, w, *_ = map(torch.from_numpy, _op_inputs(10, 4, 16, 24, 4, "int8"))
    a, b = torch.zeros(2, 16, 4), torch.zeros(2, 4, 24)
    gid = torch.zeros(2, dtype=torch.int32)
    for method in METHODS:
        stacked = tq.quantize_leaf(torch.stack([w, w]), method)
        other_k = tq.quantize_leaf(w[:15], method)
        for backend in ("cuda", "structured"):
            pol = ExecutionPolicy(backend=backend, quantize=method)
            with pytest.raises(ValueError, match="per-expert"):
                tops.lora_grouped_decode(x, stacked, a, b, gid, bm=2,
                                         policy=pol)
            if method != "int8":
                with pytest.raises(ValueError, match="K=15"):
                    tops.lora_grouped_decode(x, other_k, a, b, gid, bm=2,
                                             policy=pol)
            y = tops.lora_grouped_decode(x, tq.quantize_leaf(w, method), a,
                                         b, gid, bm=2, policy=pol)
            assert y.shape == (4, 24) and bool(torch.isfinite(y).all())


# ------------------------------------------------------------------- model


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


@pytest.fixture(scope="module")
def np_qparams(jx):
    """{method: the reference's init_params(PRNGKey(0), quantize=method)
    as numpy, every LoRA B redrawn at 0.02}."""
    return {m: _redraw_b(_np(jx.M.init_params(jx.jax.random.PRNGKey(0),
                                               jx.cfg, quantize=m)),
                         np.random.default_rng(1)) for m in METHODS}


def _np_batch(seq):
    return next(tpipe.make_batch_iterator(TCFG.vocab, seq, BATCH, seed=3,
                                          n_tokens=4096))


@pytest.fixture(scope="module")
def jax_runs(jx, np_qparams):
    """(method, seq, port backend) -> the reference's (loss, {path: grad}),
    computed on first use and shared. The step is jitted, as the
    reference's trainer runs it (half the time of the eager interpret-mode
    run here)."""
    @functools.lru_cache(maxsize=None)
    def run(method, seq, backend):
        jnp = jx.jnp
        jp = jx.jax.tree_util.tree_map(jnp.asarray, np_qparams[method])
        jb = {k: jnp.asarray(v) for k, v in _np_batch(seq).items()}
        pol = jx.Policy(backend=JAX_BACKEND[backend],
                        interpret=True if backend == "cuda" else None)
        loss, grads = jx.jax.jit(lambda p, b: jx.mesp.value_and_grad(
            p, jx.cfg, b, policy=pol))(jp, jb)
        return float(loss), {k: None if v is None else np.asarray(v)
                             for k, v in _leaves(grads).items()}
    return run


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
@pytest.mark.parametrize("seq", [SEQ, FLASH_SEQ])
@pytest.mark.parametrize("method", METHODS)
def test_value_and_grad_matches_reference(np_qparams, jax_runs, method, seq,
                                          backend):
    jloss, jgrads = jax_runs(method, seq, backend)
    loss, grads = mesp.value_and_grad(
        bridge.from_numpy_tree(np_qparams[method]), TCFG,
        {k: torch.from_numpy(v).long() for k, v in _np_batch(seq).items()},
        policy=ExecutionPolicy(backend=backend, quantize=method))
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
    assert n_lora == 14


@pytest.mark.parametrize("method", ["int4", "nf4"])
def test_odd_k_base_unstacks_and_trains_alike_on_every_backend(method):
    """d_ff 97: the down projection's packed W0 has odd K, so its leaf
    carries ``kpad`` [L, 1] beside ``code`` [L, 16]; both unbind along L
    with the codes, and ``cuda`` (plain versions here), ``structured`` and
    ``plain`` give the same loss and LoRA gradients."""
    import dataclasses
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(TCFG, d_ff=97)
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(2),
                            quantize=method)
    down = params["blocks"]["mlp"]["down"]["w"]
    assert tq.packed_k(down) == 97 and down["kpad"].shape == (2, 1)
    per = TM._unstack(params["blocks"], cfg.n_layers)
    assert all(tq.packed_k(p["mlp"]["down"]["w"]) == 97 for p in per)
    assert all(torch.equal(p["mlp"]["down"]["w"]["q4"], down["q4"][i])
               for i, p in enumerate(per))
    assert not any(_leaves(TM.trainable_mask(params["blocks"]["mlp"]["down"]
                                             ["w"])).values())
    gen = torch.Generator().manual_seed(3)
    for lin in ("gate", "up", "down"):
        b = params["blocks"]["mlp"][lin]["b"]
        b.copy_(torch.randn(b.shape, generator=gen) * 0.02)
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch(SEQ).items()}
    runs = {be: mesp.value_and_grad(params, cfg, batch,
                                    policy=ExecutionPolicy(backend=be,
                                                           quantize=method))
            for be in ("cuda", "structured", "plain")}
    loss, grads = runs["cuda"]
    for be, (l2, g2) in runs.items():
        np.testing.assert_allclose(float(l2), float(loss), rtol=1e-5)
        for path, g in _leaves(grads).items():
            if g is not None:
                assert _rel(_leaves(g2)[path].numpy(), g.numpy()) <= 1e-5


@pytest.mark.parametrize("made,asked", [("nf4", "none"), ("none", "int8"),
                                        ("int8", "int4"), ("int4", "nf4")])
def test_value_and_grad_rejects_a_base_of_another_format(made, asked):
    """``policy.quantize`` is held against the params' leaves: a run that
    asked for one format and was handed another raises before any op."""
    from repro_torch.models import model as TM
    params = TM.init_params(TCFG, generator=torch.Generator().manual_seed(0),
                            quantize=made)
    assert tq.tree_method(params) == made
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch(SEQ).items()}
    with pytest.raises(ValueError, match=f"frozen base is {made!r}"):
        mesp.value_and_grad(params, TCFG, batch, policy=ExecutionPolicy(
            backend="cuda", quantize=asked))
    mixed = dict(params, blocks=dict(params["blocks"], mlp=tq.quantize_frozen(
        params["blocks"]["mlp"], method=asked if asked != "none" else "int8")))
    with pytest.raises(ValueError, match="mix formats"):
        tq.tree_method(mixed)


# ------------------------------------------------- no dense W0 on the path


class _FloatOutputs(TorchDispatchMode):
    """Shapes of the floating tensors every op outputs, except while
    ``paused``."""

    def __init__(self):
        super().__init__()
        self.paused, self.shapes = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    self.shapes.append(tuple(t.shape))
        return out


_QUANT_WRAPPERS = ((tlq, "lora_fused_q"), (tlq, "lora_dx_q"),
                   (tlp4, "lora_fused_q4"), (tlp4, "lora_dx_q4"))


def _w0_shapes():
    """Every frozen linear's [K, N] and [N, K] at TCFG. At batch 2 x seq 48
    no activation has one: rows are 96, no W0 dimension is."""
    d, hd, f = TCFG.d_model, TCFG.resolved_head_dim, TCFG.d_ff
    kn = {(d, TCFG.n_heads * hd), (d, TCFG.n_kv_heads * hd),
          (TCFG.n_heads * hd, d), (d, f), (f, d)}
    return kn | {(n, k) for k, n in kn}


def _made_shapes(monkeypatch, params, backend, method):
    mode = _FloatOutputs()

    def paused(fn):
        def call(*args, **kw):
            mode.paused += 1
            try:
                return fn(*args, **kw)
            finally:
                mode.paused -= 1
        return call

    for mod, name in _QUANT_WRAPPERS:
        monkeypatch.setattr(mod, name, paused(getattr(mod, name)))
    batch = {k: torch.from_numpy(v).long() for k, v in _np_batch(SEQ).items()}
    with mode:
        mesp.value_and_grad(params, TCFG, batch, policy=ExecutionPolicy(
            backend=backend, quantize=method))
    return mode.shapes


@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_no_dense_w0_is_made_on_the_kernel_path(monkeypatch, method):
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import model as TM
    params = TM.init_params(TCFG, generator=gen, quantize=method)
    w0 = _w0_shapes()
    made = _made_shapes(monkeypatch, params, "cuda", method)
    assert [s for s in made if s[-2:] in w0] == []
    # the mode sees the backward: dA of every linear, [K, r], is recorded
    assert (TCFG.d_model, TCFG.lora.rank) in made
    assert (TCFG.d_ff, TCFG.lora.rank) in made


@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_structured_path_does_make_dense_w0(monkeypatch, method):
    """The same check bites: the structured backend dequantizes, so W0's
    shapes appear (forward, and the recompute under checkpointing)."""
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import model as TM
    params = TM.init_params(TCFG, generator=gen, quantize=method)
    made = _made_shapes(monkeypatch, params, "structured", method)
    hits = {s[-2:] for s in made} & _w0_shapes()
    d, f = TCFG.d_model, TCFG.d_ff
    assert {(d, d), (d, f), (f, d)} <= hits, hits


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_losses():
    """{(method, seq): {engine: losses}} of the train CLI, reduced, CPU."""
    out = {}
    for method in METHODS:
        for seq in (SEQ, FLASH_SEQ):
            run = ["--reduced", "--device", "cpu", "--seq", str(seq),
                   "--steps", "3", "--quantize", method]
            out[method, seq] = {e: ttrain.train(run + ["--engine", e])
                                for e in ("mesp_cuda", "mesp", "mebp",
                                          "store_h")}
    return out


@pytest.mark.parametrize("seq", [SEQ, FLASH_SEQ])
@pytest.mark.parametrize("method", METHODS)
def test_train_cli_quantize_gives_one_loss_curve(cli_losses, method, seq):
    runs = cli_losses[method, seq]
    want = runs["mesp_cuda"]["losses"]
    assert len(want) == 3 and all(np.isfinite(want))
    for engine, out in runs.items():
        np.testing.assert_allclose(out["losses"], want, rtol=1e-5, atol=1e-5,
                                   err_msg=engine)
        assert out["policy"].quantize == method
    w = runs["mesp_cuda"]["params"]["blocks"]["mlp"]["up"]["w"]
    assert (tq.is_quantized(w) if method == "int8" else
            tq.packed_method(w) == method)


def test_train_cli_rejects_an_unknown_method():
    with pytest.raises(SystemExit):
        ttrain.build_arg_parser().parse_args(["--quantize", "fp8"])
    with pytest.raises(ValueError, match="unknown quantize"):
        ExecutionPolicy(quantize="fp8")


# ------------------------------------------------------------- card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


def _assert_close_scaled(got, want, tol):
    """assert_close with the absolute floor relative to the output's largest
    magnitude (at least 1), as in test_torch_kernels.py."""
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _card_pair(method):
    """(fwd, dx, fwd_ref, dx_ref, codes key) for ``method``."""
    if method == "int8":
        return (tlq.lora_fused_q, tlq.lora_dx_q, tlq.lora_fused_q_ref,
                tlq.lora_dx_q_ref, "q")
    kw = dict(method=method)
    return (functools.partial(tlp4.lora_fused_q4, **kw),
            functools.partial(tlp4.lora_dx_q4, **kw),
            functools.partial(tlp4.lora_fused_q4_ref, **kw),
            functools.partial(tlp4.lora_dx_q4_ref, **kw), "q4")


# the bf16 forward's card cases beyond the path: OLMoE's 2048 x 2048 at M
# 256; M 1, 16, 63 (odd K: the pad nibble), 64 and 65 (one to four m16
# fragments, a row tile plus one row); K 4864 into N 128, the deepest K
# split (8 blocks a cluster)
TC_CASES = [
    (256, 2048, 2048, 8), (1, 896, 896, 8), (16, 896, 4864, 8),
    (63, 97, 131, 16), (64, 896, 896, 8), (65, 4863, 128, 32),
    (256, 4864, 128, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,r", [
    (192, 160, 200, 8), (50, 97, 131, 8), (256, 896, 896, 8),
    (256, 896, 128, 8), (256, 896, 4864, 8), (256, 4864, 896, 8),
    (37, 33, 129, 16), (64, 64, 64, 1), (130, 301, 70, 32),
] + TC_CASES)
def test_quantized_kernels_match_plain_on_card(M, K, N, r, method, dtype):
    """Each quantized kernel against its plain version on the same inputs.
    f32: summation order only. bf16: one output rounding (2^-8 relative),
    doubled where a rounding of h or dh flips, and an absolute floor: the
    tolerance of the dense LoRA kernels' check."""
    _need_card()
    dt = getattr(torch, dtype)
    x, w, a, b, g = (torch.from_numpy(t) for t in _op_inputs(
        14, M, K, N, r, method))
    b = b * 3
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w, method).items()}
    x, a, b, g = (t.to(dt).cuda() for t in (x, a, b, g))
    fwd, dx_fn, fwd_ref, dx_ref, key = _card_pair(method)
    q, s = leaf[key], leaf["scale"]
    before = tops.launch_counts()
    y = fwd(x, q, s, a, b, 2.0)
    dx = dx_fn(g, q, s, a, b, 2.0)
    torch.cuda.synchronize()
    after = tops.launch_counts()
    names = ("lora_fused_q", "lora_dx_q") if method == "int8" else \
        ("lora_fused_q4", "lora_dx_q4")
    assert all(after[n] == before[n] + 1 for n in names)
    assert y.dtype == dx.dtype == dt and dx.shape == (M, K)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    _assert_close_scaled(y, fwd_ref(x, q, s, a, b, 2.0), tol)
    _assert_close_scaled(dx, dx_ref(g, q, s, a, b, 2.0), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,r", [(256, 896, 896, 8), (50, 97, 131, 8)]
                         + TC_CASES)
def test_quantized_forward_bf16_is_bitwise_on_repeat(M, K, N, r, method):
    """The bf16 quantized forward on tensor cores adds its K split's
    partials in a fixed order (no atomics): the same bits on every call.
    The split is 1 to 8 blocks, 8 at K 4864 into N 128."""
    _need_card()
    x, w, a, b, _ = (torch.from_numpy(t) for t in _op_inputs(
        17, M, K, N, r, method))
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w, method).items()}
    x, a, b = (t.to(torch.bfloat16).cuda() for t in (x, a, b * 3))
    fwd, _, _, _, key = _card_pair(method)
    y = fwd(x, leaf[key], leaf["scale"], a, b, 2.0)
    for _ in range(3):
        assert torch.equal(fwd(x, leaf[key], leaf["scale"], a, b, 2.0), y)
    plan = tlf.forward_plan(M, K, N, method)
    assert 1 <= plan["split"] <= 8 and plan["smem_bytes"] > 0
    if (M, K, N) == (256, 4864, 128):
        assert plan["split"] == 8


# the bf16 dx's card cases over codes, g [M, N] -> dx [M, K]: every path
# shape (K, N) at M 1, 17, 65, 192 and 256, r 8; ragged K and N at other
# ranks, odd K (over int4 and nf4, a pad nibble no row of dx takes); K 896
# from N 4864, the deepest split of the contraction (8 blocks)
DX_SCALES = [2.0, 1.5]
DX_CASES = [(m, k, n, 8) for m in (1, 17, 65, 192, 256)
            for k, n in ((896, 896), (896, 128), (896, 4864), (4864, 896),
                         (2048, 2048))] + [
    (50, 97, 131, 8), (37, 33, 129, 16), (130, 301, 70, 32),
    (65, 4863, 128, 3)]


def _dx_inputs(seed, M, K, N, r, method, dtype=torch.bfloat16):
    """g, the codes and scale of W0 [K, N] in ``method``'s format (made on
    the card), a and b (B drawn as the other card checks draw it) for the
    dx of ``method``."""
    _, w, a, b, g = (torch.from_numpy(t) for t in _op_inputs(
        seed, M, K, N, r, method))
    leaf = tq.quantize_leaf(w.cuda(), method)
    g, a, b = (t.to(dtype).cuda() for t in (g, a, b * 3))
    return g, leaf["q" if method == "int8" else "q4"], leaf["scale"], a, b


@pytest.mark.cuda
@pytest.mark.parametrize("scale", DX_SCALES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,r", DX_CASES)
def test_quantized_dx_bf16_matches_plain_on_card(M, K, N, r, method, scale):
    """The bf16 dx over codes on tensor cores, dh summed in its own loop,
    against its plain version: the dense LoRA kernels' bf16 tolerance."""
    _need_card()
    g, q, s, a, b = _dx_inputs(21, M, K, N, r, method)
    _, dx_fn, _, dx_ref, _ = _card_pair(method)
    name = "lora_dx_q" if method == "int8" else "lora_dx_q4"
    before = tops.launch_counts()[name]
    dx = dx_fn(g, q, s, a, b, scale)
    torch.cuda.synchronize()
    assert tops.launch_counts()[name] == before + 1
    assert dx.dtype == torch.bfloat16 and dx.shape == (M, K)
    _assert_close_scaled(dx, dx_ref(g, q, s, a, b, scale),
                         dict(rtol=2.0 ** -6, atol=1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N", [(256, 896, 4864), (256, 896, 128),
                                   (65, 4863, 128), (50, 97, 131)])
def test_quantized_dx_bf16_is_bitwise_on_repeat(M, K, N, method):
    """Two launches of the bf16 dx over codes give the same bits, at s 2
    and 1.5; the split of N is 8 blocks at K 896 from N 4864."""
    _need_card()
    g, q, s, a, b = _dx_inputs(22, M, K, N, 8, method)
    dx_fn = _card_pair(method)[1]
    for scale in DX_SCALES:
        dx = dx_fn(g, q, s, a, b, scale)
        assert torch.equal(dx_fn(g, q, s, a, b, scale), dx)
    plan = tlf.dx_plan(M, K, N, method)
    assert 1 <= plan["split"] <= 8 and plan["smem_bytes"] > 0
    if (M, K, N) == (256, 896, 4864):
        assert plan["split"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_quantized_dx_bf16_dispatches_no_operator(method):
    """A bf16 dx call over codes launches its kernel once and dispatches no
    PyTorch operator but the output's allocation: dh is summed in the
    kernel (``test_torch_kernels.test_lora_dx_bf16_is_one_device_kernel``
    counts the device kernels under the profiler)."""
    _need_card()
    args = _dx_inputs(23, 256, 4864, 896, 8, method)
    dx_fn = _card_pair(method)[1]
    name = "lora_dx_q" if method == "int8" else "lora_dx_q4"
    dx_fn(*args, 2.0)
    before = tops.launch_counts()[name]
    with _Ops() as ops:
        dx_fn(*args, 2.0)
    assert tops.launch_counts()[name] == before + 1
    assert all(o.startswith("aten.empty") for o in ops.names), ops.names


class _Ops(TorchDispatchMode):
    """The PyTorch operators dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


# SHA-256 of the f32 dx over codes (lora_gemm.cuh's CUDA-core body) on
# _dx_inputs(24, M, K, N, 8, method, f32) at s 2, by (method, M, K, N): the
# bits it had before the bf16 dx moved to tensor cores
DX_F32_SHA256 = {
    ("int8", 256, 896, 896):
        "f4a7b72b79cbb9c5e33e4bafec010692931e964d21ce77728407df1954f91cf4",
    ("int8", 50, 97, 131):
        "8ac9c724c21f5e2ed94ba8bb7efe56600bfd7dfe35f5b7ab1cc1e2f97c8358c9",
    ("int8", 65, 4863, 128):
        "319fe055d2204728cc7a537f4dab7e502bb3862fcdbf6fdc1fe36574018a9efb",
    ("int4", 256, 896, 896):
        "9458257ae7d608073e20d5a9868f6961fca948d51ebfebd9dd5065bb06fc9b9b",
    ("int4", 50, 97, 131):
        "858ed972ec871b8d80ee1aae5a66a750675898701921b178a841555caa1ed76d",
    ("int4", 65, 4863, 128):
        "3108b0d2ff76e1e3d5a3de32e331c17f6bd8cf6297ecebecdbe163e9c368cdf1",
    ("nf4", 256, 896, 896):
        "66fb1bc41fe2e0282685209b6e223e299542732ed674258271c56fe7f85e4fd6",
    ("nf4", 50, 97, 131):
        "0cd8907a7a1ac728c1577cf47b15e6a8e625e12b1a7d964bb715e46d6e046a16",
    ("nf4", 65, 4863, 128):
        "88c060d4a7d624501a9110e870cff18c542560f721d3a864fe894559ab16dc58",
}


@pytest.mark.cuda
@pytest.mark.parametrize("method,M,K,N", list(DX_F32_SHA256))
def test_quantized_dx_f32_bits_are_unchanged(method, M, K, N):
    _need_card()
    args = _dx_inputs(24, M, K, N, 8, method, torch.float32)
    dx = _card_pair(method)[1](*args, 2.0)
    got = hashlib.sha256(dx.cpu().numpy().tobytes()).hexdigest()
    assert got == DX_F32_SHA256[(method, M, K, N)]


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_quantized_linear_runs_the_kernels_on_card(method):
    """``ops.lora_linear`` on a quantized leaf, forward and backward: the
    quantized forward and dx kernels and ``lora_dab``, once each, none of
    the dense LoRA kernels."""
    _need_card()
    x, w, a, b, g = (torch.from_numpy(t).cuda() for t in _op_inputs(
        15, 64, 160, 200, 8, method))
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w.cpu(),
                                                     method).items()}
    x.requires_grad_(True)
    a.requires_grad_(True)
    tops.reset_launch_counts()
    y = tops.lora_linear(x, leaf, a, b, None, 2.0)
    torch.autograd.grad(y, (x, a), g)
    torch.cuda.synchronize()
    fwd, dx = ("lora_fused_q", "lora_dx_q") if method == "int8" else \
        ("lora_fused_q4", "lora_dx_q4")
    counts = tops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {fwd: 1, dx: 1,
                                                      "lora_dab": 1}


@pytest.mark.cuda
def test_quantized_kernels_reject_bad_input():
    _need_card()
    x, w, a, b, g = (torch.from_numpy(t) for t in _op_inputs(
        16, 8, 33, 40, 4, "int8"))
    q8 = {k: v.cuda() for k, v in tq.quantize_leaf(w, "int8").items()}
    q4 = {k: v.cuda() for k, v in tq.quantize_leaf(w, "nf4").items()}
    x, a, b, g = (t.cuda() for t in (x, a, b, g))
    with pytest.raises(TypeError, match="int8"):
        tlq.lora_fused_q(x, q8["q"].to(torch.uint8), q8["scale"], a, b)
    with pytest.raises(ValueError, match="shape"):
        tlq.lora_dx_q(g, q8["q"], q8["scale"][:, :39].contiguous(), a, b)
    with pytest.raises(ValueError, match="shape"):   # q4 of another K
        tlp4.lora_fused_q4(x[:, :31].contiguous(), q4["q4"], q4["scale"],
                           a[:31].contiguous(), b, method="nf4")
    with pytest.raises(ValueError, match="packed method"):
        tlp4.lora_dx_q4(g, q4["q4"], q4["scale"], a, b, method="fp4")
    with pytest.raises(TypeError, match="expected"):
        tlp4.lora_dx_q4(g.bfloat16(), q4["q4"], q4["scale"], a, b,
                        method="nf4")
