"""The port's serving path over a quantized frozen base (``--quantize
int8|int4|nf4``) against the JAX reference (f32, CPU).

1. Kernels: the plain versions of ``lora_grouped_q`` / ``lora_grouped_q4``
   (what the wrappers run on the CPU) against the reference's Pallas
   kernels in interpret mode, given ``w0[None]`` as
   ``quant.add_group_axis`` makes it, at the JAX suite's 1e-5: odd K,
   ragged N, several tiles, repeated slots.
2. Dispatch: ``ops.lora_grouped_decode`` under ``structured`` and ``cuda``
   (plain versions here) against the reference's under ``policy=None`` and
   ``pallas``, over the routing vectors of ``tests/test_grouped.py``.
3. Batcher: token streams and serve.* / store.* / pages.* counters equal to
   the reference's over each quantized base, under both backends, with and
   without a memory budget that forces headroom rejections; no kernel
   launches on the CPU. The accounting behind the budget equals
   ``benchmarks/memsim.serve_residency``.
4. No dense W0 on the kernel path: a ``TorchDispatchMode`` records every
   floating tensor made during a ``cuda`` decode step, the two grouped
   quantized wrappers masked (their plain versions dequantize by nature):
   none has a W0 shape, while under ``structured`` they appear.
5. The store and the CLI over a quantized base.

The tests marked ``cuda`` hold the two CUDA kernels against their plain
versions on a card and skip without one. JAX is imported only inside the
parity fixtures, so the card tests run where JAX is not installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant as tq
from repro_torch.kernels import lora_grouped as tlg
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import (AdapterStore, ContinuousBatcher, Request,
                               synthetic_adapters)
from repro_torch.serve import residency

METHODS = ("int8", "int4", "nf4")
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = get_config("qwen2.5-0.5b").reduced()


@pytest.fixture(scope="module")
def jx():
    """The reference's modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from benchmarks import memsim
    from repro.api.policy import ExecutionPolicy as JaxPolicy
    from repro.configs import get_config as jax_config
    from repro.core import quant as jquant
    from repro.kernels import lora_grouped as jlg
    from repro.kernels import ops as jops
    from repro.models import model as JM
    from repro.serve import AdapterStore as JaxStore
    from repro.serve import ContinuousBatcher as JaxBatcher
    from repro.serve import Request as JaxRequest
    from repro.serve import synthetic_adapters as jax_adapters
    return SimpleNamespace(
        jax=jax, jnp=jnp, memsim=memsim, Policy=JaxPolicy, config=jax_config,
        quant=jquant, lg=jlg, ops=jops, M=JM, Store=JaxStore,
        Batcher=JaxBatcher, Request=JaxRequest, adapters=jax_adapters)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


# ------------------------------------------------------------------ kernels


def _grouped_inputs(seed, M, K, N, R, r, gid):
    """x [M,K], W0 [K,N] (per-column magnitudes over two decades), a
    [R,K,r], b [R,r,N] nonzero, gid int32, bias [N]."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = f(K, N) * K ** -0.5 * np.exp(f(1, N))
    return (f(M, K) * 0.5, w.astype(np.float32), f(R, K, r) * r ** -0.5,
            f(R, r, N) * 0.3, np.asarray(gid, np.int32), f(N))


# (M, K, N, R, r, bm, gid): several tiles with a slot unused, decode tiles
# of 2, odd K with ragged N, rank 16 with repeated non-contiguous slots
GROUPED_CASES = [
    (32, 72, 40, 3, 4, 8, [2, 0, 2, 2]),
    (8, 72, 40, 3, 8, 2, [1, 1, 0, 1]),
    (6, 33, 129, 3, 8, 3, [0, 0]),
    (16, 97, 131, 4, 16, 2, [3, 1, 3, 0, 1, 1, 3, 2]),
]


def _jax_leaf(jx, w, method):
    return jx.quant.quantize_leaf(jx.jnp.asarray(w), method)


@pytest.mark.parametrize("M,K,N,R,r,bm,gid", GROUPED_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_grouped_quant_plain_matches_pallas_kernel(jx, method, M, K, N, R, r,
                                                   bm, gid):
    jnp = jx.jnp
    x, w, a, b, g, _ = _grouped_inputs(0, M, K, N, R, r, gid)
    jleaf = _jax_leaf(jx, w, method)
    ge = jx.quant.add_group_axis(jleaf)
    ja, jb, jg = jnp.asarray(a), jnp.asarray(b), jnp.asarray(g)
    leaf = bridge.from_numpy_tree(_np(jleaf))
    tx, ta, tb, tg = _t(x, a, b, g)
    tops.reset_launch_counts()
    if method == "int8":
        want = jx.lg.lora_grouped_q(jnp.asarray(x), ge["q"], ge["scale"], ja,
                                    jb, jg, 2.0, bm=bm, interpret=True)
        got = tlg.lora_grouped_q(tx, leaf["q"], leaf["scale"], ta, tb, tg,
                                 2.0, bm=bm)
    else:
        want = jx.lg.lora_grouped_q4(jnp.asarray(x), ge["q4"], ge["scale"],
                                     ja, jb, jg, 2.0, method=method, bm=bm,
                                     interpret=True)
        got = tlg.lora_grouped_q4(tx, leaf["q4"], leaf["scale"], ta, tb, tg,
                                  2.0, bm=bm, method=method)
    assert set(tops.launch_counts().values()) == {0}   # CPU: plain versions
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_grouped_quant_plain_is_the_dequantized_product(method):
    """In f32 each plain version is the float plain version over the
    dequantized W0, up to where the scale is applied; a gid outside [0, R)
    gives NaN rows in every plain version, as in the kernels."""
    x, w, a, b, g, _ = _t(*_grouped_inputs(1, 12, 33, 70, 3, 4,
                                           [2, 0, 9, 1, -1, 1]))
    leaf = tq.quantize_leaf(w, method)
    wd = tq.maybe_dequant(leaf, torch.float32)
    if method == "int8":
        got = tlg.lora_grouped_q_ref(x, leaf["q"], leaf["scale"], a, b, g,
                                     bm=2)
    else:
        got = tlg.lora_grouped_q4_ref(x, leaf["q4"], leaf["scale"], a, b, g,
                                      bm=2, method=method)
    want = tlg.lora_grouped_ref(x, wd, a, b, g, bm=2)
    bad = torch.tensor([False] * 4 + [True] * 2 + [False] * 2 + [True] * 2
                       + [False] * 2)
    assert torch.isnan(got[bad]).all() and torch.isnan(want[bad]).all()
    torch.testing.assert_close(got[~bad], want[~bad], rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- dispatch


@pytest.mark.parametrize("K,N", [(72, 88), (33, 129)])
@pytest.mark.parametrize("backend", ["structured", "cuda"])
@pytest.mark.parametrize("method", METHODS)
def test_grouped_decode_over_quantized_base_matches_reference(
        jx, method, backend, K, N):
    """The routing vectors of ``tests/test_grouped.py``'s decode test
    (repeated and non-contiguous slots, one slot for all), with a bias."""
    jnp = jx.jnp
    Rslots, bm, Mrows, r = 5, 8, 48, 6
    x, w, a, b, _, bias = _grouped_inputs(2, Mrows, K, N, Rslots, r, [0])
    jleaf = _jax_leaf(jx, w, method)
    leaf = bridge.from_numpy_tree(_np(jleaf))
    jpol = (jx.Policy(backend="pallas", interpret=True) if backend == "cuda"
            else None)
    tpol = ExecutionPolicy(backend=backend, quantize=method)
    tops.reset_launch_counts()
    for gid in ([3, 3, 0, 4, 1, 2], [0, 0, 0, 0, 0, 0], [4, 2, 4, 2, 4, 2]):
        g = np.asarray(gid, np.int32)
        want = jx.ops.lora_grouped_decode(
            jnp.asarray(x), jleaf, jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(g), jnp.asarray(bias), 2.0, bm=bm, policy=jpol)
        got = tops.lora_grouped_decode(*_t(x), leaf, *_t(a, b, g),
                                       torch.from_numpy(bias), 2.0, bm=bm,
                                       policy=tpol)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(tops.launch_counts().values()) == {0}


# ------------------------------------------------------------------ batcher


def _reqs(cls, n, n_tenants, prompt_len=3, max_new=5):
    return [cls(f"r{i}", f"u{i % n_tenants}",
                tuple(1 + (2 * i + j) % 89 for j in range(prompt_len)),
                max_new) for i in range(n)]


@pytest.fixture(scope="module")
def jparams(jx):
    """{method: the reference's reduced qwen2.5 params over that base}."""
    return {m: jx.M.init_params(jx.jax.random.PRNGKey(0),
                                jx.config("qwen2.5-0.5b").reduced(),
                                quantize=m) for m in METHODS}


def _run_pair(jx, jp, method, backend, budget=None):
    """The reference's batcher and the port's over the same bridged params
    and JAX-drawn adapters, on the same requests. Returns (want, got, jbat,
    tbat)."""
    jcfg = jx.config("qwen2.5-0.5b").reduced()
    tparams = bridge.from_numpy_tree(_np(jp))
    kw = dict(slots=8, tile=2, max_len=32, page_size=8, mem_budget_mb=budget)
    jbat = jx.Batcher(jcfg, jx.Store(jp, capacity=3),
                      weights_fmt=jx.quant.weights_format(method), **kw)
    tbat = ContinuousBatcher(
        CFG, AdapterStore(tparams, capacity=3),
        policy=ExecutionPolicy(backend=backend, quantize=method), **kw)
    for i in range(4):
        ad = jx.adapters(jp, i)
        jbat.register_adapter(f"u{i}", ad)
        tbat.register_adapter(f"u{i}", bridge.from_numpy_tree(_np(ad)))
    want = jbat.run(_reqs(jx.Request, 8, 4))
    tops.reset_launch_counts()
    got = tbat.run(_reqs(Request, 8, 4))
    assert set(tops.launch_counts().values()) == {0}
    return want, got, jbat, tbat


@pytest.mark.parametrize("backend", ["structured", "cuda"])
@pytest.mark.parametrize("method", METHODS)
def test_batcher_over_quantized_base_matches_reference(jx, jparams, method,
                                                       backend):
    want, got, jbat, tbat = _run_pair(jx, jparams[method], method, backend)
    assert got == want
    assert tbat.metrics() == jbat.metrics()
    assert tbat.metrics()["store.evictions"] >= 1      # 4 tenants, 3 slots
    assert tbat.metrics()["serve.rejected_headroom"] == 0


def _budget(fmt, slots=8, page_size=8):
    """A budget that holds the base, a full store of three adapters and the
    pages of two 8-token requests: a third concurrent request is turned
    away."""
    pages = 2 * -(-8 // page_size)
    return residency.serve_residency(
        CFG, rank=CFG.lora.rank, resident_adapters=3, kv_pages=pages,
        page_size=page_size, batch=slots, weights_fmt=fmt)["total_mb"]


@pytest.mark.parametrize("method,backend", [("int8", "cuda"),
                                            ("int4", "structured"),
                                            ("nf4", "cuda")])
def test_headroom_gate_matches_reference(jx, jparams, method, backend):
    """A ``mem_budget_mb`` that forces headroom rejections: the same tokens
    and counters as the reference's gate, and every request served."""
    budget = _budget(tq.weights_format(method))
    want, got, jbat, tbat = _run_pair(jx, jparams[method], method, backend,
                                      budget)
    assert got == want and len(got) == 8
    assert tbat.metrics() == jbat.metrics()
    assert tbat.metrics()["serve.rejected_headroom"] > 0


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4", "nf4"])
@pytest.mark.parametrize("reduced", [False, True])
def test_serve_residency_matches_memsim(jx, fmt, reduced):
    cfg, jcfg = get_config("qwen2.5-0.5b"), jx.config("qwen2.5-0.5b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for kw in (dict(rank=8, resident_adapters=4, kv_pages=16, page_size=16,
                    batch=8),
               dict(rank=4, resident_adapters=0, kv_pages=3, page_size=8)):
        got = residency.serve_residency(cfg, weights_fmt=fmt, **kw)
        want = jx.memsim.serve_residency(jcfg, weights_fmt=fmt, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert residency.resident_weight_mb(cfg, fmt) == pytest.approx(
        jx.memsim.resident_weight_mb(jcfg, fmt), rel=1e-12)
    name = "qwen2.5-0.5b"
    if not reduced:     # the registry name resolves as in the reference
        assert residency.serve_residency(
            name, rank=8, resident_adapters=1, kv_pages=1, page_size=16,
            weights_fmt=fmt) == pytest.approx(jx.memsim.serve_residency(
                name, rank=8, resident_adapters=1, kv_pages=1, page_size=16,
                weights_fmt=fmt))


def test_weights_format_matches_reference(jx):
    for m in (None, "none", "int8", "int4", "nf4"):
        assert tq.weights_format(m) == jx.quant.weights_format(m)
    with pytest.raises(ValueError, match="unknown quantize"):
        tq.weights_format("fp8")
    with pytest.raises(ValueError, match="unknown weights format"):
        residency.resident_weight_mb(CFG, "fp8")


# ------------------------------------------------- no dense W0 on the path

#: a config whose W0 shapes no decode activation has (slots 4, max_len 16)
_FIELDS = dict(name="serve-quant-test", family="dense", n_layers=2,
               d_model=160, n_heads=4, n_kv_heads=2, d_ff=192, vocab=97,
               qkv_bias=True, tie_embeddings=True, dtype="float32")
QCFG = ArchConfig(**_FIELDS)


def _w0_shapes():
    d, f = QCFG.d_model, QCFG.d_ff
    kn = {(d, QCFG.q_size), (d, QCFG.kv_size), (QCFG.q_size, d), (d, f),
          (f, d)}
    return kn | {(n, k) for k, n in kn}


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


def _decode_shapes(monkeypatch, backend, method):
    """Shapes of the float tensors made during two decode steps of a
    batcher over a ``method`` base, the grouped quantized wrappers
    masked."""
    mode = _FloatOutputs()

    def paused(fn):
        def call(*args, **kw):
            mode.paused += 1
            try:
                return fn(*args, **kw)
            finally:
                mode.paused -= 1
        return call

    for name in ("lora_grouped_q", "lora_grouped_q4"):
        monkeypatch.setattr(tlg, name, paused(getattr(tlg, name)))
    params = TM.init_params(QCFG, generator=torch.Generator().manual_seed(0),
                            quantize=method)
    bat = ContinuousBatcher(
        QCFG, AdapterStore(params, capacity=2), slots=4, tile=2, max_len=16,
        page_size=8, policy=ExecutionPolicy(backend=backend,
                                            quantize=method))
    for i in range(2):
        bat.register_adapter(f"u{i}", synthetic_adapters(params, i))
    for req in _reqs(Request, 3, 2, prompt_len=2, max_new=2):
        bat.submit(req)
    bat.step()                          # admission writes the store first
    with mode:
        bat.step()
        bat.step()
    return mode.shapes


@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_no_dense_w0_is_made_on_the_grouped_kernel_path(monkeypatch, method):
    made = _decode_shapes(monkeypatch, "cuda", method)
    assert [s for s in made if s[-2:] in _w0_shapes()] == []
    assert (4, 1, QCFG.vocab) in made        # the mode saw the decode step


@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_structured_decode_does_make_dense_w0(monkeypatch, method):
    """The same check bites: the structured backend dequantizes every
    linear's W0 in every step."""
    made = _decode_shapes(monkeypatch, "structured", method)
    d, f = QCFG.d_model, QCFG.d_ff
    assert {(d, d), (d, QCFG.kv_size), (d, f), (f, d)} <= \
        {s[-2:] for s in made}


# ---------------------------------------------------------- store and CLI


@pytest.mark.parametrize("method", METHODS)
def test_init_params_quantizes_as_it_draws(method):
    """``init_params(quantize=)`` quantizes each W0 as it is drawn, one
    matrix at a time: the same bytes as quantizing the dense tree."""
    gen = lambda: torch.Generator().manual_seed(3)
    got = TM.init_params(CFG, generator=gen(), quantize=method)
    want = tq.quantize_params(TM.init_params(CFG, generator=gen()), method)

    def same(g, w, path):
        if isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                same(g[k], w[k], f"{path}/{k}")
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), path

    same(got, want, "")


@pytest.mark.parametrize("method", METHODS)
def test_store_takes_a_quantized_base_unchanged(method):
    """The store stacks only a/b: a quantized ``w`` leaf is the base's own
    dict of tensors, shared, and a decode step reads it through the
    store's tree."""
    params = TM.init_params(CFG, generator=torch.Generator().manual_seed(0),
                            quantize=method)
    store = AdapterStore(params, capacity=3)
    for blk, lin in (("attn", "q"), ("attn", "k"), ("mlp", "down")):
        got, base = store.params["blocks"][blk][lin], params["blocks"][blk][lin]
        assert got["w"].keys() == base["w"].keys()
        assert all(got["w"][k] is base["w"][k] for k in base["w"])
        assert got["a"].shape == (base["a"].shape[:-2] + (3,)
                                  + base["a"].shape[-2:])
        if "bias" in base:
            assert got["bias"] is base["bias"]
    assert tq.tree_method(store.params) == method
    assert store.slot_bytes == AdapterStore(
        TM.init_params(CFG, generator=torch.Generator().manual_seed(0)),
        capacity=3).slot_bytes


def test_serve_cli_quantized_on_cpu_serves_to_completion():
    argv = ["--device", "cpu", "--reduced", "--adapters", "3", "--batch",
            "4", "--tile", "2", "--requests", "5", "--prompt-len", "3",
            "--max-new", "4", "--max-len", "16", "--quantize", "nf4"]
    out = tserve.serve(argv)
    assert out["requests"] == 5 and out["tokens"] == 20
    assert out["weights_fmt"] == "nf4"
    assert tq.tree_method(out["params"]) == "nf4"
    dense = tserve.serve(argv[:-2])
    assert dense["weights_fmt"] == "bf16"
    # the seven linears' W0 at an eighth of f32's bytes, plus the scales
    assert out["base_bytes"] < dense["base_bytes"] / 4
    plain = tserve.serve(argv + ["--engine", "mesp"])
    assert plain["batcher"].results == out["batcher"].results
    budget = tserve.serve(argv + ["--mem-budget-mb", "1e6"])
    assert budget["batcher"].results == out["batcher"].results


def test_batcher_rejects_a_base_of_another_format():
    params = TM.init_params(CFG, generator=torch.Generator().manual_seed(0),
                            quantize="int8")
    with pytest.raises(ValueError, match="frozen base is 'int8'"):
        ContinuousBatcher(CFG, AdapterStore(params, 2),
                          policy=ExecutionPolicy(quantize="nf4"))
    with pytest.raises(ValueError, match="frozen base is 'int8'"):
        ContinuousBatcher(CFG, AdapterStore(params, 2))
    # the headroom gate charges the base in the format the batcher checked
    assert ContinuousBatcher(CFG, AdapterStore(params, 2),
                             policy=ExecutionPolicy(quantize="int8")
                             ).weights_fmt == "int8"
    with pytest.raises(SystemExit):
        tserve.build_arg_parser().parse_args(["--quantize", "fp8"])


# ------------------------------------------------------------- card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


def _card_call(method, x, leaf, a, b, g, bm, ref=False):
    if method == "int8":
        fn = tlg.lora_grouped_q_ref if ref else tlg.lora_grouped_q
        return fn(x, leaf["q"], leaf["scale"], a, b, g, 2.0, bm=bm)
    fn = tlg.lora_grouped_q4_ref if ref else tlg.lora_grouped_q4
    return fn(x, leaf["q4"], leaf["scale"], a, b, g, 2.0, bm=bm,
              method=method)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("M,K,N,R,r,bm,gid", GROUPED_CASES + [
    (8, 896, 896, 4, 8, 2, [3, 0, 3, 1]),
    (8, 896, 128, 4, 8, 2, [3, 0, 3, 1]),
    (8, 896, 4864, 4, 8, 2, [3, 0, 3, 1]),
    (8, 4864, 896, 4, 8, 2, [2, 2, 0, 1]),
    (24, 301, 130, 2, 16, 3, [1, 0, 0, 1, 1, 0, 1, 0]),
])
def test_grouped_quant_kernels_match_plain_on_card(M, K, N, R, r, bm, gid,
                                                   method, dtype):
    """f32: summation order only. bf16: one output rounding (2^-8
    relative), doubled where a rounding of h flips."""
    _need_card()
    dt = getattr(torch, dtype)
    x, w, a, b, g, _ = _t(*_grouped_inputs(5, M, K, N, R, r, gid))
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w, method).items()}
    x, a, b = (t.to(dt).cuda() for t in (x, a, b))
    g = g.cuda()
    name = "lora_grouped_q" if method == "int8" else "lora_grouped_q4"
    before = tops.launch_counts()[name]
    got = _card_call(method, x, leaf, a, b, g, bm)
    torch.cuda.synchronize()
    assert tops.launch_counts()[name] == before + 1
    want = _card_call(method, x, leaf, a, b, g, bm, ref=True)
    assert got.dtype == dt and got.shape == (M, N)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# the bf16 decode body (csrc/lora_grouped_decode_tc.cuh) over codes:
# (M, bm, K, N, R, r, gid). The decode shapes at M 8 in tiles of 2 and 4,
# two parts of 16 rows and more, M 24 in tiles of 3, and
# chip_smoke.GROUPED_Q_EDGES (odd K, ragged N, ranks 3 and 16, repeated
# slots, a bad gid)
DECODE_GID = [3, 0, 3, 1]
DECODE_CASES = {
    **{f"M8_bm{bm}_{K}x{N}": (8, bm, K, N, 4, 8, DECODE_GID[:8 // bm])
       for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896))
       for bm in (2, 4)},
    "M16": (16, 2, 896, 896, 4, 8, [3, 0, 3, 1, 2, 2, 0, 1]),
    "M24_bm3": (24, 3, 896, 4864, 4, 8, [1, 0, 0, 1, 1, 0, 1, 0]),
    "M32": (32, 2, 4864, 896, 4, 8, [i % 4 for i in range(16)]),
    "odd_k_ragged_n": (8, 2, 97, 131, 4, 8, DECODE_GID),
    "odd_k_wide": (8, 2, 4863, 896, 4, 8, DECODE_GID),
    "n130_rank3": (8, 2, 896, 130, 4, 3, [1, 2, 3, 0]),
    "rank16": (8, 2, 896, 896, 4, 16, DECODE_GID),
    "rows16": (16, 2, 896, 128, 4, 8, [3, 0, 3, 1, 2, 2, 0, 1]),
    "gid_repeated": (8, 2, 896, 4864, 4, 8, [2, 2, 0, 2]),
    "bad_gid": (8, 2, 896, 896, 4, 8, [3, 7, 0, -1]),
}


def _decode_bf16(method, case, seed):
    M, bm, K, N, R, r, gid = DECODE_CASES[case]
    x, w, a, b, g, _ = _t(*_grouped_inputs(seed, M, K, N, R, r, gid))
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w, method).items()}
    x, a, b = (t.to(torch.bfloat16).cuda() for t in (x, a, b))
    return x, leaf, a, b, g.cuda(), bm, R


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_grouped_decode_bf16_over_codes_matches_plain_on_card(case, method):
    """One launch of the tensor-core body over int8, int4 or nf4 codes,
    within chip_smoke.KERNEL_TOL's scheme of the plain version (the floor
    relative to the largest output); rows of a gid outside [0, R) NaN in
    both."""
    _need_card()
    x, leaf, a, b, g, bm, R = _decode_bf16(method, case, 9)
    name = "lora_grouped_q" if method == "int8" else "lora_grouped_q4"
    before = tops.launch_counts()[name]
    got = _card_call(method, x, leaf, a, b, g, bm)
    torch.cuda.synchronize()
    assert tops.launch_counts()[name] == before + 1
    want = _card_call(method, x, leaf, a, b, g, bm, ref=True)
    bad = torch.tensor([not 0 <= t < R for t in g.tolist()],
                       device="cuda").repeat_interleave(bm)
    for t in (got, want):
        assert torch.equal(torch.isnan(t).all(1), bad)
        assert torch.isfinite(t[~bad]).all()
    scale = max(1.0, float(want[~bad].float().abs().max()))
    torch.testing.assert_close(got[~bad].float(), want[~bad].float(),
                               rtol=2.0 ** -6, atol=1e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", ["M8_bm2_896x4864", "M8_bm2_4864x896",
                                  "M24_bm3", "odd_k_ragged_n"])
def test_grouped_decode_bf16_over_codes_is_bitwise_on_repeat(case, method):
    _need_card()
    x, leaf, a, b, g, bm, _ = _decode_bf16(method, case, 10)
    y1 = _card_call(method, x, leaf, a, b, g, bm)
    y2 = _card_call(method, x, leaf, a, b, g, bm)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))


@pytest.mark.cuda
def test_grouped_nf4_kernel_rounds_the_codebook_to_bf16():
    """With A = B = 0 the bf16 output must lie nearer the plain version
    (codebook rounded to bf16, as the reference's ``_unpack_tile``) than a
    product over the f32 codebook, which a kernel that skipped the rounding
    would match instead."""
    _need_card()
    M, K, N = 8, 896, 4864
    x, w, _, _, g, _ = _t(*_grouped_inputs(7, M, K, N, 4, 8, [3, 0, 3, 1]))
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w, "nf4").items()}
    x, g = x.to(torch.bfloat16).cuda(), g.cuda()
    a = torch.zeros(4, K, 8, dtype=torch.bfloat16, device="cuda")
    b = torch.zeros(4, 8, N, dtype=torch.bfloat16, device="cuda")
    got = _card_call("nf4", x, leaf, a, b, g, 2).float()
    rounded = _card_call("nf4", x, leaf, a, b, g, 2, ref=True).float()
    w32 = tlg.unpack_weights(leaf["q4"], "nf4", torch.float32, K)
    unrounded = ((x.float() @ w32) * leaf["scale"]).to(torch.bfloat16)
    d_rounded = (got - rounded).abs().mean()
    d_unrounded = (got - unrounded.float()).abs().mean()
    assert 4 * d_rounded < d_unrounded, (d_rounded, d_unrounded)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_grouped_quant_kernels_mark_bad_gid_and_reject_bad_input(method):
    _need_card()
    x, w, a, b, g, _ = (t.cuda() for t in _t(*_grouped_inputs(
        6, 4, 33, 40, 2, 4, [0, 5])))
    leaf = {k: v.cuda() for k, v in tq.quantize_leaf(w.cpu(),
                                                     method).items()}
    y = _card_call(method, x, leaf, a, b, g, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(y[:2]).all() and torch.isnan(y[2:]).all()
    with pytest.raises(TypeError, match="int32"):
        _card_call(method, x, leaf, a, b, g.long(), 2)
    with pytest.raises(ValueError, match="rank"):
        _card_call(method, x, leaf, torch.zeros(2, 33, 17, device="cuda"),
                   torch.zeros(2, 17, 40, device="cuda"), g, 2)
    with pytest.raises(ValueError, match="whole tiles"):
        _card_call(method, x, leaf, a, b, g, 3)
    with pytest.raises(ValueError, match="shape"):     # codes of another K
        _card_call(method, x[:, :30].contiguous(), leaf,
                   a[:, :30].contiguous(), b, g, 2)
    codes = "q" if method == "int8" else "q4"
    with pytest.raises(TypeError, match="expected"):
        _card_call(method, x, dict(leaf, **{codes: leaf[codes].to(
            torch.int16)}), a, b, g, 2)
    with pytest.raises(TypeError, match="expected"):     # scale not f32
        _card_call(method, x, dict(leaf, scale=leaf["scale"].double()), a,
                   b, g, 2)
    if method != "int8":
        with pytest.raises(ValueError, match="packed method"):
            tlg.lora_grouped_q4(x, leaf["q4"], leaf["scale"], a, b, g,
                                bm=2, method="fp4")
