"""The port's sliding-window layout (Gemma3's 5 local : 1 global pattern)
against the JAX reference, on the reduced gemma3-12b config (f32: window
8 on the local layer, then a global one; d 64, 4 heads over 2 KV heads of
16).

Weights are the reference's ``init_params(PRNGKey(0))`` with every LoRA B
redrawn from numpy (so dA and the h@B term are tested), bridged to the port
through numpy: the ``groups`` tree, leaves ``[n_groups, period, ...]``,
crosses unchanged. Sequences of 20 tokens, over twice the window, and 96
(where both packages' kernel backends run flash attention) make every
local layer's window mask keys. Logits agree at rtol = atol = 1e-5 and
each LoRA gradient leaf at relative L2 1e-5 (summation order only); the
decode through the per-slot ring cache equals the reference's decode step
at 1e-5 and the port's own forward at 1e-4. The plain flash functions at
head dim 256 are held against the reference's Pallas flash kernels in
interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.policy import ExecutionPolicy as JaxPolicy
from repro.configs import get_config as jax_config
from repro.core import mesp as jmesp
from repro.kernels import flash_attention as jfa
from repro.kernels import rope as jrope
from repro.models import model as JM
from repro.serve import AdapterStore as JaxStore
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import synthetic_adapters as jax_adapters
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.core import mesp
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rope as trope
from repro_torch.models import model as TM
from repro_torch.serve import AdapterStore, ContinuousBatcher, Request
from repro_torch.serve import loop as tloop

JCFG = jax_config("gemma3-12b").reduced()
TCFG = get_config("gemma3-12b").reduced()
TOL = dict(rtol=1e-5, atol=1e-5)
B, N, FLASH_N = 2, 20, 96
#: port engine -> (its backend, the reference backend it is held against)
ENGINES = {"mesp_cuda": ("cuda", "structured"),
           "mesp": ("structured", "structured"), "mebp": ("plain", "plain"),
           "store_h": ("store_h", "store_h")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _redraw_b(tree, rng):
    """Every LoRA B drawn at 0.02 (its size after fine-tuning from zero)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
                if k == "b" else _redraw_b(v, rng) for k, v in tree.items()}
    return tree


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


@pytest.fixture(scope="module")
def np_params():
    return _redraw_b(_np(JM.init_params(jax.random.PRNGKey(0), JCFG)),
                     np.random.default_rng(1))


def _batch(n):
    return next(tpipe.make_batch_iterator(TCFG.vocab, n, B, seed=3,
                                          n_tokens=4096))


def test_init_params_groups_tree_matches_reference(np_params):
    jp = np_params
    tp = bridge.to_numpy_tree(
        TM.init_params(TCFG, generator=torch.Generator().manual_seed(0)))
    shapes = lambda t: {k: v.shape for k, v in _leaves(t).items()}
    assert "groups" in tp and "blocks" not in tp
    assert shapes(tp) == shapes(jp)
    assert tp["groups"]["attn"]["q"]["a"].shape == (1, 2, 64, 4)


def test_forward_logits_match_reference(np_params):
    batch = _batch(N)
    want = np.asarray(JM.forward(jax.tree_util.tree_map(jnp.asarray,
                                                        np_params),
                                 JCFG, jnp.asarray(batch["tokens"])))
    tp = bridge.from_numpy_tree(np_params)
    for backend in ("structured", "cuda", "plain"):
        got = TM.forward(tp, TCFG, torch.from_numpy(batch["tokens"]).long(),
                         policy=ExecutionPolicy(backend=backend))
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   err_msg=backend, **TOL)


@pytest.fixture(scope="module")
def jax_grads(np_params):
    """{(backend, seq): (loss, {path: grad})} from the reference."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = {}
    for n, backends in ((N, {b for _, b in ENGINES.values()}),
                        (FLASH_N, {"structured"})):
        jb = {k: jnp.asarray(v) for k, v in _batch(n).items()}
        for backend in backends:
            pol = JaxPolicy(backend=backend)
            loss, grads = jax.jit(lambda p, b: jmesp.value_and_grad(
                p, JCFG, b, policy=pol))(jp, jb)
            out[backend, n] = (float(loss), {
                k: np.asarray(v) for k, v in _leaves(grads).items()
                if v is not None})
    return out


@pytest.mark.parametrize("engine,n", [(e, N) for e in ENGINES]
                         + [("mesp_cuda", FLASH_N)])
def test_lora_grads_match_reference(np_params, jax_grads, engine, n):
    """One value_and_grad per engine at 20 tokens, and for mesp_cuda at 96
    (its flash Function under the window), against the reference's backend
    of the same rules: mesp_cuda (the kernels' plain versions on the CPU)
    against its structured rules, which compute the same function (the
    reference's Pallas backend is held against those by its own tests)."""
    backend, jbackend = ENGINES[engine]
    wloss, wgrads = jax_grads[jbackend, n]
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(n).items()}
    loss, grads = mesp.value_and_grad(bridge.from_numpy_tree(np_params),
                                      TCFG, batch,
                                      policy=ExecutionPolicy(backend=backend))
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-5)
    got = {k: v.numpy() for k, v in _leaves(grads).items() if v is not None}
    assert got.keys() == wgrads.keys()
    assert all(k.startswith("/groups/") for k in got)
    for k, w in wgrads.items():
        assert _rel(got[k], w) < 1e-5, (k, _rel(got[k], w))


def test_mesp_seq_refuses_a_window_pattern(np_params):
    """As the reference does: its sequential step asserts a pattern-free
    dense config, and both engine builders raise."""
    import repro.api.engines  # noqa: F401  (registers the engines)
    import repro_torch.api.engines  # noqa: F401
    from repro.api import registry as jreg
    from repro_torch.api import registry as treg
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(N).items()}
    with pytest.raises(ValueError, match="window pattern"):
        mesp.sequential_train_step(bridge.from_numpy_tree(np_params), TCFG,
                                   batch, 1e-2)
    with pytest.raises(AssertionError):
        jmesp.sequential_train_step(
            jax.tree_util.tree_map(jnp.asarray, np_params), JCFG,
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 1e-2)
    spec = dataclasses.make_dataclass("Spec", ["optimizer", "lr"])("sgd", 0.1)
    for reg, cfg in ((treg, TCFG), (jreg, JCFG)):
        with pytest.raises(ValueError, match="non-patterned"):
            reg.get_engine("mesp_seq").build_step(spec, cfg, None, None)


# ------------------------------------------------------------------ decode

MAX_LEN, STEPS = 32, 22
LENS = np.array([0, 9], np.int32)   # slot 1 starts past the window


def test_init_cache_rings_local_layers_as_the_reference():
    jc = _np(JM.init_cache(JCFG, B, MAX_LEN, per_slot=True))
    tc = bridge.to_numpy_tree(TM.init_cache(TCFG, B, MAX_LEN))
    shapes = lambda t: {k: v.shape for k, v in _leaves(t).items()}
    assert shapes(tc) == shapes(jc)
    hd = TCFG.resolved_head_dim
    assert tc["groups"]["l0"]["k"].shape == (1, B, 2, 8, hd)       # ring
    assert tc["groups"]["l1"]["k"].shape == (1, B, 2, MAX_LEN, hd)  # linear


def test_cache_writes_match_reference_in_rings_and_past_the_end():
    """A ring of 8 slots takes each row's write at len % 8, as the
    reference's attention does; a linear cache clamps an offset past its
    end (a batcher's idle row) as the reference's dynamic_update_slice."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(5)
    c = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    u = rng.standard_normal((3, 2, 1, 4)).astype(np.float32)
    ln = np.array([0, 9, 30], np.int32)
    for ring, jln in ((0, ln), (8, ln % 8)):
        want = JL._cache_write(jnp.asarray(c), jnp.asarray(u),
                               jnp.asarray(jln))
        got = TL._cache_write(torch.from_numpy(c.copy()),
                              torch.from_numpy(u), torch.from_numpy(ln),
                              ring)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(4).integers(
        0, JCFG.vocab, (STEPS, B, 1)).astype(np.int32)


def test_ring_decode_matches_reference_per_slot(np_params, tokens):
    """22 per-slot decode steps, slot 1 starting at position 9: every ring
    wraps; logits and caches against the reference's decode step."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jc = JM.init_cache(JCFG, B, MAX_LEN, per_slot=True)
    for key in jc["groups"]:
        jc["groups"][key]["len"] = jnp.broadcast_to(jnp.asarray(LENS),
                                                    (1, B))
    step = jax.jit(lambda p, c, t: JM.decode_step(p, JCFG, c, t))
    tp = bridge.from_numpy_tree(np_params)
    tc = TM.init_cache(TCFG, B, MAX_LEN)
    for key in tc["groups"]:
        tc["groups"][key]["len"][:] = torch.from_numpy(LENS)
    for s in range(STEPS):
        want, jc = step(jp, jc, jnp.asarray(tokens[s]))
        got, tc = TM.decode_step(tp, TCFG, tc,
                                 torch.from_numpy(tokens[s]).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {s}", **TOL)
    jc, tc = _np(jc), bridge.to_numpy_tree(tc)
    for key, leaf in _leaves(jc).items():
        np.testing.assert_allclose(_leaves(tc)[key], leaf, err_msg=key, **TOL)


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_ring_decode_matches_forward(np_params, backend):
    """Decoding a sequence token by token through the ring caches gives the
    full forward's logits, past the window (tests/test_recurrences.py's
    check, on the port)."""
    tp = bridge.from_numpy_tree(np_params)
    toks = torch.from_numpy(_batch(N)["tokens"]).long()
    pol = ExecutionPolicy(backend=backend)
    want = TM.forward(tp, TCFG, toks, policy=pol).detach().numpy()
    cache = TM.init_cache(TCFG, B, N + 4)
    got = [TM.decode_step(tp, TCFG, cache, toks[:, t:t + 1], policy=pol)[0]
           for t in range(N)]
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, rtol=1e-4,
                               atol=1e-4)


def _reqs(cls, n, n_tenants, prompt_len=6, max_new=8):
    return [cls(f"r{i}", f"u{i % n_tenants}",
                tuple(1 + (2 * i + j) % 89 for j in range(prompt_len)),
                max_new) for i in range(n)]


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_batcher_matches_reference(backend):
    """The ContinuousBatcher over gemma3's ring caches: 14 tokens a request
    (past the window of 8), 8 requests, 4 tenants over 3 resident slots;
    tokens and counters equal the reference's."""
    jparams = JM.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = bridge.from_numpy_tree(_np(jparams))
    kw = dict(slots=4, tile=2, max_len=32, page_size=8)
    jbat = JaxBatcher(JCFG, JaxStore(jparams, capacity=3), **kw)
    tbat = ContinuousBatcher(TCFG, AdapterStore(tparams, capacity=3),
                             policy=ExecutionPolicy(backend=backend), **kw)
    for i in range(4):
        ad = jax_adapters(jparams, i)
        jbat.register_adapter(f"u{i}", ad)
        tbat.register_adapter(f"u{i}", bridge.from_numpy_tree(_np(ad)))
    want = jbat.run(_reqs(JaxRequest, 8, 4))
    tops.reset_launch_counts()
    got = tbat.run(_reqs(Request, 8, 4))
    assert got == want
    assert tbat.metrics() == jbat.metrics()
    assert set(tops.launch_counts().values()) == {0}


def test_reset_slot_zeroes_every_groups_leaf():
    cache = TM.init_cache(TCFG, B, MAX_LEN)
    for leaf in _leaves(cache).values():
        leaf.fill_(3)
    tloop._reset_slot(cache, 1)
    for key, leaf in _leaves(cache).items():
        assert leaf.shape[1] == B, key
        assert bool((leaf[:, 1] == 0).all()) and bool((leaf[:, 0] == 3).all())


# ---------------------------------------------------- flash at head dim 256

# (nq, nk, D, G, causal, window, rope): Gemma3's head dim under a window,
# a global layer with RoPE, and D 200 (the 256 instance, padded)
FLASH_CASES = {
    "d256-window48": (128, 128, 256, 2, True, 48, False),
    "d256-rope": (96, 96, 256, 2, True, 0, True),
    "d200-window48-rope": (128, 128, 200, 2, True, 48, True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_at_d256_matches_pallas_kernel(case):
    nq, nk, D, G, causal, window, rope = FLASH_CASES[case]
    rng = np.random.default_rng(30)
    f = lambda *s: (rng.standard_normal(s) * 0.7).astype(np.float32)
    q, k, v, g = f(2 * G, nq, D), f(2, nk, D), f(2, nk, D), f(2 * G, nq, D)
    kw = dict(causal=causal, window=window, q_per_kv=G)
    jt = jrope.rope_tables(jnp.arange(nq), 10000.0, D) if rope else None
    tt = trope.rope_tables(torch.arange(nq), 10000.0, D) if rope else None
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = jfa.flash_attention_fwd(jq, jk, jv, jt, return_lse=True,
                                         interpret=True, bq=64, bk=64, **kw)
    jgrads = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jg, jt,
                                     interpret=True, bq=64, bk=64, **kw)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, tt, return_lse=True, **kw)
    grads = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tg, tt, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
