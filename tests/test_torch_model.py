"""The port's dense model against the JAX reference on the reduced
qwen2.5-0.5b config (f32).

Parameters come from the reference's ``init_params(PRNGKey(0))`` with JAX
``synthetic_adapters`` stacked into its ``AdapterStore``, bridged to the
port through numpy, so both packages run the same weights. Logits and caches
agree at rtol = atol = 1e-5 (summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.policy import ExecutionPolicy as JaxPolicy
from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import AdapterStore as JaxStore
from repro.serve import synthetic_adapters as jax_adapters
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.core import structured as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

JCFG = jax_config("qwen2.5-0.5b").reduced()
TCFG = get_config("qwen2.5-0.5b").reduced()
TOL = dict(rtol=1e-5, atol=1e-5)
B, MAX_LEN, STEPS = 4, 16, 6
LENS = np.array([0, 3, 1, 2], np.int32)     # every slot at its own position
GID = np.array([2, 0], np.int32)            # tile 2; store slot 1 unused


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    params = JM.init_params(jax.random.PRNGKey(0), JCFG)
    store = JaxStore(params, capacity=3)
    for i in range(3):
        store.acquire(f"u{i}", jax_adapters(params, i))
    return store.params


def test_config_copy_matches_reference():
    for name in ("qwen2.5-0.5b", "qwen2.5-1.5b", "qwen2.5-3b"):
        j, t = jax_config(name), get_config(name)
        for cfg_j, cfg_t in ((j, t), (j.reduced(), t.reduced())):
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab", "resolved_head_dim", "qkv_bias",
                      "tie_embeddings", "rope_theta", "norm_eps", "dtype"):
                assert getattr(cfg_j, f) == getattr(cfg_t, f), (name, f)
            assert cfg_j.lora.rank == cfg_t.lora.rank
            assert cfg_j.lora.scale == cfg_t.lora.scale
            assert cfg_j.lora.targets == cfg_t.lora.targets


def test_init_params_same_tree_and_scales_as_reference():
    jp = _np(JM.init_params(jax.random.PRNGKey(0), JCFG))
    tp = bridge.to_numpy_tree(
        TM.init_params(TCFG, generator=torch.Generator().manual_seed(0)))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert {jax.tree_util.keystr(k): v.shape for k, v in jflat.items()} == \
        {jax.tree_util.keystr(k): v.shape for k, v in tflat.items()}
    for k, j in jflat.items():
        t = tflat[k]
        if np.all(j == j.flat[0]):           # ones / zeros leaves: exact
            np.testing.assert_array_equal(t, j)
        else:                                # random leaves: same scale
            assert 0.8 < t.std() / j.std() < 1.25, jax.tree_util.keystr(k)
    mask = TM.trainable_mask(tp)
    assert mask["blocks"]["attn"]["q"] == {"w": False, "bias": False,
                                           "a": True, "b": True}
    assert mask["embed"]["tok"] is False


def test_bridge_keeps_stacked_and_quantized_leaves(jparams):
    """Stacked leaves come through unchanged, and so do quantized leaves."""
    tp = bridge.from_numpy_tree(_np(jparams))
    a = tp["blocks"]["attn"]["q"]["a"]
    assert a.shape == (JCFG.n_layers, 3, JCFG.d_model, JCFG.lora.rank)
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(jparams["blocks"]["attn"]["q"]["a"]))
    bf = bridge.from_numpy_tree(
        {"w": np.asarray(jnp.ones((2, 3), jnp.bfloat16))})
    assert bf["w"].dtype == torch.bfloat16
    half = bridge.from_numpy_tree({"w": np.ones((2, 2), np.float32)},
                                  dtype=torch.float16)
    assert half["w"].dtype == torch.float16
    # quantized leaves now come through (tests/test_torch_quant.py holds
    # their bytes): the codes keep their dtype and the scale stays f32
    # under a cast
    ql = bridge.from_numpy_tree({"w": {"q": np.zeros((2, 2), np.int8),
                                       "scale": np.ones((1, 2), np.float32)}},
                                dtype=torch.bfloat16)
    assert ql["w"]["q"].dtype == torch.int8
    assert ql["w"]["scale"].dtype == torch.float32


def test_rope_per_slot_positions_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    pos = np.array([[5, 6], [0, 1], [17, 18]], np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cache_write_vector_lengths_match_reference():
    rng = np.random.default_rng(1)
    c = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    u = rng.standard_normal((3, 2, 1, 4)).astype(np.float32)
    ln = np.array([0, 7, 3], np.int32)
    want = JL._cache_write(jnp.asarray(c), jnp.asarray(u), jnp.asarray(ln))
    got = TL._cache_write(torch.from_numpy(c.copy()), torch.from_numpy(u),
                          torch.from_numpy(ln))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sdpa_per_row_offsets_match_reference():
    from repro.core import structured as JS
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    off = np.array([0, 5, 7], np.int32)
    want = JS.sdpa(*map(jnp.asarray, (q, k, v)), 0, True, jnp.asarray(off),
                   jnp.asarray(off + 1))
    got = TS.sdpa(*map(torch.from_numpy, (q, k, v)), 0, True,
                  torch.from_numpy(off), torch.from_numpy(off + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_run(params, policy, steps, toks):
    cache = JM.init_cache(JCFG, B, MAX_LEN, per_slot=True)
    cache["blocks"]["len"] = jnp.broadcast_to(jnp.asarray(LENS),
                                              (JCFG.n_layers, B))
    step = jax.jit(lambda p, c, t, g: JM.decode_step(
        p, JCFG, c, t, policy=policy, adapter_tiles=g))
    out = []
    for s in range(steps):
        logits, cache = step(params, cache, jnp.asarray(toks[s]),
                             jnp.asarray(GID))
        out.append(np.asarray(logits))
    return out, _np(cache)


def _torch_run(params, policy, steps, toks):
    cache = TM.init_cache(TCFG, B, MAX_LEN)
    cache["blocks"]["len"][:] = torch.from_numpy(LENS)
    out = []
    for s in range(steps):
        logits, cache = TM.decode_step(params, TCFG, cache,
                                       torch.from_numpy(toks[s]).long(),
                                       policy=policy,
                                       adapter_tiles=torch.from_numpy(GID))
        assert logits.shape == (B, 1, TCFG.vocab)
        assert logits.dtype == torch.float32
        out.append(logits.numpy().copy())
    return out, bridge.to_numpy_tree(cache)


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(3)
    return rng.integers(0, JCFG.vocab, (STEPS, B, 1)).astype(np.int32)


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_decode_step_matches_reference(jparams, tokens, backend):
    """6 per-slot decode steps: the port (structured forwards, or the cuda
    backend's plain versions on the CPU) against the JAX structured step."""
    tparams = bridge.from_numpy_tree(_np(jparams))
    want, jcache = _jax_run(jparams, JaxPolicy(), STEPS, tokens)
    got, tcache = _torch_run(tparams, ExecutionPolicy(backend=backend),
                             STEPS, tokens)
    for s in range(STEPS):
        np.testing.assert_allclose(got[s], want[s], err_msg=f"step {s}",
                                   **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache["blocks"][key],
                                   jcache["blocks"][key], **TOL)
    np.testing.assert_array_equal(tcache["blocks"]["len"],
                                  jcache["blocks"]["len"])


def test_decode_step_cuda_backend_matches_pallas_interpret(jparams, tokens):
    """The first 2 steps through the reference's Pallas kernels (interpret
    mode) against the port's cuda backend (plain versions on the CPU)."""
    tparams = bridge.from_numpy_tree(_np(jparams))
    want, _ = _jax_run(jparams, JaxPolicy(backend="pallas", interpret=True),
                       2, tokens)
    got, _ = _torch_run(tparams, ExecutionPolicy(backend="cuda"), 2, tokens)
    for s in range(2):
        np.testing.assert_allclose(got[s], want[s], err_msg=f"step {s}",
                                   **TOL)


def test_stacked_adapters_need_routing(jparams):
    tparams = bridge.from_numpy_tree(_np(jparams))
    lin = tparams["blocks"]["attn"]["q"]
    one = {k: v[0] for k, v in lin.items()}
    with pytest.raises(ValueError, match="adapter_tiles"):
        TL.apply_linear(one, torch.zeros(4, 1, TCFG.d_model), TCFG)
    with pytest.raises(ValueError, match="decode-only"):
        TL.apply_linear(one, torch.zeros(4, 2, TCFG.d_model), TCFG,
                        adapter_tiles=torch.zeros(2, dtype=torch.int32))
