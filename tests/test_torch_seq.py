"""The port's §4.3 sequential step (``mesp_seq``), the chunked flash path of
the structured backend (``core/flash.py``) and the engine registry, against
the JAX reference (f32, CPU).

The model is ``test_torch_train.py``'s (d_model 160, 4 heads over 2 KV
heads of 40, d_ff 192, vocab 97, qkv bias) at 3 layers, batch 2, seq 48,
with the reference's ``init_params(PRNGKey(0))`` bridged through numpy and
every LoRA B redrawn at 0.02 (at 0.1 the reference's own backends differ
by 1.8e-5). ``sequential_train_step`` is held against the reference's at
1e-5 and against the port's ``train_step`` (as
``test_mesp_equivalence.py`` pins the two in the reference). The chunked
flash Function is held against the reference's ``flash_attention`` at
1e-5 (out, dq, dk, dv): GQA, causal, a window, non-causal, N not a
multiple of the chunk (chunk 16), and through the model with
``flash_min_seq`` below N.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.policy import ExecutionPolicy as JaxPolicy
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import flash as jflash
from repro.core import mesp as jmesp
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api import registry
from repro_torch.api.engines import ENGINES
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import flash as tflash
from repro_torch.core import mesp
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM

_FIELDS = dict(name="seq-test", family="dense", n_layers=3, d_model=160,
               n_heads=4, n_kv_heads=2, d_ff=192, vocab=97, qkv_bias=True,
               tie_embeddings=True, dtype="float32")
JCFG = JaxArchConfig(**_FIELDS)
TCFG = ArchConfig(**_FIELDS)
BATCH, SEQ, LR = 2, 48, 5e-2
TOL = dict(rtol=1e-5, atol=1e-5)


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
    return {prefix: tree}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def np_params():
    p = jax.tree_util.tree_map(np.asarray,
                               JM.init_params(jax.random.PRNGKey(0), JCFG))
    return _redraw_b(p, np.random.default_rng(1))


@pytest.fixture(scope="module")
def np_batch():
    return next(tpipe.make_batch_iterator(TCFG.vocab, SEQ, BATCH, seed=3,
                                          n_tokens=4096))


def _tbatch(np_batch):
    return {k: torch.from_numpy(v).long() for k, v in np_batch.items()}


@pytest.fixture(scope="module")
def jax_seq(np_params, np_batch):
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    new, loss = jax.jit(lambda p, b: jmesp.sequential_train_step(
        p, JCFG, b, LR, policy=JaxPolicy(backend="structured")))(jp, jb)
    return float(loss), {k: np.asarray(v) for k, v in _leaves(new).items()}


# ------------------------------------------------------- sequential step


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_sequential_step_matches_reference(np_params, np_batch, jax_seq,
                                           backend):
    """``cuda`` runs each kernel's plain version on CPU tensors."""
    params = bridge.from_numpy_tree(np_params)
    before = {k: v.clone() for k, v in _leaves(params).items()}
    new, loss = mesp.sequential_train_step(
        params, TCFG, _tbatch(np_batch), LR,
        policy=ExecutionPolicy(backend=backend))
    jloss, jleaves = jax_seq
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    got = _leaves(new)
    assert got.keys() == jleaves.keys()
    mask = _leaves(TM.trainable_mask(params))
    for path, want in jleaves.items():
        t = got[path]
        assert not t.requires_grad, path
        if mask[path]:
            assert _rel(t.numpy(), want) < 1e-5, path
            assert not torch.equal(t, before[path]), path
        else:
            assert torch.equal(t, before[path]), path
    # the caller's params are left as they were
    for path, t in _leaves(params).items():
        assert torch.equal(t, before[path]), path


def test_sequential_step_equals_train_step(np_params, np_batch):
    """§4.3's immediate per-block SGD equals one SGD step over the whole
    gradient (the LoRA leaves of different blocks are disjoint)."""
    params = bridge.from_numpy_tree(np_params)
    batch = _tbatch(np_batch)
    p1, l1 = mesp.train_step(params, TCFG, batch, LR)
    p2, l2 = mesp.sequential_train_step(params, TCFG, batch, LR)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for path, u in _leaves(p1).items():
        np.testing.assert_allclose(_leaves(p2)[path].numpy(), u.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=path)


def test_sequential_step_refuses_moe_and_another_base():
    moe = get_config("olmoe-1b-7b").reduced()
    with pytest.raises(ValueError, match="dense"):
        mesp.sequential_train_step({}, moe, {}, LR)
    params = TM.init_params(TCFG, generator=torch.Generator().manual_seed(0),
                            quantize="int8")
    with pytest.raises(ValueError, match="int8"):
        mesp.sequential_train_step(params, TCFG, {}, LR)


# ---------------------------------------------------------- chunked flash

# (B, H, Hkv, Nq, Nk, D, window, causal, chunk)
FLASH_CASES = {
    "gqa_causal": (2, 4, 2, 64, 64, 16, 0, True, 16),
    "window": (1, 4, 2, 64, 64, 16, 24, True, 16),
    "non_causal": (1, 2, 1, 40, 56, 8, 0, False, 16),
    "ragged": (2, 6, 3, 50, 50, 12, 0, True, 16),
    "ragged_window": (1, 4, 1, 45, 45, 16, 20, True, 16),
    "one_chunk": (1, 2, 2, 30, 30, 8, 0, True, 64),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_chunked_flash_matches_reference(case):
    B, H, Hkv, Nq, Nk, D, window, causal, chunk = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, H, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Nk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Nk, D)).astype(np.float32)
    g = rng.standard_normal((B, H, Nq, D)).astype(np.float32)
    @jax.jit
    def ref(a, b, c, cot):
        out, vjp = jax.vjp(lambda *x: jflash.flash_attention(
            *x, window, causal, chunk, chunk), a, b, c)
        return out, vjp(cot)

    jout, jgrads = ref(*map(jnp.asarray, (q, k, v, g)))
    tin = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tout = tflash.flash_attention(*tin, window, causal, chunk, chunk)
    tgrads = torch.autograd.grad(tout, tin, torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_chunked_flash_saves_no_probabilities():
    """Residuals are q, k, v, out and lse: nothing of [Nq, Nk]."""
    q = torch.randn(1, 2, 64, 8, requires_grad=True)
    k = torch.randn(1, 1, 64, 8, requires_grad=True)
    v = torch.randn(1, 1, 64, 8, requires_grad=True)
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        tflash.flash_attention(q, k, v, 0, True, 16, 16)
    assert sorted(shapes) == sorted([(1, 2, 64, 8), (1, 1, 64, 8),
                                     (1, 1, 64, 8), (1, 1, 2, 64, 8),
                                     (1, 1, 2, 64)])


@pytest.mark.parametrize("backend", ["structured", "store_h"])
def test_model_takes_chunked_flash_from_flash_min_seq(np_params, np_batch,
                                                      backend):
    """At seq 48 with ``flash_min_seq`` 32 and chunk 16 both packages'
    structured backends take their chunked flash path: loss and LoRA
    gradients at 1e-5, and the same as the port's dense sdpa."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    jloss, jgrads = jax.jit(lambda p, b: jmesp.value_and_grad(
        p, JCFG, b, policy=JaxPolicy(backend=backend, flash_min_seq=32,
                                     flash_chunk=16)))(jp, jb)
    params, batch = bridge.from_numpy_tree(np_params), _tbatch(np_batch)
    calls = []
    orig = tflash._FlashAttention.apply
    tflash._FlashAttention.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        loss, grads = mesp.value_and_grad(
            params, TCFG, batch, policy=ExecutionPolicy(
                backend=backend, flash_min_seq=32, flash_chunk=16))
    finally:
        tflash._FlashAttention.apply = orig
    assert len(calls) == 2 * TCFG.n_layers   # forward and its recompute
    dense_loss, dense = mesp.value_and_grad(
        params, TCFG, batch, policy=ExecutionPolicy(backend=backend))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(loss), float(dense_loss), **TOL)
    got, want, ref = _leaves(grads), _leaves(jgrads), _leaves(dense)
    for path, w in want.items():
        if w is None:
            assert got[path] is None
            continue
        assert _rel(got[path].numpy(), np.asarray(w)) < 1e-5, path
        assert _rel(got[path].numpy(), ref[path].numpy()) < 1e-5, path


# --------------------------------------------------------------- registry


def test_registry_lists_the_ten_engines():
    names = registry.engine_names()
    assert names == ("mesp", "mesp_cuda", "mebp", "store_h", "mesp_seq",
                     "mezo", "mezo_sparse", "mezo_lowrank", "mezo_block",
                     "mezo_avg4")
    assert ENGINES == {e.name: e.backend or "plain"
                       for e in registry.list_engines()}
    assert ENGINES["mesp_seq"] == "structured" and ENGINES["mezo"] == "plain"
    assert all(e.quantize == ("none", "int8", "int4", "nf4")
               for e in registry.list_engines())
    with pytest.raises(registry.UnknownEngineError, match="mesp_seq"):
        registry.get_engine("sophia")
    with pytest.raises(ValueError, match="already registered"):
        registry.register_engine("mesp", description="", backend="plain")(
            lambda *a: None)


# -------------------------------------------------------------------- CLI

_CPU_RUN = ["--reduced", "--device", "cpu", "--seq", "48", "--steps", "3",
            "--lr", "5e-2"]


def test_train_cli_mesp_seq_gives_mesp_curve():
    """f32 (the reduced config), SGD: the §4.3 loop and the production
    step print the same loss curve, and train the same params."""
    seq = ttrain.train(_CPU_RUN + ["--engine", "mesp_seq"])
    ref = ttrain.train(_CPU_RUN + ["--engine", "mesp"])
    assert seq["policy"].backend == "structured"
    assert len(seq["losses"]) == 3 and seq["losses"][-1] < seq["losses"][0]
    np.testing.assert_allclose(seq["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-5)
    for path, t in _leaves(ref["params"]).items():
        np.testing.assert_allclose(_leaves(seq["params"])[path].numpy(),
                                   t.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_train_cli_flash_flags_reach_the_structured_backend():
    run = _CPU_RUN + ["--flash-min-seq", "32", "--flash-chunk", "16"]
    out = ttrain.train(run + ["--engine", "mesp"])
    assert out["policy"].flash_min_seq == 32
    assert out["policy"].flash_chunk == 16
    ref = ttrain.train(_CPU_RUN + ["--engine", "mebp"])
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("argv, match", [
    (["--engine", "mesp_seq", "--optimizer", "adamw"], "adamw"),
    (["--engine", "mesp_seq", "--optimizer", "sgd_momentum"], "sgd_momentum"),
    (["--engine", "mesp_seq", "--arch", "olmoe-1b-7b"], "dense"),
])
def test_train_cli_mesp_seq_refuses_what_it_cannot_represent(argv, match):
    with pytest.raises(ValueError, match=match):
        ttrain.train(_CPU_RUN + argv)


@pytest.mark.parametrize("optimizer", ["sgd_momentum", "adamw"])
def test_train_cli_optimizers_train(optimizer):
    out = ttrain.train(_CPU_RUN + ["--engine", "mesp_cuda", "--optimizer",
                                   optimizer, "--lr", "1e-2"])
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
