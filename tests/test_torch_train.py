"""The port's training slice against the JAX reference (f32, CPU).

Shapes are deliberately not tile-aligned, as in ``test_pallas_mode.py``
(d_model 160, 4 heads over 2 KV heads of 40, d_ff 192, vocab 97, qkv bias,
2 layers, batch 2, seq 48: below the 64 query rows from which both packages
run flash attention; and seq 96, above them, with RoPE applied before
attention or fused into the flash kernels), and every LoRA B is drawn
nonzero so that dA and the h@B term are tested. The
weights are the reference's ``init_params(PRNGKey(0))`` with B redrawn from
numpy, bridged to the port through numpy. One JAX computation per backend is
shared through module-scoped fixtures.

Losses agree at rtol 1e-5 and every LoRA gradient leaf at relative L2
1e-5 (summation order only); the port's ``cuda`` backend runs each kernel's
plain version here and is held against the reference's ``pallas`` backend
in interpret mode. The residual contract (h = x@A never saved under MeSP)
is checked through ``torch.autograd.graph.saved_tensors_hooks``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.policy import ExecutionPolicy as JaxPolicy
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import mesp as jmesp
from repro.core import structured as JS
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import mebp, mesp
from repro_torch.core import structured as TS
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM

_FIELDS = dict(name="train-test", family="dense", n_layers=2, d_model=160,
               n_heads=4, n_kv_heads=2, d_ff=192, vocab=97, qkv_bias=True,
               tie_embeddings=True, dtype="float32")
JCFG = JaxArchConfig(**_FIELDS)
TCFG = ArchConfig(**_FIELDS)
BATCH, SEQ, RANK = 2, 48, TCFG.lora.rank
#: a length from which attention runs the flash kernels (ATTN_MIN_SEQ = 64)
FLASH_SEQ = 96
TOL = dict(rtol=1e-5, atol=1e-5)
#: the port's backend -> the reference backend it is held against
JAX_BACKEND = {"structured": "structured", "cuda": "pallas",
               "plain": "plain", "store_h": "store_h"}


def _jax_policy(backend):
    return JaxPolicy(backend=JAX_BACKEND[backend],
                     interpret=True if backend == "cuda" else None)


def _redraw_b(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_b(v, rng)
        elif k == "b":
            # small, as B is after fine-tuning from zero: a large B makes
            # the attention scores large, and the softmax backward's
            # cancellation then amplifies f32 rounding to ~3e-5 per leaf,
            # between the reference's own backends too
            out[k] = (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
        else:
            out[k] = v
    return out


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict (None leaves kept)."""
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


def _tparams(np_params):
    return bridge.from_numpy_tree(np_params)


def _tbatch(np_batch):
    return {k: torch.from_numpy(v).long() for k, v in np_batch.items()}


@pytest.fixture(scope="module")
def jax_runs(np_params, np_batch):
    """{backend: (loss, {path: grad or None})} from the reference's
    ``mesp.value_and_grad``, plus its SGD ``train_step`` (structured)."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    out = {}
    for backend in JAX_BACKEND:
        loss, grads = jmesp.value_and_grad(jp, JCFG, jb,
                                           policy=_jax_policy(backend))
        out[backend] = (float(loss), {
            k: (None if v is None else np.asarray(v))
            for k, v in _leaves(grads).items()})
    stepped, _ = jmesp.train_step(jp, JCFG, jb, 1e-2,
                                  policy=JaxPolicy(backend="structured"))
    out["step"] = {k: np.asarray(v) for k, v in _leaves(stepped).items()}
    return out


# ------------------------------------------------------ autograd Functions


def _vjp_pair(jfn, tfn, inputs, cot, grad_of):
    """Outputs and the gradients wrt ``grad_of`` (indices into ``inputs``)
    of the JAX function and the port's, on the same numpy inputs."""
    jin = [jnp.asarray(x) for x in inputs]
    jout, vjp = jax.vjp(lambda *d: jfn(*[d[grad_of.index(i)]
                                         if i in grad_of else jin[i]
                                         for i in range(len(jin))]),
                        *[jin[i] for i in grad_of])
    jgrads = vjp(jnp.asarray(cot))
    tin = [torch.from_numpy(x).requires_grad_(i in grad_of)
           for i, x in enumerate(inputs)]
    tout = tfn(*tin)
    tgrads = torch.autograd.grad(tout, [tin[i] for i in grad_of],
                                 torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["lora_linear", "lora_linear_store_h"])
def test_lora_linear_functions_match_reference_vjp(name):
    rng = np.random.default_rng(20)
    x = _randn(rng, 2, 5, 24)
    w0, a, b = _randn(rng, 24, 40, scale=0.2), _randn(rng, 24, 4), \
        _randn(rng, 4, 40, scale=0.3)
    bias = _randn(rng, 40)
    jfn, tfn = getattr(JS, name), getattr(TS, name)
    _vjp_pair(lambda *t: jfn(*t, 2.0), lambda *t: tfn(*t, 2.0),
              [x, w0, a, b, bias], _randn(rng, 2, 5, 40), grad_of=[0, 2, 3])


def test_rmsnorm_function_matches_reference_vjp():
    rng = np.random.default_rng(21)
    x, w = _randn(rng, 3, 7, 33, scale=3.0), _randn(rng, 33)
    _vjp_pair(lambda x, w: JS.rmsnorm(x, w, 1e-6),
              lambda x, w: TS.rmsnorm(x, w, 1e-6), [x, w],
              _randn(rng, 3, 7, 33), grad_of=[0, 1])


def test_silu_function_matches_reference_vjp():
    rng = np.random.default_rng(22)
    _vjp_pair(JS.silu, TS.silu, [_randn(rng, 4, 9, scale=3.0)],
              _randn(rng, 4, 9), grad_of=[0])


def test_sdpa_function_matches_reference_vjp():
    """GQA (4 query heads over 2 KV heads), causal, 7 rows of 16."""
    rng = np.random.default_rng(23)
    q, k, v = (_randn(rng, 2, 4, 7, 16), _randn(rng, 2, 2, 7, 16),
               _randn(rng, 2, 2, 7, 16))
    _vjp_pair(lambda q, k, v: JS.sdpa(q, k, v, 0, True),
              lambda q, k, v: TS.sdpa(q, k, v, 0, True), [q, k, v],
              _randn(rng, 2, 4, 7, 16), grad_of=[0, 1, 2])


def test_softmax_xent_function_ignores_minus_one_labels():
    rng = np.random.default_rng(24)
    logits = _randn(rng, 2, 5, 11, scale=2.0)
    labels = rng.integers(0, 11, (2, 5))
    labels[0, 1] = labels[1, 4] = -1
    jl, vjp = jax.vjp(lambda z: JS.softmax_xent(z, jnp.asarray(labels)),
                      jnp.asarray(logits))
    (jg,) = vjp(jnp.ones((), jnp.float32))
    tz = torch.from_numpy(logits).requires_grad_(True)
    tl = TS.softmax_xent(tz, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tl, tz)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    assert np.all(tg.numpy()[0, 1] == 0) and np.all(tg.numpy()[1, 4] == 0)


# ------------------------------------------------ model: loss and gradients


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
def test_loss_fn_matches_reference(np_params, np_batch, jax_runs, backend):
    loss = TM.loss_fn(_tparams(np_params), TCFG, _tbatch(np_batch),
                      policy=ExecutionPolicy(backend=backend))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss), jax_runs[backend][0], rtol=1e-5)


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
def test_value_and_grad_matches_reference(np_params, np_batch, jax_runs,
                                          backend):
    """Loss at rtol 1e-5 and each LoRA gradient leaf at relative L2 1e-5
    against ``repro.core.mesp.value_and_grad`` under the matching backend
    (``cuda`` against ``pallas`` in interpret mode)."""
    tparams = _tparams(np_params)
    tops.reset_launch_counts()
    loss, grads = mesp.value_and_grad(tparams, TCFG, _tbatch(np_batch),
                                      policy=ExecutionPolicy(backend=backend))
    assert set(tops.launch_counts().values()) == {0}   # CPU: plain versions
    jloss, jgrads = jax_runs[backend]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    tg = _leaves(grads)
    assert tg.keys() == jgrads.keys()
    n_lora = 0
    for path, jg in jgrads.items():
        if jg is None:
            assert tg[path] is None, path
            continue
        n_lora += 1
        assert tg[path].shape == jg.shape, path
        assert np.abs(jg).max() > 0, path          # B != 0: dA is nonzero
        assert _rel(tg[path].numpy(), jg) <= 1e-5, (path, _rel(
            tg[path].numpy(), jg))
    assert n_lora == 14                            # 7 linears x (a, b)


def test_mebp_is_mesp_under_the_plain_backend(np_params, np_batch):
    tparams, batch = _tparams(np_params), _tbatch(np_batch)
    l1, g1 = mebp.value_and_grad(tparams, TCFG, batch)
    l2, g2 = mesp.value_and_grad(tparams, TCFG, batch,
                                 policy=ExecutionPolicy(backend="plain"))
    assert float(l1) == float(l2)
    for path, g in _leaves(g1).items():
        other = _leaves(g2)[path]
        assert (g is None and other is None) or torch.equal(g, other)


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_train_step_lands_on_reference_params(np_params, np_batch, jax_runs,
                                              backend):
    """One SGD step (lr 1e-2) against the reference's structured
    ``train_step``, at the tolerance of ``test_pallas_mode.py``."""
    tparams = _tparams(np_params)
    new, loss = mesp.train_step(tparams, TCFG, _tbatch(np_batch), 1e-2,
                                policy=ExecutionPolicy(backend=backend))
    np.testing.assert_allclose(float(loss), jax_runs["structured"][0],
                               rtol=1e-5)
    got = _leaves(bridge.to_numpy_tree(new))
    assert got.keys() == jax_runs["step"].keys()
    for path, want in jax_runs["step"].items():
        np.testing.assert_allclose(got[path], want, rtol=2e-5, atol=2e-6,
                                   err_msg=path)
    # frozen leaves are the same tensors, untouched
    assert new["embed"]["tok"] is tparams["embed"]["tok"]


# ------------------------------------------------------- residual contract


def _saved(params, backend, remat, seq=SEQ, weights=True):
    """Shapes of every tensor the outer forward hands to autograd to keep,
    seen through ``saved_tensors_hooks``; with ``weights=False`` those that
    share storage with a parameter are left out (at seq 96 the down
    projection's A, [192, r], has the rows of an h)."""
    shapes = []
    stores = {t.untyped_storage().data_ptr()
              for t in _leaves(params).values()}

    def pack(t):
        if weights or t.untyped_storage().data_ptr() not in stores:
            shapes.append(tuple(t.shape))
        return t

    batch = _tbatch(next(tpipe.make_batch_iterator(
        TCFG.vocab, seq, BATCH, seed=5, n_tokens=4096)))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        mesp.value_and_grad(params, TCFG, batch, policy=ExecutionPolicy(
            backend=backend, remat=remat))
    return shapes


def _is_h(shape, seq=SEQ):
    """An [..., r] activation: h = x@A, rows of batch x seq."""
    return shape[-1] == RANK and int(np.prod(shape[:-1])) == BATCH * seq


def _is_probs(shape, seq=SEQ):
    return len(shape) >= 2 and shape[-2:] == (seq, seq)


@pytest.mark.parametrize("engine,backend,saves_h,saves_probs", [
    ("mesp", "structured", False, False),
    ("mesp_cuda", "cuda", False, False),
    ("store_h", "store_h", True, False),
    ("mebp", "plain", True, True),
])
def test_saved_tensors_follow_the_residual_contract(
        np_params, engine, backend, saves_h, saves_probs):
    """remat off, so every block's residuals reach the hooks: MeSP saves no
    [..., r] h and no [.., N, N] probabilities; store_h saves h; MeBP
    (autograd) saves both."""
    shapes = _saved(_tparams(np_params), backend, remat=False)
    assert any(map(_is_h, shapes)) == saves_h, engine
    assert any(map(_is_probs, shapes)) == saves_probs, engine
    if not saves_h:
        # each LoRA linear saves its input x, rows of batch x seq
        assert sum(s[:2] == (BATCH, SEQ) for s in shapes) >= 7 * 2


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_remat_outer_forward_keeps_block_inputs_and_head_residuals(
        np_params, backend):
    """With remat, each block runs under ``torch.utils.checkpoint``: the
    outer forward saves one input per block and nothing of the blocks'
    insides, plus the head's residuals (final norm input and weight, the
    tied embedding, logits, labels)."""
    d, V, L = TCFG.d_model, TCFG.vocab, TCFG.n_layers
    shapes = _saved(_tparams(np_params), backend, remat=True)
    assert sorted(shapes) == sorted([(BATCH, SEQ, d)] * (L + 1) + [
        (d,), (d, V), (BATCH, SEQ, V), (BATCH, SEQ)]), shapes
    assert len(_saved(_tparams(np_params), backend, remat=False)) > 50


@pytest.mark.parametrize("engine,backend,saves_h,saves_probs", [
    ("mesp", "structured", False, False),
    ("mesp_cuda", "cuda", False, False),
    ("store_h", "store_h", True, False),
    ("mebp", "plain", True, True),
])
def test_saved_tensors_follow_the_residual_contract_at_flash_lengths(
        np_params, engine, backend, saves_h, saves_probs):
    """The residual contract at seq 96, where ``cuda`` runs the flash
    Function: remat off, no [..., N, N] tensor and no [..., r] h under
    MeSP; each layer's flash Function saves its q, k, v, out and lse in
    the kernels' [B·H, N, D] layout."""
    shapes = _saved(_tparams(np_params), backend, remat=False,
                    seq=FLASH_SEQ, weights=False)
    assert any(_is_h(s, FLASH_SEQ) for s in shapes) == saves_h, engine
    assert any(_is_probs(s, FLASH_SEQ) for s in shapes) == saves_probs
    if backend == "cuda":
        H, Hkv, D = TCFG.n_heads, TCFG.n_kv_heads, TCFG.resolved_head_dim
        L, N = TCFG.n_layers, FLASH_SEQ
        assert shapes.count((BATCH * H, N)) == L                  # lse
        assert shapes.count((BATCH * H, N, D)) == 2 * L           # q, out
        assert shapes.count((BATCH * Hkv, N, D)) == 2 * L         # k, v


@pytest.fixture(scope="module")
def flash_batch():
    return next(tpipe.make_batch_iterator(TCFG.vocab, FLASH_SEQ, BATCH,
                                          seed=6, n_tokens=4096))


@pytest.mark.parametrize("fuse_rope", [False, True])
def test_cuda_backend_matches_pallas_from_64_query_rows(
        np_params, flash_batch, monkeypatch, fuse_rope):
    """At seq 96 both packages run flash attention: the port's ``cuda``
    backend (the flash Function, whose wrappers take their plain versions
    here) against the reference's ``pallas`` backend in interpret mode,
    with RoPE applied before attention or fused into the kernels (as
    ``test_pallas_mode.py`` checks ``fuse_rope``): the loss at rtol 1e-5
    and every LoRA gradient leaf at relative L2 1e-5."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in flash_batch.items()}
    jloss, jgrads = jmesp.value_and_grad(jp, JCFG, jb, policy=JaxPolicy(
        backend="pallas", interpret=True, fuse_rope=fuse_rope))
    calls, fwd = [], tops._fa.flash_attention_fwd
    monkeypatch.setattr(tops._fa, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(a[3]) or fwd(*a, **kw))
    loss, grads = mesp.value_and_grad(
        _tparams(np_params), TCFG, _tbatch(flash_batch),
        policy=ExecutionPolicy(backend="cuda", fuse_rope=fuse_rope))
    # every block's forward twice (remat), with tables only when fused
    assert len(calls) == 2 * TCFG.n_layers
    assert all((t is not None) == fuse_rope for t in calls)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tg, jg = _leaves(grads), _leaves(jgrads)
    assert tg.keys() == jg.keys()
    n_lora = 0
    for path, want in jg.items():
        if want is None:
            assert tg[path] is None, path
            continue
        n_lora += 1
        err = _rel(tg[path].numpy(), np.asarray(want))
        assert err <= 1e-5, (path, err)
    assert n_lora == 14


# -------------------------------------------------------------- pipeline


@pytest.mark.parametrize("seed", [0, 7])
def test_data_pipeline_yields_the_reference_batches(seed):
    """Token for token, across an epoch boundary (per-epoch offsets), with
    a host shard, and after restoring a saved state."""
    kw = dict(n_tokens=1000, seed=seed)
    for extra in ({}, {"host_index": 1, "host_count": 2}):
        j = jpipe.make_batch_iterator(97, 7, 4, **kw, **extra)
        t = tpipe.make_batch_iterator(97, 7, 4, **kw, **extra)
        for _ in range(50):
            jb, tb = next(j), next(t)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k], jb[k])
        assert t.state.to_dict() == j.state.to_dict()
    state = tpipe.DataState.from_dict(t.state.to_dict())
    j2 = jpipe.make_batch_iterator(97, 7, 4, **kw, state=jpipe.DataState(
        **state.to_dict()))
    t2 = tpipe.make_batch_iterator(97, 7, 4, **kw, state=state)
    np.testing.assert_array_equal(next(t2)["tokens"], next(j2)["tokens"])
    np.testing.assert_array_equal(
        tpipe.synthetic_corpus(151936, 5000, seed),
        jpipe.synthetic_corpus(151936, 5000, seed))


# ------------------------------------------------------------------- CLI


_CPU_RUN = ["--reduced", "--device", "cpu", "--seq", "48", "--steps", "3"]


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--reduced", "--steps", "1"])
    with pytest.raises(ValueError, match="adamw"):
        ttrain.train(_CPU_RUN + ["--engine", "mesp_seq", "--optimizer",
                                 "adamw"])


@pytest.fixture(scope="module")
def cli_losses():
    return {e: ttrain.train(_CPU_RUN + ["--engine", e])["losses"]
            for e in ("mesp_cuda", "mesp", "mebp", "store_h")}


@pytest.mark.parametrize("engine", ["mesp", "mebp", "store_h"])
def test_train_cli_engines_give_one_loss_curve(cli_losses, engine):
    """f32: every engine computes the same gradients, so the same curve."""
    assert len(cli_losses[engine]) == 3
    assert all(np.isfinite(cli_losses[engine]))
    np.testing.assert_allclose(cli_losses[engine], cli_losses["mesp_cuda"],
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cli_losses_at_flash_seq():
    run = ["--reduced", "--device", "cpu", "--seq", str(FLASH_SEQ),
           "--steps", "3"]
    out = {e: ttrain.train(run + ["--engine", e])["losses"]
           for e in ("mesp_cuda", "mesp", "mebp", "store_h")}
    out["mesp_cuda --fuse-rope"] = ttrain.train(
        run + ["--engine", "mesp_cuda", "--fuse-rope"])["losses"]
    return out


@pytest.mark.parametrize("engine", ["mesp", "mebp", "store_h",
                                    "mesp_cuda --fuse-rope"])
def test_train_cli_engines_give_one_loss_curve_at_flash_lengths(
        cli_losses_at_flash_seq, engine):
    """f32, seq 96: ``mesp_cuda`` runs the flash Function (its plain
    versions here), with or without fused RoPE, and gives every other
    engine's curve."""
    losses = cli_losses_at_flash_seq
    assert len(losses[engine]) == 3 and all(np.isfinite(losses[engine]))
    np.testing.assert_allclose(losses[engine], losses["mesp_cuda"],
                               rtol=1e-5, atol=1e-5)


def test_train_cli_loss_descends(tmp_path):
    out = ttrain.train(_CPU_RUN + ["--engine", "mesp_cuda", "--lr", "5e-2",
                                   "--steps", "4"])
    losses = out["losses"]
    assert losses[-1] < losses[0], losses
    assert out["policy"].backend == "cuda"
    assert out["params"]["blocks"]["attn"]["q"]["b"].abs().max() > 0
    assert ttrain.main(_CPU_RUN + ["--steps", "1", "--ckpt-dir",
                                   str(tmp_path)]) == 0
