"""The port's recurrent families against the JAX reference: RWKV6
(``ssm``, ``models/rwkv6.py``) and RecurrentGemma (``hybrid``,
``models/griffin.py`` beside local-attention blocks), at reduced size in
f32.

The WKV recurrence (chunked, at N 1, 37, 64 and 150: padding and several
chunks of 64) and its one-token step, the RG-LRU's doubling scan and its
step, and one block of each kind are held against the reference's
functions on the same numpy-seeded inputs, outputs and input gradients at
1e-5. Then the models: weights are the reference's ``init_params`` with
every LoRA B redrawn from numpy, bridged through numpy; the hybrid runs 5
layers (one R, R, A group and a ``tail`` list of two recurrent blocks;
the reduced config's 3 leave the tail empty) at 20 tokens, past the
reduced window of 8. Logits and each engine's loss and LoRA gradients
(``mesp_cuda`` with the kernels' plain versions, ``mesp``, ``mebp``,
``store_h``) agree with the reference's structured rules at 1e-5;
decode steps equal the reference's decode at 1e-5 and the port's own
forward at 1e-4 (``tests/test_recurrences.py``'s check). Last, both archs
train through the launcher with a checkpoint save and an exact resume.

RWKV6's per-head group norm makes the reduced model ill-conditioned in
f32: where a head's WKV row nearly cancels (the first tokens: y = (r·(u⊙k))
v), its mean square falls to ~1e-6, the norm's eps, and the norm
multiplies the row's rounding by ~700. At these weights the reference's
own f32 logits stand 3.0e-5 from its f64 ones and its gradients up to
1.2e-4 (relative L2 of a leaf), and any other order of the same f32 sums
(jit or not, the kernels' RMSNorm formula x·rsqrt(ms + eps) or the
structured x / sqrt(ms + eps)) lands as far. So RWKV6's logits and
gradients are held against the reference run in f64 (``jax.enable_x64``):
no further from it than twice the reference's own f32 is, plus 1e-6, the
scheme ``chip_smoke.py`` holds the kernels to against f32; its decode
against the reference's decode at ``RWKV_DECODE_TOL``.
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
from repro.models import griffin as jgriffin
from repro.models import model as JM
from repro.models import rwkv6 as jrwkv
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.api.spec import TrainSpec
from repro_torch.api.trainer import Trainer
from repro_torch.configs import get_config
from repro_torch.core import mesp
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import griffin as tgriffin
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as trwkv
from repro_torch.tree import leaves_with_paths, path_str, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)
RWKV = "rwkv6-1.6b"
BACKENDS = ("structured", "cuda", "plain")
#: RWKV6's decode logits and states against the reference's jitted decode
#: (see above): the reference's f32 decode stands up to 1.7e-5 from its f64
#: decode at these weights, the port's 6.3e-5
RWKV_DECODE_TOL = 1e-4
B, N = 2, 20
ARCHS = {
    "rwkv6-1.6b": (jax_config("rwkv6-1.6b").reduced(),
                   get_config("rwkv6-1.6b").reduced()),
    "recurrentgemma-2b": tuple(
        dataclasses.replace(c.reduced(), n_layers=5)
        for c in (jax_config("recurrentgemma-2b"),
                  get_config("recurrentgemma-2b"))),
}
#: port engine -> its backend; each is held against the reference's
#: structured rules (the four compute one function: MeSP's rules with h
#: recomputed, the kernels' plain versions of them, autograd, h stored)
ENGINES = {"mesp_cuda": "cuda", "mesp": "structured", "mebp": "plain",
           "store_h": "store_h"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {path_str(p): x for p, x in leaves_with_paths(tree)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _with_b(tree, rng):
    """Every LoRA B drawn at 0.02 (its size after fine-tuning from zero)."""
    out = {}
    for k, v in tree.items():
        if k == "b":
            out[k] = (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
        elif isinstance(v, dict):
            out[k] = _with_b(v, rng)
        elif isinstance(v, list):
            out[k] = [_with_b(x, rng) for x in v]
        else:
            out[k] = v
    return out


# ------------------------------------------------------------------- WKV


def _wkv_inputs(n, seed=0, H=3, D=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    logw = -np.exp(rng.standard_normal((B, n, H, D)) * 0.5 - 2.0)
    return (f(B, n, H, D), f(B, n, H, D), f(B, n, H, D),
            logw.astype(np.float32), f(H, D), f(B, H, D, D))


@pytest.mark.parametrize("n", [1, 37, 64, 150])
def test_wkv_chunked_matches_reference(n):
    """Output, final state and the gradients of every input (through the
    per-chunk checkpoint) against ``rwkv6.wkv_chunked``."""
    args = _wkv_inputs(n)
    gy = np.random.default_rng(1).standard_normal(
        (B, n) + args[0].shape[2:]).astype(np.float32)
    jy, jstate = jrwkv.wkv_chunked(*map(jnp.asarray, args))
    jgrads = jax.grad(lambda *a: jnp.sum(jrwkv.wkv_chunked(*a)[0] * gy),
                      argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    ty, tstate = trwkv.wkv_chunked(*targs)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tstate.detach().numpy(), np.asarray(jstate),
                               **TOL)
    tgrads = torch.autograd.grad((ty * torch.from_numpy(gy)).sum(), targs)
    for name, got, want in zip("r k v logw u state".split(), tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)


def test_wkv_step_matches_reference_and_the_chunked_form():
    r, k, v, logw, u, state = _wkv_inputs(1, seed=2)
    jy, js = jrwkv.wkv_step(*(jnp.asarray(t[:, 0]) for t in (r, k, v, logw)),
                            jnp.asarray(u), jnp.asarray(state))
    ty, ts = trwkv.wkv_step(*(torch.from_numpy(t[:, 0])
                              for t in (r, k, v, logw)),
                            torch.from_numpy(u), torch.from_numpy(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    cy, cs = trwkv.wkv_chunked(*map(torch.from_numpy,
                                    (r, k, v, logw, u, state)))
    np.testing.assert_allclose(cy[:, 0].numpy(), ty.numpy(), **TOL)
    np.testing.assert_allclose(cs.numpy(), ts.numpy(), **TOL)


# ---------------------------------------------------------------- RG-LRU


@pytest.mark.parametrize("n", [1, 37, 150])
def test_rg_lru_scan_matches_reference_and_its_steps(n):
    rng = np.random.default_rng(n)
    x, gr, gi = (rng.standard_normal((B, n, 16)).astype(np.float32)
                 for _ in range(3))
    lam = rng.standard_normal(16).astype(np.float32)
    jh, _ = jgriffin.rg_lru(*map(jnp.asarray, (x, gr, gi, lam)), None)
    th, _ = tgriffin.rg_lru(*map(torch.from_numpy, (x, gr, gi, lam)), None)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    state = torch.zeros(B, 16)
    steps = []
    for t in range(n):
        h, state = tgriffin.rg_lru(
            *(torch.from_numpy(a[:, t:t + 1]) for a in (x, gr, gi)),
            torch.from_numpy(lam), state)
        steps.append(h)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), th.numpy(),
                               **TOL)


# ---------------------------------------------------------------- blocks


@pytest.fixture(scope="module")
def np_params():
    return {name: _with_b(_np(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), j)), np.random.default_rng(1))
            for name, (j, _) in ARCHS.items()}


@pytest.mark.parametrize("kind", ["rwkv", "recurrent"])
def test_block_matches_reference(np_params, kind):
    """One block's output and the gradient of its input, structured rules,
    at 20 tokens (the reference's ``rwkv_block`` / ``recurrent_block``)."""
    arch = "rwkv6-1.6b" if kind == "rwkv" else "recurrentgemma-2b"
    jcfg, tcfg = ARCHS[arch]
    tree = np_params[arch]
    bp = tree_map(lambda t: t[0], tree["blocks"] if kind == "rwkv"
                  else tree["groups"]["l0"])
    jblock = jrwkv.rwkv_block if kind == "rwkv" else jgriffin.recurrent_block
    tblock = trwkv.rwkv_block if kind == "rwkv" else tgriffin.recurrent_block
    x = np.random.default_rng(3).standard_normal(
        (B, N, jcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, bp)
    jy, jdx = jax.jit(lambda p, x: (jblock(p, x, jcfg)[0], jax.grad(
        lambda x: jnp.sum(jblock(p, x, jcfg)[0]))(x)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tblock(bridge.from_numpy_tree(bp), tx, tcfg)[0]
    (tdx,) = torch.autograd.grad(ty.sum(), tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)


# ---------------------------------------------------------------- models


def _batch(vocab, n=N):
    return next(tpipe.make_batch_iterator(vocab, n, B, seed=3,
                                          n_tokens=4096))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_tree_matches_reference(np_params, arch):
    _, tcfg = ARCHS[arch]
    tp = bridge.to_numpy_tree(
        TM.init_params(tcfg, generator=torch.Generator().manual_seed(0)))
    shapes = lambda t: {k: v.shape for k, v in _leaves(t).items()}
    assert shapes(tp) == shapes(np_params[arch])
    if arch == "recurrentgemma-2b":
        assert isinstance(tp["tail"], list) and len(tp["tail"]) == 2


@pytest.fixture(scope="module")
def rwkv_f64(np_params):
    """The reference's RWKV6 in f64: forward logits, and the structured
    rules' LoRA gradients."""
    jcfg = dataclasses.replace(ARCHS[RWKV][0], dtype="float64")
    batch = _batch(jcfg.vocab)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    np_params[RWKV])
        logits = np.asarray(jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
            jp, jnp.asarray(batch["tokens"])))
        _, grads = jax.jit(lambda p, b: jmesp.value_and_grad(
            p, jcfg, b, policy=JaxPolicy(backend="structured")))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        grads = {k: np.asarray(v) for k, v in _leaves(grads).items()}
    return {"logits": logits, "grads": grads}


def _within_f64(got, ref32, f64, what, elementwise=False):
    """``got`` no further from the f64 run than twice the reference's f32
    run is, plus 1e-6: by the largest element-wise difference (logits) or
    by relative L2 (a gradient leaf)."""
    if elementwise:
        dist = lambda u: float(np.abs(u - f64).max())
    else:
        dist = lambda u: _rel(u, f64)
    assert dist(got) <= 2 * dist(ref32) + 1e-6, \
        (what, dist(got), dist(ref32))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_logits_match_reference(np_params, rwkv_f64, arch):
    jcfg, tcfg = ARCHS[arch]
    toks = _batch(tcfg.vocab)["tokens"]
    want = np.asarray(jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jax.tree_util.tree_map(jnp.asarray, np_params[arch]),
        jnp.asarray(toks)))
    tp = bridge.from_numpy_tree(np_params[arch])
    for backend in BACKENDS:
        got = TM.forward(tp, tcfg, torch.from_numpy(toks).long(),
                         policy=ExecutionPolicy(backend=backend))
        if arch == RWKV:
            _within_f64(got.detach().numpy(), want, rwkv_f64["logits"],
                        backend, elementwise=True)
            continue
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   err_msg=backend, **TOL)


@pytest.fixture(scope="module")
def jax_grads(np_params):
    """{arch: (loss, {path: grad})} from the reference's structured
    rules."""
    out = {}
    for arch, (jcfg, _) in ARCHS.items():
        jp = jax.tree_util.tree_map(jnp.asarray, np_params[arch])
        jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab).items()}
        loss, grads = jax.jit(lambda p, b: jmesp.value_and_grad(
            p, jcfg, b, policy=JaxPolicy(backend="structured")))(jp, jb)
        out[arch] = (float(loss), {
            k: np.asarray(v) for k, v in _leaves(grads).items()})
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_lora_grads_match_reference(np_params, jax_grads, rwkv_f64, arch,
                                    engine):
    """One value_and_grad per engine against the reference's structured
    rules (RWKV6 against its f64 run, see above)."""
    _, tcfg = ARCHS[arch]
    backend = ENGINES[engine]
    wloss, wgrads = jax_grads[arch]
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(tcfg.vocab).items()}
    loss, grads = mesp.value_and_grad(bridge.from_numpy_tree(np_params[arch]),
                                      tcfg, batch,
                                      policy=ExecutionPolicy(backend=backend))
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-5)
    got = {k: v.numpy() for k, v in _leaves(grads).items()}
    assert got.keys() == wgrads.keys()
    if arch == "recurrentgemma-2b":
        assert any(k.startswith("tail/1/") for k in got)
    for k, w in wgrads.items():
        if arch == RWKV:
            _within_f64(got[k], w, rwkv_f64["grads"][k], k)
        else:
            assert _rel(got[k], w) < 1e-5, (k, _rel(got[k], w))


def _jax_decode(params, cfg, toks):
    """The reference's single-stream decode over ``toks`` [B, N]: (logits
    [B, N, V], final cache), as numpy."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jc = JM.init_cache(cfg, B, N + 4)
    step = jax.jit(lambda p, c, t: JM.decode_step(p, cfg, c, t))
    outs = []
    for t in range(N):
        logits, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        outs.append(np.asarray(logits))
    return np.concatenate(outs, 1), _leaves(_np(jc))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_reference_and_forward(np_params, arch):
    """20 single-stream decode steps: logits and the final caches against
    the reference's decode step (1e-5; RWKV6 ``RWKV_DECODE_TOL``), logits
    against the port's forward (1e-4)."""
    jcfg, tcfg = ARCHS[arch]
    toks = _batch(tcfg.vocab)["tokens"]
    want, jcache = _jax_decode(np_params[arch], jcfg, toks)
    tp = bridge.from_numpy_tree(np_params[arch])
    tc = TM.init_cache(tcfg, B, N + 4, per_slot=False)
    got = torch.cat([TM.decode_step(tp, tcfg, tc, torch.from_numpy(
        toks[:, t:t + 1]).long())[0] for t in range(N)], 1).numpy()
    # the reference's scalar "len" is the port's [B] vector
    tcache = {k: v for k, v in _leaves(bridge.to_numpy_tree(tc)).items()}
    assert tcache.keys() == jcache.keys()
    jcache = {k: np.broadcast_to(v, tcache[k].shape)
              for k, v in jcache.items()}
    tol = RWKV_DECODE_TOL if arch == RWKV else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    for k, v in tcache.items():
        np.testing.assert_allclose(v, jcache[k], err_msg=k, rtol=tol,
                                   atol=tol)
    fwd = TM.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got, fwd.detach().numpy(), rtol=1e-4,
                               atol=1e-4)


def test_rwkv_runs_whole_in_f64_and_decodes_its_forward(np_params):
    """RWKV6 in f64 on the plain backend (``chip_smoke.py``'s witness of
    its f32 runs): the WKV state, the group norm and the logits stay in
    f64, decode equals the forward to 1e-12 of the largest logit (7.9e-15
    measured), and the port's f32 forward stands within 1e-4 of it
    (1.2e-5 measured: the f32 conditioning above)."""
    tcfg = dataclasses.replace(ARCHS[RWKV][1], dtype="float32")
    c64 = dataclasses.replace(tcfg, dtype="float64")
    p32 = bridge.from_numpy_tree(np_params[RWKV])
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, p32)
    toks = torch.from_numpy(_batch(tcfg.vocab)["tokens"]).long()
    pol = ExecutionPolicy(backend="plain")
    with torch.no_grad():
        fwd = TM.forward(p64, c64, toks, policy=pol)
        cache = TM.init_cache(c64, B, N, per_slot=False)
        assert cache["blocks"]["wkv"].dtype == torch.float64
        dec = torch.cat([TM.decode_step(p64, c64, cache, toks[:, t:t + 1],
                                        policy=pol)[0] for t in range(N)], 1)
        f32 = TM.forward(p32, tcfg, toks, policy=pol)
    assert fwd.dtype == dec.dtype == torch.float64
    scale = float(fwd.abs().max())
    assert float((dec - fwd).abs().max()) <= 1e-12 * scale
    assert float((f32.double() - fwd).abs().max()) <= 1e-4 * scale


def test_per_slot_cache_is_refused_for_the_recurrent_families():
    for arch in ARCHS:
        with pytest.raises(ValueError, match="per_slot"):
            TM.init_cache(ARCHS[arch][1], 2, 16)


# -------------------------------------------------------------- training


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cli_resumes_exactly_from_its_checkpoint(tmp_path, arch):
    """The launcher at the reduced size: 2 steps and a checkpoint, then the
    same call with --steps 4 resumes at step 2; its LoRA leaves equal those
    of an uninterrupted 4-step run bit for bit, and mesp_cuda's losses are
    mesp's."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "20",
            "--engine", "mesp_cuda", "--lr", "0.1", "--quiet"]
    ttrain.run(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    resumed = ttrain.run(argv + ["--steps", "4", "--ckpt-dir",
                                 str(tmp_path / "a")])
    assert [r.step for r in resumed.history] == [3, 4]
    whole = ttrain.run(argv + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "b")])
    got, want = _leaves(resumed.params), _leaves(whole.params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    plain = ttrain.train(argv[:-1] + ["--steps", "2", "--engine", "mesp"])
    np.testing.assert_allclose([r.loss for r in whole.history[:2]],
                               plain["losses"], rtol=1e-5)


def test_trainer_checkpoints_the_hybrid_tail_list(tmp_path):
    """The Trainer over the 5-layer hybrid (``tail`` a list of two blocks):
    a crash at step 3 resumes from the checkpoint to the uninterrupted
    run's LoRA leaves."""
    cfg = ARCHS["recurrentgemma-2b"][1]
    spec = lambda d, faults="": TrainSpec(
        arch="recurrentgemma-2b", reduced=True, device="cpu", seq=20,
        steps=4, engine="mesp_cuda", lr=0.1, ckpt_dir=str(tmp_path / d),
        ckpt_interval=1, inject_faults=faults, quiet=True)
    crashed = Trainer(spec("a", "crash@3"), cfg=cfg).fit()
    whole = Trainer(spec("b"), cfg=cfg).fit()
    assert crashed.fault_counts["injected"] == {"crash": 1}
    assert isinstance(crashed.params["tail"], list)
    got, want = _leaves(crashed.params), _leaves(whole.params)
    assert any(k.startswith("tail/1/") for k in got)
    assert all(torch.equal(got[k], want[k]) for k in want)
