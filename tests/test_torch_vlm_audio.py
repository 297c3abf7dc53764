"""The port's last two families against the JAX reference, at reduced size
in f32: InternVL2-1B (``vlm``: 4 precomputed patch embeddings ahead of the
text, the prefix's labels -1) and Whisper-tiny (``audio``: a 2-layer
non-causal encoder without RoPE over 8 frame embeddings with sinusoid
positions, and a decoder whose blocks cross-attend to the encoder's
output). d 64, 4 heads of 16 (InternVL over 2 KV heads).

Weights are the reference's ``init_params(PRNGKey(0))`` with every LoRA B
redrawn from numpy at 0.02, bridged through numpy (the ``enc_blocks``,
``enc_norm``, ``xattn`` and ``lnx`` leaves cross unchanged); tokens,
labels, patch embeddings and frames are drawn from numpy seeds. Each
reference model is built and run once, in module-scoped fixtures.
Logits, losses and decode logits agree at rtol = atol = 1e-5, each LoRA
gradient leaf (the encoder's included) at relative L2 1e-5 (summation
order only); the port's decode against its own forward at 1e-4, as
elsewhere.
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
from repro.launch.serve import DecodeServer as JaxDecodeServer
from repro.models import model as JM
from repro.serve import AdapterStore as JaxStore
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import mesp, quant
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.serve import (AdapterStore, ContinuousBatcher, Request,
                               synthetic_adapters)
from repro_torch.zo import estimator, samplers

VLM, AUDIO = "internvl2-1b", "whisper-tiny"
ARCHS = (VLM, AUDIO)
TOL = dict(rtol=1e-5, atol=1e-5)
B, N = 2, 12
#: text and frames past the cuda backend's 64 query rows, where its flash
#: Function runs (plain versions on the CPU) every attention of both
FLASH_N, FLASH_T = 64, 72
#: port engine -> its backend; each is held against the reference's
#: structured backend (its four backends compute one function, and one
#: compile a case spares the tier-1 clock)
ENGINES = {"mesp_cuda": "cuda", "mesp": "structured", "mebp": "plain",
           "store_h": "store_h"}
#: the structured backend's chunked flash from 4 query rows in chunks of
#: 3: the encoder's 8 frames (3 + 3 + 2, non-causal), the decoder's 12
#: tokens, the cross-attention's ragged key chunk, the vlm's 16 rows
CHUNKED = dict(flash_min_seq=4, flash_chunk=3)



def _same_metrics(got, want):
    """Batcher metrics equal on every key but the autotuner's (adopted with
    a telemetry), whose values are each package's own module-global
    counts: those the same names."""
    tune = lambda m: {k for k in m if k.startswith("autotune.")}
    rest = lambda m: {k: v for k, v in m.items()
                      if not k.startswith("autotune.")}
    assert tune(got) == tune(want)
    assert rest(got) == rest(want)

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


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


def _batch(arch, n=N, frames=None, seed=3):
    """numpy tokens / labels [B, n] and the family's input: patch
    embeddings [B, 4, d] (std 0.02) or frames [B, ``frames`` (default the
    reduced encoder's 8), d] (std 0.5)."""
    cfg = get_config(arch).reduced()
    out = dict(next(tpipe.make_batch_iterator(cfg.vocab, n, B, seed=seed,
                                              n_tokens=4096)))
    rng = np.random.default_rng(seed + 10)
    if cfg.family == "vlm":
        out["frontend_embeds"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        t = frames or cfg.encdec.encoder_seq
        out["enc_frames"] = (rng.standard_normal((B, t, cfg.d_model))
                             * 0.5).astype(np.float32)
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _extras(batch):
    return {k: batch[k] for k in ("frontend_embeds", "enc_frames")
            if k in batch}


@pytest.fixture(scope="module")
def np_params():
    return {a: _redraw_b(_np(JM.init_params(jax.random.PRNGKey(0),
                                            jax_config(a).reduced())),
                         np.random.default_rng(1)) for a in ARCHS}


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    """Every field of the full config and its reduced cut (4 frontend
    tokens; an encoder of 2 layers over 8 frames), and the parameter
    counts, the encoder's term included."""
    j, t = jax_config(name), get_config(name)
    assert name in REGISTRY
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for f in dataclasses.fields(ct):
            if f.name == "lora":
                continue
            want = getattr(cj, f.name)
            got = getattr(ct, f.name)
            if f.name == "encdec" and want is not None:
                got, want = dataclasses.astuple(got), dataclasses.astuple(want)
            assert got == want, (name, f.name)
        assert (ct.lora.rank, ct.lora.alpha, ct.lora.targets) == \
            (cj.lora.rank, cj.lora.alpha, cj.lora.targets)
        assert ct.n_params() == cj.n_params()
        assert ct.n_active_params() == cj.n_active_params()
    assert (t.vocab, t.tie_embeddings, t.qkv_bias) == \
        {VLM: (151655, False, False), AUDIO: (51865, False, False)}[name]


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_tree_matches_reference(np_params, name):
    tcfg = get_config(name).reduced()
    tp = bridge.to_numpy_tree(
        TM.init_params(tcfg, generator=torch.Generator().manual_seed(0)))
    shapes = lambda t: {k: v.shape for k, v in _leaves(t).items()}
    assert shapes(tp) == shapes(np_params[name])
    if name == AUDIO:
        assert set(tp) == {"embed", "final_norm", "enc_blocks", "enc_norm",
                           "blocks"}
        assert set(tp["blocks"]["mlp"]) == set(tp["enc_blocks"]["mlp"]) \
            == {"up", "down"}
        assert tp["blocks"]["xattn"]["k"]["a"].shape == (2, 64, 4)
        assert tp["enc_blocks"]["attn"]["q"]["w"].shape == (2, 64, 64)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("method", ["int8", "nf4"])
def test_quantized_init_is_the_reference_s_bytes(name, method):
    """The reference's quantized init against the port's quantize_params
    over the same dense tree, and the port's own init(quantize=) against
    its dense init quantized: every code and scale equal."""
    jcfg = jax_config(name).reduced()
    want = bridge.from_numpy_tree(_np(JM.init_params(
        jax.random.PRNGKey(0), jcfg, quantize=method)))
    dense = bridge.from_numpy_tree(_np(JM.init_params(
        jax.random.PRNGKey(0), jcfg)))
    got = quant.quantize_params(dense, method)
    assert _leaves(got).keys() == _leaves(want).keys()
    for k, w in _leaves(want).items():
        assert torch.equal(_leaves(got)[k], w), k
    tcfg = get_config(name).reduced()
    gen = lambda: torch.Generator().manual_seed(0)
    own = TM.init_params(tcfg, generator=gen(), quantize=method)
    ref = quant.quantize_params(TM.init_params(tcfg, generator=gen()), method)
    for k, w in _leaves(ref).items():
        assert torch.equal(_leaves(own)[k], w), k
    assert quant.tree_method(own) == method


# ----------------------------------------------------------------- forward


@pytest.fixture(scope="module")
def jax_outputs(np_params):
    """{arch: (logits, {(n, policy kw): (loss, {path: grad})})} from the
    reference's structured backend."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_config(arch).reduced()
        jp = _jnp(np_params[arch])
        batch = _batch(arch)
        logits = np.asarray(JM.forward(
            jp, jcfg, jnp.asarray(batch["tokens"]),
            **{k: jnp.asarray(v) for k, v in _extras(batch).items()}))
        grads = {}
        for n, kw in ((N, ()), (N, tuple(CHUNKED.items())), (FLASH_N, ())):
            jb = _jbatch(_batch(arch, n, FLASH_T if n == FLASH_N else None))
            pol = JaxPolicy(backend="structured", **dict(kw))
            loss, g = jax.jit(lambda p, b: jmesp.value_and_grad(
                p, jcfg, b, policy=pol))(jp, jb)
            grads[n, kw] = (float(loss), {
                k: np.asarray(v) for k, v in _leaves(g).items()
                if v is not None})
        out[arch] = (logits, grads)
    return out


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("backend", ["plain", "structured", "cuda"])
def test_forward_logits_match_reference(np_params, jax_outputs, name,
                                        backend):
    """Logits of the whole sequence (vlm: [B, 4 + 12, V], the prefix's
    rows included); the kernels' plain versions launch nothing on the
    CPU."""
    batch = _tbatch(_batch(name))
    tops.reset_launch_counts()
    got = TM.forward(bridge.from_numpy_tree(np_params[name]),
                     get_config(name).reduced(), batch["tokens"],
                     policy=ExecutionPolicy(backend=backend),
                     **_extras(batch))
    want = jax_outputs[name][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert set(tops.launch_counts().values()) == {0}


def _check_grads(np_params, jax_outputs, name, engine, n, kw=()):
    backend = ENGINES[engine]
    wloss, wgrads = jax_outputs[name][1][n, kw]
    batch = _tbatch(_batch(name, n, FLASH_T if n == FLASH_N else None))
    loss, grads = mesp.value_and_grad(
        bridge.from_numpy_tree(np_params[name]), get_config(name).reduced(),
        batch, policy=ExecutionPolicy(backend=backend, **dict(kw)))
    np.testing.assert_allclose(float(loss), wloss, rtol=1e-5)
    got = {k: v.numpy() for k, v in _leaves(grads).items() if v is not None}
    assert got.keys() == wgrads.keys()
    if name == AUDIO:      # the encoder's leaves get their gradients too
        assert sum(k.startswith("/enc_blocks/") for k in got) == 12
        assert any(k.startswith("/blocks/xattn/") for k in got)
    for k, w in wgrads.items():
        assert _rel(got[k], w) < 1e-5, (k, _rel(got[k], w))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_lora_grads_match_reference(np_params, jax_outputs, name, engine):
    """One value_and_grad per engine (mesp_cuda: the kernels' plain
    versions on the CPU) against the reference's; the loss over the
    prefix's -1 labels."""
    _check_grads(np_params, jax_outputs, name, engine, N)


@pytest.mark.parametrize("name", ARCHS)
def test_lora_grads_through_the_flash_function(np_params, jax_outputs,
                                               name):
    """mesp_cuda at 64 text tokens (Whisper over 72 frames): every
    attention, the encoder's non-causal one and the 64 x 72 cross one
    included, runs the flash Function (its plain versions on the CPU)."""
    _check_grads(np_params, jax_outputs, name, "mesp_cuda", FLASH_N)


@pytest.mark.parametrize("name", ARCHS)
def test_chunked_flash_matches_reference(np_params, jax_outputs, name):
    """The structured backend's chunked flash (``core/flash.py``) from 4
    rows in chunks of 3, against the reference under the same policy:
    ragged and non-causal chunks, and cross-attention over ragged key
    chunks."""
    _check_grads(np_params, jax_outputs, name, "mesp", N,
                 tuple(CHUNKED.items()))


def test_zo_probes_take_the_frames(np_params):
    """The ZO engines' forwards take the batch's frames: mezo's projection
    (L+ - L-) / 2 eps along its probe z equals <grad, z> of mesp's exact
    gradient on the same batch."""
    cfg = get_config(AUDIO).reduced()
    params = bridge.from_numpy_tree(np_params[AUDIO])
    batch = _tbatch(_batch(AUDIO))
    _, g = mesp.value_and_grad(params, cfg, batch)
    train, _ = TM.split_params(params)
    z = samplers.DenseSampler().sample(7, train)
    dot = lambda u, v: sum(float((a.double() * b.double()).sum())
                           for a, b in zip(_leaves(u).values(),
                                           _leaves(v).values())
                           if a is not None and b is not None)
    _, est = estimator.spsa_grad(params, cfg, batch, 7)
    proj = dot(est, z) / dot(z, z)
    assert abs(proj - dot(g, z)) < 1e-2 * abs(dot(g, z))


# ------------------------------------------------------------------ decode

STEPS, MAX_LEN = 8, 16


def test_whisper_decode_matches_reference(np_params):
    """Single-stream decode with ``cache["enc_out"]`` set to the
    reference encoder's output over the same frames: logits at every step
    equal the reference's decode_step's, greedy tokens fed back."""
    jcfg, tcfg = jax_config(AUDIO).reduced(), get_config(AUDIO).reduced()
    jp, tp = _jnp(np_params[AUDIO]), bridge.from_numpy_tree(np_params[AUDIO])
    frames = _batch(AUDIO)["enc_frames"]
    enc = JM._encoder_forward(jp, jcfg, jnp.asarray(frames), JaxPolicy())
    jc = JM.init_cache(jcfg, B, MAX_LEN)
    jc["enc_out"] = enc
    tc = TM.init_cache(tcfg, B, MAX_LEN, per_slot=False)
    tc["enc_out"] = torch.from_numpy(np.asarray(enc))
    np.testing.assert_allclose(
        TM._encoder_forward(tp, tcfg, torch.from_numpy(frames),
                            ExecutionPolicy()).detach().numpy(),
        np.asarray(enc), **TOL)
    step = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    tok = np.ones((B, 1), np.int32)
    for s in range(STEPS):
        want, jc = step(jp, jc, jnp.asarray(tok))
        got, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long(),
                                 policy=ExecutionPolicy(backend="cuda"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {s}", **TOL)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_decode_matches_forward(np_params, name, backend):
    """Decoding 12 tokens one at a time gives the forward's logits: Whisper
    single-stream over ``enc_out`` from the port's own encoder on the
    forward's frames; InternVL per slot on text alone (decode has no
    prefix, as in the reference)."""
    cfg = get_config(name).reduced()
    tp = bridge.from_numpy_tree(np_params[name])
    batch = _tbatch(_batch(name))
    pol = ExecutionPolicy(backend=backend)
    toks = batch["tokens"]
    if name == AUDIO:
        want = TM.forward(tp, cfg, toks, policy=pol,
                          enc_frames=batch["enc_frames"])
        cache = TM.init_cache(cfg, B, N, per_slot=False)
        cache["enc_out"] = TM._encoder_forward(tp, cfg, batch["enc_frames"],
                                               pol).detach()
    else:
        want = TM.forward(tp, cfg, toks, policy=pol)
        cache = TM.init_cache(cfg, B, N)
    got = [TM.decode_step(tp, cfg, cache, toks[:, t:t + 1], policy=pol)[0]
           for t in range(N)]
    np.testing.assert_allclose(torch.cat(got, 1).numpy(),
                               want.detach().numpy(), rtol=1e-4, atol=1e-4)


def _reqs(cls, n, n_tenants, prompt_len=5, max_new=6):
    return [cls(f"r{i}", f"u{i % n_tenants}",
                tuple(1 + (3 * i + j) % 89 for j in range(prompt_len)),
                max_new) for i in range(n)]


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_vlm_batcher_matches_reference(np_params, backend):
    """InternVL through the ContinuousBatcher (per-slot caches, adapter
    routing over 4 tenants and 3 resident slots): tokens and counters
    equal the reference's; no launch on the CPU."""
    from repro.serve import synthetic_adapters as jax_adapters
    jcfg, tcfg = jax_config(VLM).reduced(), get_config(VLM).reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy_tree(_np(jparams))
    kw = dict(slots=4, tile=2, max_len=16, page_size=4)
    jbat = JaxBatcher(jcfg, JaxStore(jparams, capacity=3), **kw)
    tbat = ContinuousBatcher(tcfg, AdapterStore(tparams, capacity=3),
                             policy=ExecutionPolicy(backend=backend), **kw)
    for i in range(4):
        ad = jax_adapters(jparams, i)
        jbat.register_adapter(f"u{i}", ad)
        tbat.register_adapter(f"u{i}", bridge.from_numpy_tree(_np(ad)))
    want = jbat.run(_reqs(JaxRequest, 6, 4))
    tops.reset_launch_counts()
    assert tbat.run(_reqs(Request, 6, 4)) == want
    _same_metrics(tbat.metrics(), jbat.metrics())
    assert set(tops.launch_counts().values()) == {0}


# -------------------------------------------------------------------- CLIs

SERVE = ["--reduced", "--device", "cpu", "--batch", "2", "--max-len", "16"]


def test_vlm_serve_cli_batches_as_the_reference():
    """``--arch internvl2-1b --adapters 3`` takes the continuous batcher;
    the reference's batcher over the same params, adapters and trace
    (warmup request, counters zeroed after it) gives the same tokens and
    metrics; mesp gives mesp_cuda's tokens."""
    argv = ["--arch", VLM, *SERVE, "--adapters", "3", "--tile", "1",
            "--requests", "4", "--prompt-len", "3", "--max-new", "4"]
    out = tserve.serve(argv)
    assert out["mode"] == "continuous" and out["tokens"] == 16
    jcfg = jax_config(VLM).reduced()
    jparams = _jnp(bridge.to_numpy_tree(out["params"]))
    jstore = JaxStore(jparams, capacity=3)
    jbat = JaxBatcher(jcfg, jstore, slots=2, tile=1, max_len=16,
                      page_size=16)
    uids = [f"tenant{i}" for i in range(3)]
    for i, u in enumerate(uids):
        jbat.register_adapter(u, _jnp(bridge.to_numpy_tree(
            synthetic_adapters(out["params"], i))))
    jbat.run([JaxRequest("warmup", uids[0], (1, 2, 3), 2)])
    for c in (jbat.counters, jstore.counters, jbat.alloc.counters):
        c.update({k: 0 for k in c})
    jbat.results.clear()
    want = jbat.run([JaxRequest(r.rid, r.adapter, r.prompt, r.max_new)
                     for r in tserve.request_trace(4, uids, 3, 4)])
    bat = out["batcher"]
    assert bat.results == want
    _same_metrics(bat.metrics(), jbat.metrics())
    assert tserve.serve(argv + ["--engine", "mesp"])["batcher"].results \
        == bat.results


def test_audio_serve_cli_decodes_single_stream(np_params):
    """``--arch whisper-tiny`` takes DecodeServer (zero ``enc_out``, as the
    reference's): mesp gives mesp_cuda's tokens; and on bridged weights the
    port's DecodeServer gives the reference's tokens and logits."""
    argv = ["--arch", AUDIO, *SERVE, "--steps", "5"]
    out = tserve.serve(argv)
    assert out["mode"] == "single_stream" and out["tokens"] == 10
    assert not bool(out["server"].cache["enc_out"].any())
    assert torch.equal(tserve.serve(argv + ["--engine", "mesp"])["samples"],
                       out["samples"])
    jcfg, tcfg = jax_config(AUDIO).reduced(), get_config(AUDIO).reduced()
    jserver = JaxDecodeServer(jcfg, _jnp(np_params[AUDIO]), B, MAX_LEN,
                              policy=JaxPolicy())
    server = tserve.DecodeServer(tcfg, bridge.from_numpy_tree(
        np_params[AUDIO]), B, MAX_LEN, ExecutionPolicy(backend="cuda"))
    jtok, tok = jnp.ones((B, 1), jnp.int32), torch.ones((B, 1),
                                                        dtype=torch.long)
    for _ in range(4):
        want, jserver.cache = jserver._step(jserver.params, jserver.cache,
                                            jtok)
        jtok = jnp.argmax(want, -1).astype(jnp.int32)
        tok = server.step(tok)
        np.testing.assert_allclose(server.last_logits.numpy(),
                                   np.asarray(want), **TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_vlm_train_cli_gives_one_loss_curve():
    """The train CLI trains InternVL on text (the data pipeline yields no
    patch embeddings, as the reference's): mesp_cuda, mesp and mebp give
    the same f32 losses."""
    argv = ["--arch", VLM, "--reduced", "--device", "cpu", "--seq", "12",
            "--steps", "2", "--lr", "0.1"]
    runs = {e: ttrain.train(argv + ["--engine", e])["losses"]
            for e in ("mesp_cuda", "mesp", "mebp")}
    assert all(np.isfinite(runs["mesp"]))
    for e in ("mesp_cuda", "mebp"):
        np.testing.assert_allclose(runs[e], runs["mesp"], rtol=1e-5)


# ---------------------------------------------------------------- refusals


def test_refusals_match_the_reference(np_params):
    """An audio forward without frames, a per-slot audio cache, mesp_seq
    for either family, the train CLI on Whisper (no frames in the data
    pipeline) and ``--adapters 2`` for audio are refused, as the reference
    refuses them (it asserts where the port raises ValueError)."""
    import repro.api.engines  # noqa: F401  (registers the engines)
    import repro_torch.api.engines  # noqa: F401
    from repro.api import registry as jreg
    from repro_torch.api import registry as treg
    jcfg, tcfg = jax_config(AUDIO).reduced(), get_config(AUDIO).reduced()
    toks = np.ones((B, 4), np.int32)
    with pytest.raises(AssertionError, match="enc_frames"):
        JM.forward(_jnp(np_params[AUDIO]), jcfg, jnp.asarray(toks))
    with pytest.raises(ValueError, match="enc_frames"):
        TM.forward(bridge.from_numpy_tree(np_params[AUDIO]), tcfg,
                   torch.from_numpy(toks).long())
    for init, cfg in ((JM.init_cache, jcfg), (TM.init_cache, tcfg)):
        with pytest.raises(ValueError, match="per_slot"):
            init(cfg, B, 8, per_slot=True)
    spec = dataclasses.make_dataclass("Spec", ["optimizer", "lr"])("sgd", 0.1)
    for name in ARCHS:
        for reg, cfg in ((treg, get_config(name).reduced()),
                         (jreg, jax_config(name).reduced())):
            with pytest.raises(ValueError, match="non-patterned"):
                reg.get_engine("mesp_seq").build_step(spec, cfg, None, None)
    with pytest.raises(ValueError, match="enc_frames"):
        ttrain.train(["--arch", AUDIO, "--reduced", "--device", "cpu",
                      "--seq", "8", "--steps", "1"])
    with pytest.raises(SystemExit):        # argparse error, as the reference
        tserve.serve(["--arch", AUDIO, *SERVE, "--adapters", "2"])
    with pytest.raises(ValueError, match="adapter routing unsupported"):
        TM.decode_step(bridge.from_numpy_tree(np_params[AUDIO]), tcfg,
                       TM.init_cache(tcfg, B, 8, per_slot=False),
                       torch.ones((B, 1), dtype=torch.long),
                       adapter_tiles=torch.zeros(1, dtype=torch.int32))
