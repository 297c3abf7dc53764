"""The port's single-stream serving (``launch/serve.DecodeServer``) and the
serve CLI's dispatch against the JAX reference, at reduced size in f32;
and the continuous batcher's serve telemetry.

``DecodeServer`` decodes one batch at one shared position, greedy, over
the model's own LoRA factors: the MoE models (OLMoE-1B-7B, and
DeepSeekMoE-16B with its dense ``block0``), RWKV6-1.6B, RecurrentGemma-2B
and a dense model served without tenants (``--adapters 0``). Weights are
the reference's ``init_params`` with every LoRA B redrawn from numpy,
bridged through numpy; over 8 steps the greedy tokens equal the
reference's ``DecodeServer``'s and the logits agree at 1e-5, through the
plain forwards (``mesp``) and the kernels' plain versions
(``mesp_cuda``). RWKV6's logits are held at ``RWKV_DECODE_TOL``: its
reduced model is ill-conditioned in f32 at the group norm, and another
order of the same f32 sums lands up to 6.3e-5 away
(``tests/test_torch_recurrent.py`` measures it against f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.policy import ExecutionPolicy as JaxPolicy
from repro.configs import get_config as jax_config
from repro.launch.serve import DecodeServer as JaxDecodeServer
from repro.models import model as JM
from repro.serve import AdapterStore as JaxStore
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import synthetic_adapters as jax_adapters
from repro.telemetry import Telemetry as JaxTelemetry
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import AdapterStore, ContinuousBatcher, Request
from repro_torch.telemetry import Telemetry

ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b", "rwkv6-1.6b",
         "recurrentgemma-2b", "qwen2.5-0.5b")
BATCH, STEPS, MAX_LEN = 4, 8, 16
#: see the module's docstring
RWKV_DECODE_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_b(tree, rng):
    """Every LoRA B drawn at 0.02 (its size after fine-tuning from zero)."""
    if isinstance(tree, list):
        return [_with_b(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            if k == "b" else _with_b(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(arch, the reference's tokens [STEPS, B] and logits [STEPS, B, V])
    from its DecodeServer, and the params it served."""
    arch = request.param
    cfg = jax_config(arch).reduced()
    params = _with_b(_np(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)), np.random.default_rng(1))
    server = JaxDecodeServer(cfg, jax.tree_util.tree_map(jnp.asarray, params),
                             BATCH, MAX_LEN, policy=JaxPolicy())
    tok = jnp.ones((BATCH, 1), jnp.int32)
    toks, logits = [], []
    for _ in range(STEPS):
        lg, server.cache = server._step(server.params, server.cache, tok)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok)[:, 0])
        logits.append(np.asarray(lg)[:, 0])
    return arch, params, np.stack(toks), np.stack(logits)


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_decode_server_matches_reference(served, backend):
    """8 greedy steps from token 1: the same tokens, logits at 1e-5
    (RWKV6: ``RWKV_DECODE_TOL``); the kernels' plain versions launch no
    kernel on the CPU."""
    arch, params, want_toks, want_logits = served
    cfg = get_config(arch).reduced()
    server = tserve.DecodeServer(cfg, bridge.from_numpy_tree(params), BATCH,
                                 MAX_LEN, ExecutionPolicy(backend=backend))
    tops.reset_launch_counts()
    tok = torch.ones((BATCH, 1), dtype=torch.long)
    toks, logits = [], []
    for _ in range(STEPS):
        tok = server.step(tok)
        toks.append(tok[:, 0].numpy())
        logits.append(server.last_logits[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(toks), want_toks)
    tol = RWKV_DECODE_TOL if arch == "rwkv6-1.6b" else 1e-5
    np.testing.assert_allclose(np.stack(logits), want_logits, rtol=tol,
                               atol=tol)
    assert set(tops.launch_counts().values()) == {0}


# ------------------------------------------------------------------- CLI


def _cli(arch, *extra):
    return ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--steps", "5", "--max-len", "16", *extra]


@pytest.mark.parametrize("arch,adapters,mode", [
    ("olmoe-1b-7b", "1", "single_stream"),
    ("rwkv6-1.6b", "1", "single_stream"),
    ("recurrentgemma-2b", "0", "single_stream"),
    ("qwen2.5-0.5b", "0", "single_stream"),
    ("qwen2.5-0.5b", "1", "continuous"),
])
def test_serve_cli_dispatches_as_the_reference(arch, adapters, mode):
    """dense with --adapters >= 1 goes to the continuous batcher, every
    other case to single-stream decode; mesp_cuda (plain versions on the
    CPU) and mesp give the same tokens."""
    argv = _cli(arch, "--adapters", adapters)
    if mode == "continuous":
        argv += ["--requests", "1", "--max-new", "2"]
    out = tserve.serve(argv)
    assert out["mode"] == mode
    assert out["tok_s"] > 0 and out["ms_per_step"] > 0
    if mode == "single_stream":
        assert out["tokens"] == 2 * 5 and out["steps"] == 5
        assert tuple(out["samples"].shape) == (2, 5)
        plain = tserve.serve(argv + ["--engine", "mesp"])
        assert torch.equal(out["samples"], plain["samples"])


def test_serve_cli_errors():
    with pytest.raises(SystemExit):        # argparse error, as the reference
        tserve.serve(_cli("rwkv6-1.6b", "--adapters", "2"))
    with pytest.raises(SystemExit):        # the KV cache holds 16 positions
        tserve.serve(_cli("olmoe-1b-7b", "--steps", "16"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tserve.serve(["--arch", "rwkv6-1.6b", "--reduced"])


def test_decode_server_refuses_another_base_format():
    cfg = get_config("rwkv6-1.6b").reduced()
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            quantize="int8")
    with pytest.raises(ValueError, match="policy.quantize"):
        tserve.DecodeServer(cfg, params, 2, 8, ExecutionPolicy())


def test_per_slot_cache_unsupported_families():
    """``tests/test_serving.py``'s check on the port: no per-slot cache for
    ssm; an MoE's per-slot cache is fine, but its decode takes no adapter
    routing."""
    with pytest.raises(ValueError, match="per_slot"):
        TM.init_cache(get_config("rwkv6-1.6b").reduced(), 2, 16,
                      per_slot=True)
    moe_cfg = get_config("olmoe-1b-7b").reduced()
    moe_params = TM.init_params(moe_cfg,
                                generator=torch.Generator().manual_seed(0))
    cache = TM.init_cache(moe_cfg, 2, 16, per_slot=True)
    with pytest.raises(ValueError, match="adapter routing unsupported"):
        TM.decode_step(moe_params, moe_cfg, cache,
                       torch.ones((2, 1), dtype=torch.long),
                       adapter_tiles=torch.zeros(1, dtype=torch.int32))


# -------------------------------------------------------- serve telemetry


def _admissions(records):
    return [(r["action"], r["rid"], r["adapter"], r["reason"], r["step"])
            for r in records]


def test_batcher_admission_events_are_the_reference_s():
    """One trace over 2 slot tiles, 3 tenants and a store of 2, so requests
    are admitted, rejected (tiles, store) and completed: the sequence of
    AdmissionEvents, and the spans' names, equal the reference's."""
    jcfg = jax_config("qwen2.5-0.5b").reduced()
    tcfg = get_config("qwen2.5-0.5b").reduced()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_numpy_tree(_np(jparams))
    kw = dict(slots=4, tile=2, max_len=16, page_size=4)
    jtel, ttel = JaxTelemetry(enabled=True), Telemetry(enabled=True)
    jbat = JaxBatcher(jcfg, JaxStore(jparams, capacity=2), telemetry=jtel,
                      **kw)
    tbat = ContinuousBatcher(tcfg, AdapterStore(tparams, capacity=2),
                             telemetry=ttel, **kw)
    for i in range(3):
        ad = jax_adapters(jparams, i)
        jbat.register_adapter(f"u{i}", ad)
        tbat.register_adapter(f"u{i}", bridge.from_numpy_tree(_np(ad)))
    reqs = lambda cls: [cls(f"r{i}", f"u{i % 3}", (1 + i, 2), 2 + i % 2)
                        for i in range(6)]
    assert tbat.run(reqs(Request)) == jbat.run(reqs(JaxRequest))
    want = _admissions(jtel.events("admission"))
    assert {a for a, *_ in want} == {"admit", "reject", "complete"}
    assert _admissions(ttel.events("admission")) == want
    # both registries adopt their autotuner's counters: the same keys; the
    # values are each package's own module-global counts
    tm, jm = tbat.metrics(), jbat.metrics()
    tune = lambda m: {k for k in m if k.startswith("autotune.")}
    rest = lambda m: {k: v for k, v in m.items()
                      if not k.startswith("autotune.")}
    assert tune(tm) == tune(jm) and tune(tm)
    assert rest(tm) == rest(jm)
    names = lambda tel: sorted({s[0] for s in tel.tracer.finished})
    assert names(ttel) == names(jtel) == ["admission", "decode", "prefill"]
