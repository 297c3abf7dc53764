"""The port's serving subsystem: store and page-ledger units (ported from
``tests/test_serving.py``), the continuous batcher against the JAX
reference's, the CLI, and the import hygiene of the package."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serve import AdapterStore as JaxStore
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import synthetic_adapters as jax_adapters
from repro_torch import bridge
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import (AdapterStore, ContinuousBatcher,
                               PagedKVAllocator, Request, StoreFull,
                               synthetic_adapters)

ROOT = Path(__file__).resolve().parents[1]
JCFG = jax_config("qwen2.5-0.5b").reduced()
CFG = get_config("qwen2.5-0.5b").reduced()


@pytest.fixture(scope="module")
def params():
    return TM.init_params(CFG, generator=torch.Generator().manual_seed(0))


def _reqs(cls, n, n_tenants, prompt_len=3, max_new=5):
    return [cls(f"r{i}", f"u{i % n_tenants}",
                tuple(1 + (2 * i + j) % 89 for j in range(prompt_len)),
                max_new) for i in range(n)]


# ---------------------------------------------------------------- allocator


def test_paged_allocator_ledger():
    al = PagedKVAllocator(n_pages=4, page_size=8)
    assert al.pages_for(1) == 1 and al.pages_for(8) == 1
    assert al.pages_for(9) == 2
    assert al.reserve("a", 17)                 # 3 pages
    assert al.used_pages == 3 and al.free_tokens == 8
    assert not al.reserve("b", 9)              # needs 2, only 1 free
    assert al.counters["rejected"] == 1
    assert al.reserve("b", 8)
    assert al.counters["peak_pages"] == 4
    with pytest.raises(KeyError):
        al.reserve("a", 1)                     # double reservation
    al.free("a")
    assert al.used_pages == 1 and al.counters["freed"] == 3
    assert al.can_reserve(24)


# -------------------------------------------------------------------- store


def test_store_stacks_tenant_axis_before_matrix_dims(params):
    store = AdapterStore(params, capacity=3)
    blk = store.params["blocks"]["attn"]["q"]
    base = params["blocks"]["attn"]["q"]
    assert blk["a"].shape == base["a"].shape[:-2] + (3,) + base["a"].shape[-2:]
    assert blk["w"] is base["w"]                   # frozen leaves shared
    assert store.slot_bytes > 0
    assert store.allocated_bytes == 3 * store.slot_bytes


def test_store_lru_eviction_and_pinning(params):
    store = AdapterStore(params, capacity=2)
    adapters = {u: synthetic_adapters(params, i)
                for i, u in enumerate(["u0", "u1", "u2"])}
    s0 = store.acquire("u0", adapters["u0"], pin=False)
    store.acquire("u1", adapters["u1"], pin=False)
    store.acquire("u0", adapters["u0"], pin=False)     # refresh u0's recency
    assert store.counters["hits"] == 1
    s2 = store.acquire("u2", adapters["u2"], pin=False)
    assert s2 == store.lookup("u2")
    assert store.lookup("u1") is None                  # u1 was LRU, evicted
    assert store.lookup("u0") == s0
    assert store.counters["evictions"] == 1
    a_stack = store.params["blocks"]["attn"]["q"]["a"]
    want = adapters["u2"]["blocks"]["attn"]["q"]["a"]
    torch.testing.assert_close(a_stack[:, s2], want, rtol=0, atol=0)


def test_store_pin_blocks_eviction(params):
    store = AdapterStore(params, capacity=2)
    store.acquire("u0", synthetic_adapters(params, 0))
    store.acquire("u1", synthetic_adapters(params, 1))
    assert not store.can_admit("u2")
    with pytest.raises(StoreFull):
        store.acquire("u2", synthetic_adapters(params, 2))
    store.release("u1")
    assert store.can_admit("u2")
    store.acquire("u2", synthetic_adapters(params, 2))
    assert store.lookup("u1") is None


def test_store_rejects_moe_and_missing_leaves(params):
    moe = {"blocks": {"moe": {"up": {"w": torch.zeros(2, 4, 4),
                                     "a": torch.zeros(2, 4, 2),
                                     "b": torch.zeros(2, 2, 4)}}}}
    with pytest.raises(ValueError, match="MoE"):
        AdapterStore(moe, capacity=2)
    with pytest.raises(ValueError, match="missing LoRA"):
        AdapterStore(params, capacity=1).acquire("u0", {"blocks": {}})
    with pytest.raises(ValueError, match="no LoRA"):
        AdapterStore({"w": torch.zeros(2, 2)}, capacity=1)


def test_synthetic_adapters_deterministic_and_distinct(params):
    a0 = synthetic_adapters(params, 0)
    a0b = synthetic_adapters(params, 0)
    a1 = synthetic_adapters(params, 1)
    leaf = lambda t: t["blocks"]["attn"]["q"]["a"]
    assert torch.equal(leaf(a0), leaf(a0b))
    assert float((leaf(a0) - leaf(a1)).abs().max()) > 0
    assert a0["blocks"]["attn"]["q"]["w"] is params["blocks"]["attn"]["q"]["w"]


# ----------------------------------------------------------------- batcher


def test_batcher_validates_requests(params):
    bat = ContinuousBatcher(CFG, AdapterStore(params, 2), slots=4, tile=2,
                            max_len=16, page_size=8)
    bat.register_adapter("u0", synthetic_adapters(params, 0))
    with pytest.raises(ValueError, match="max_len"):
        bat.submit(Request("big", "u0", tuple(range(1, 10)), 10))
    with pytest.raises(KeyError, match="not registered"):
        bat.submit(Request("x", "nobody", (1, 2), 2))
    with pytest.raises(ValueError, match="multiple"):
        ContinuousBatcher(CFG, AdapterStore(params, 1), slots=5, tile=2)
    # the headroom gate is ported (tests/test_torch_serve_quant.py holds it
    # against the reference's); it charges the base in the policy's format
    bat = ContinuousBatcher(CFG, AdapterStore(params, 1), mem_budget_mb=10.0)
    assert bat.mem_budget_mb == 10.0 and bat.weights_fmt == "bf16"


def test_batcher_admission_rejections(params):
    store = AdapterStore(params, capacity=1)
    bat = ContinuousBatcher(CFG, store, slots=2, tile=2, max_len=16,
                            page_size=8)
    for i in range(2):
        bat.register_adapter(f"u{i}", synthetic_adapters(params, i))
    results = bat.run(_reqs(Request, 4, 2, prompt_len=2, max_new=3))
    assert len(results) == 4
    assert bat.counters["rejected_tiles"] > 0
    assert store.counters["evictions"] >= 1


@pytest.mark.parametrize("backend", ["structured", "cuda"])
def test_batcher_matches_reference(backend):
    """Same bridged params, same JAX-drawn adapters, same requests: the
    token streams and the serve.* / store.* / pages.* counters of the
    port's batcher equal the reference's."""
    jparams = JM.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    kw = dict(slots=8, tile=2, max_len=32, page_size=8)
    jbat = JaxBatcher(JCFG, JaxStore(jparams, capacity=3), **kw)
    tbat = ContinuousBatcher(CFG, AdapterStore(tparams, capacity=3),
                             policy=ExecutionPolicy(backend=backend), **kw)
    for i in range(4):
        ad = jax_adapters(jparams, i)
        jbat.register_adapter(f"u{i}", ad)
        tbat.register_adapter(f"u{i}", bridge.from_numpy_tree(
            jax.tree_util.tree_map(np.asarray, ad)))
    want = jbat.run(_reqs(JaxRequest, 8, 4))
    tops.reset_launch_counts()
    got = tbat.run(_reqs(Request, 8, 4))
    assert got == want
    assert tbat.metrics() == jbat.metrics()
    assert tbat.metrics()["store.evictions"] >= 1      # 4 tenants, 3 slots
    assert set(tops.launch_counts().values()) == {0}


# --------------------------------------------------------------------- CLI


def test_serve_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--reduced", "--adapters", "2"])


def test_serve_cli_on_cpu_serves_to_completion():
    argv = ["--device", "cpu", "--reduced", "--adapters", "3", "--batch",
            "4", "--tile", "2", "--requests", "5", "--prompt-len", "3",
            "--max-new", "4", "--max-len", "16"]
    assert tserve.main(argv) == 0
    out = tserve.serve(argv)
    assert out["requests"] == 5 and out["tokens"] == 20
    bat = out["batcher"]
    assert bat.counters["completed"] == 5 and bat.active == 0
    plain = tserve.serve(argv + ["--engine", "mesp"])
    assert plain["batcher"].results == bat.results


# ----------------------------------------------------------------- hygiene


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('repro_torch.models.moe', 'repro_torch.configs.olmoe_1b_7b',"
        " 'repro_torch.configs.deepseek_moe_16b', 'repro_torch.zo.estimator',"
        " 'repro_torch.core.flash', 'repro_torch.api.registry',"
        " 'repro_torch.api.trainer', 'repro_torch.runtime.fault_tolerance',"
        " 'repro_torch.checkpoint.checkpointer',"
        " 'repro_torch.telemetry.memwatch'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "sys.exit('imported: %s' % bad if bad else 0)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"))
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert int(proc.stdout.split()[-1]) >= 65      # every module imported
