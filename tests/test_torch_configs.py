"""The dense configs the port takes from the reference's catalog
(gemma3-12b, granite-8b, minitron-4b, qwen2.5-32b): their fields, their
``reduced()`` cut and parameter counts against the reference's; the
quantized base, the in-place quantize rung and checkpoints over Gemma3's
grouped ``[n_groups, period, K, N]`` leaves against the reference's bytes;
and each arch through the train and serve CLIs at its reduced size on the
CPU, where the kernel engine (plain versions) must give the plain
engines' losses and tokens."""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import quant
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM

NEW = ("gemma3-12b", "granite-8b", "minitron-4b", "qwen2.5-32b")
GEMMA = get_config("gemma3-12b").reduced()


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", NEW)
def test_config_matches_reference(name):
    """Every field the port keeps, for the full config and its reduced
    cut (gemma3's to a (local 8, global) period of 2 layers), each layer's
    window, and the parameter counts. ``subquadratic`` (read only by the
    reference's long-context cells) is not kept."""
    j, t = jax_config(name), get_config(name)
    assert name in REGISTRY
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for f in dataclasses.fields(ct):
            if f.name != "lora":
                assert getattr(ct, f.name) == getattr(cj, f.name), \
                    (name, f.name)
        assert (ct.lora.rank, ct.lora.alpha, ct.lora.targets) == \
            (cj.lora.rank, cj.lora.alpha, cj.lora.targets)
        assert ct.resolved_head_dim == cj.resolved_head_dim
        assert [ct.layer_window(i) for i in range(ct.n_layers)] == \
            [cj.layer_window(i) for i in range(cj.n_layers)]
        assert ct.n_params() == cj.n_params()
        assert ct.n_active_params() == cj.n_active_params()


def _gemma_np(quantize=None):
    jcfg = jax_config("gemma3-12b").reduced()
    return jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg,
                                   quantize=quantize))


@pytest.mark.parametrize("method", ["int8", "int4", "nf4"])
def test_quantized_groups_are_the_reference_s_bytes(method):
    """The reference's quantized init against the port's quantize_params
    over the same dense tree, and the port's own init(quantize=) against
    its dense init quantized: every [1, 2, K, N] code and scale equal."""
    want = bridge.from_numpy_tree(_gemma_np(method))
    dense = bridge.from_numpy_tree(_gemma_np())
    got = quant.quantize_params(dense, method)
    _assert_same(got, want)
    assert got["groups"]["mlp"]["up"]["w"]["scale"].shape[:2] == (1, 2)
    gen = lambda: torch.Generator().manual_seed(0)
    _assert_same(TM.init_params(GEMMA, generator=gen(), quantize=method),
                 quant.quantize_params(TM.init_params(GEMMA, generator=gen()),
                                       method))


@pytest.mark.parametrize("steps", [("none", "int8"), ("int8", "int4"),
                                   ("none", "nf4"), ("nf4", "int8")])
def test_in_place_quantize_rung_over_groups(steps):
    """The degradation ladder's quantize rung (in place, one matrix of a
    stack at a time) on the grouped leaves gives quantize_params' codes."""
    src = quant.quantize_params(
        TM.init_params(GEMMA, generator=torch.Generator().manual_seed(0)),
        steps[0])
    want = quant.quantize_params(src, steps[1])
    got = quant.quantize_frozen_(copy.deepcopy(src), method=steps[1])
    _assert_same(got, want)
    assert quant.tree_method(got) == steps[1]


@pytest.mark.parametrize("method", [None, "nf4"])
def test_checkpoint_over_groups_is_the_reference_s(tmp_path, method):
    """A checkpoint of the grouped tree: the same files and digests as the
    reference's, and a bit-for-bit round trip."""
    jp = JM.init_params(jax.random.PRNGKey(0),
                        jax_config("gemma3-12b").reduced(), quantize=method)
    tp = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    jsave(str(tmp_path / "jax"), 2, jp, {"step": jnp.asarray(2, jnp.int32)})
    save_checkpoint(str(tmp_path / "torch"), 2, tp,
                    {"step": torch.tensor(2, dtype=torch.int32)})
    man = [json.load(open(tmp_path / d / "step_00000002" / "manifest.json"))
           for d in ("torch", "jax")]
    assert man[0]["arrays"] == man[1]["arrays"]
    assert sorted(os.listdir(tmp_path / "torch" / "step_00000002")) == \
        sorted(os.listdir(tmp_path / "jax" / "step_00000002"))
    _assert_same(load_checkpoint(str(tmp_path / "torch"), 2, tp)[0], tp)


@pytest.mark.parametrize("arch", NEW)
def test_train_cli_gives_one_loss_curve(arch):
    """2 SGD steps of each arch at its reduced size, seq 20 (over twice
    Gemma3's reduced window): mesp_cuda (the kernels' plain versions),
    mesp and mebp give the same f32 losses."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "20",
            "--steps", "2", "--lr", "0.1"]
    runs = {e: ttrain.train(argv + ["--engine", e])["losses"]
            for e in ("mesp_cuda", "mesp", "mebp")}
    assert all(np.isfinite(runs["mesp"]))
    for e in ("mesp_cuda", "mebp"):
        np.testing.assert_allclose(runs[e], runs["mesp"], rtol=1e-5)


@pytest.mark.parametrize("arch,quantize", [("gemma3-12b", "none"),
                                           ("gemma3-12b", "nf4"),
                                           ("granite-8b", "none")])
def test_serve_cli_gives_one_token_stream(arch, quantize):
    """The serve CLI at the reduced size: requests of 14 tokens (past
    Gemma3's reduced window of 8), mesp_cuda and mesp give the same
    tokens."""
    argv = ["--arch", arch, "--device", "cpu", "--reduced", "--adapters",
            "3", "--batch", "4", "--tile", "2", "--requests", "5",
            "--prompt-len", "6", "--max-new", "8", "--max-len", "16",
            "--quantize", quantize]
    out = tserve.serve(argv)
    assert out["requests"] == 5 and out["tokens"] == 40
    plain = tserve.serve(argv + ["--engine", "mesp"])
    assert plain["batcher"].results == out["batcher"].results
