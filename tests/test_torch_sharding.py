"""The port's placement rules and the model axis's refusals
(``launch/sharding.py``, ``launch/mesh.py``, ``api/spec.check_model_axis``,
the launcher under ``torchrun``) against the reference, on the CPU.

The port's specs equal the reference's ``param_specs``, ``opt_specs``,
``cache_specs``, ``batch_spec`` and ``activation_spec`` leaf by leaf, for
every config of the catalog over none, int8 and nf4 at model axes of 1,
2, 4 and 16 (the reference's abstract ``fake_mesh``; its trees through
``jax.eval_shape``, the port's on the ``meta`` device). Training under
the model axis is held in ``test_torch_tensor_parallel.py``.
"""
import dataclasses
import functools
import types

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.models import model as jmodel
from repro.optim import optimizers as joptim
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.api.spec import TrainSpec, check_model_axis
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import quant
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as toptim
from repro_torch.optim.schedules import constant
from repro_torch.tree import leaves_with_paths, tree_map

BASES = ("none", "int8", "nf4")


# ------------------------------------------------------------ placement
def _norm_spec(spec):
    """A spec as a tuple, an axis tuple of one name as that name (a
    PartitionSpec may normalise either way)."""
    out = []
    for ax in tuple(spec):
        if isinstance(ax, (tuple, list)):
            ax = tuple(ax)
            ax = ax[0] if len(ax) == 1 else ax
        out.append(ax)
    return tuple(out)


def _jax_specs(tree):
    """{path: spec} of a reference spec tree."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            _norm_spec(s) for p, s in flat}


def _port_specs(tree, specs):
    """{path: spec} of the port's spec tree, walked along ``tree`` (its
    leaves are tuples, which the tree walkers would enter)."""
    def at(t, path):
        for k in path:
            t = t[k]
        return t
    return {p: _norm_spec(at(specs, p))
            for p, _ in leaves_with_paths(tree)}


@functools.lru_cache(maxsize=None)
def _abstract(arch, quantize):
    """(reference params, reference adamw state, port params, port adamw
    state, reference cfg, port cfg) without memory: the reference's
    through ``jax.eval_shape``, the port's on ``meta``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg, tcfg = jget_config(arch), get_config(arch)
    q = None if quantize == "none" else quantize
    jp = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                   jcfg, quantize=q))
    jo = jax.eval_shape(lambda: joptim.make_optimizer("adamw", 1e-3).init(
        jmodel.init_params(jax.random.PRNGKey(0), jcfg, quantize=q)))
    with FakeTensorMode():
        fake = tmodel.init_params(tcfg, generator=torch.Generator())
    tp = quant.quantize_params(tree_map_meta(fake), quantize)
    to = toptim.make_optimizer("adamw", constant(1e-3)).init(tp)
    return jp, jo, tp, to, jcfg, tcfg


def tree_map_meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _port_mesh(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model})


@pytest.mark.parametrize("quantize", BASES)
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_placement_specs_are_the_reference_s(fake_mesh, arch, quantize):
    jp, jo, tp, to, jcfg, tcfg = _abstract(arch, quantize)
    for model in (1, 2, 4, 16):
        jm, pm = fake_mesh(2, model), _port_mesh(2, model)
        want = _jax_specs(jsh.param_specs(jcfg, jp, jm))
        got = _port_specs(tp, tsh.param_specs(tcfg, tp, pm))
        assert got == want, (arch, quantize, model)
        want = _jax_specs(jsh.opt_specs(jcfg, jo, jm))
        got = _port_specs(to, tsh.opt_specs(tcfg, to, pm))
        got = {p: s for p, s in got.items()}
        assert got == {p: s for p, s in want.items() if p in got}, (
            arch, quantize, model)
        assert set(want) - set(got) <= {("step",)}
    if quantize != "none":
        return
    # decode caches, the batch and the block-boundary activations
    per_slot = tcfg.family in ("dense", "vlm", "moe")
    for batch in (1, 4):
        jc = jax.eval_shape(lambda: jmodel.init_cache(
            jcfg, batch, 64, per_slot=per_slot))
        tc = tmodel.init_cache(tcfg, batch, 64, device="meta",
                               per_slot=per_slot)
        for data, model in ((2, 2), (1, 16), (4, 4)):
            jm, pm = fake_mesh(data, model), _port_mesh(data, model)
            want = _jax_specs(jsh.cache_specs(jcfg, jc, jm, batch))
            got = _port_specs(tc, tsh.cache_specs(tcfg, tc, pm, batch))
            assert got == want, (arch, batch, data, model)
            assert _norm_spec(tsh.batch_spec(pm, batch)) == _norm_spec(
                jsh.batch_spec(jm, batch))
            for on in (True, False):
                assert _norm_spec(tsh.activation_spec(
                    pm, batch, seq_on_model=on)) == _norm_spec(
                    jsh.activation_spec(jm, batch, seq_on_model=on))


# ------------------------------------------------------------ the mesh
def test_production_mesh_geometry(monkeypatch):
    monkeypatch.setattr(tmesh, "world_size", lambda: 512)
    one = tmesh.make_production_mesh()
    two = tmesh.make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model")
    assert one.shape == {"data": 16, "model": 16}
    assert one.rank_list == list(range(256))
    assert two.axis_names == ("pod", "data", "model")
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.model_ranks(0) == list(range(16))
    assert two.data_ranks(3) == list(range(3, 512, 16))
    assert two.coords(37) == (2, 5)
    monkeypatch.setattr(tmesh, "world_size", lambda: 255)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "recurrentgemma-2b",
                                  "internvl2-1b", "whisper-tiny"])
def test_other_families_are_refused_at_mp_2(arch):
    with pytest.raises(ValueError, match="item 3"):
        TrainSpec(arch=arch, model_parallel=2, reduced=True).validate()


@pytest.mark.parametrize("change,mp,name", [
    ({}, 3, "n_heads = 4"), ({"n_heads": 8, "n_kv_heads": 2}, 4,
                             "n_kv_heads = 2"),
    ({"d_ff": 129}, 2, "d_ff = 129"), ({"vocab": 255}, 2, "vocab = 255")])
def test_an_axis_that_splits_a_dim_is_refused(change, mp, name):
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b").reduced(), **change)
    with pytest.raises(ValueError, match=name):
        check_model_axis(cfg, mp)


def test_the_model_axis_refuses_engines_odd_packed_shards_and_sp_alone():
    cfg = get_config("qwen2.5-0.5b").reduced()
    for engine in ("mesp_seq", "mezo", "mezo_avg4"):
        with pytest.raises(ValueError, match="item 3"):
            check_model_axis(cfg, 2, engine)
    odd = dataclasses.replace(cfg, d_ff=130)
    check_model_axis(odd, 2, "mesp", "int8")
    with pytest.raises(ValueError, match="odd"):
        check_model_axis(odd, 2, "mesp", "nf4")
    with pytest.raises(ValueError, match="needs a model axis"):
        ExecutionPolicy(sp=True)
    for mp in (1, 2):
        check_model_axis(get_config("qwen2.5-0.5b"), mp, "mesp_cuda", "nf4")


def test_launcher_refuses_more_ranks_than_cards(monkeypatch):
    """``--device cuda`` under torchrun runs one card a rank over nccl: a
    host with more ranks than visible cards raises, it never falls back
    to gloo or the CPU."""
    from repro_torch.launch import train as ttrain
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ttrain.dist, "is_nccl_available", lambda: True)
    with pytest.raises(RuntimeError, match="one card a rank: 2 ranks"):
        ttrain.join_process_group("cuda")
    with pytest.raises(ValueError, match="bare loop"):
        ttrain.train(["--reduced", "--device", "cpu", "--model-parallel",
                      "2"])
