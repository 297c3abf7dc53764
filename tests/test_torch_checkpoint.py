"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's layout (``repro.checkpoint``), on the CPU.

Trees of bf16, f32, int8 and packed nf4 leaves, with an optimizer state
whose frozen slots are ``None``, round-trip bit for bit (dtypes kept, the
nesting and the ``None`` slots rebuilt from the manifest). The same values
saved by either package give the same files and manifest entries: name,
tree, path, shape, dtype and ``sha256_16`` (bf16 is hashed as its raw
16-bit pattern, which is what the reference's ``arr.tobytes()`` reads).
A corrupt newest checkpoint is quarantined and the next-older one restored;
all corrupt raises ``IOError``; three are kept; a leftover ``.tmp``
directory is ignored; a template whose leaves differ from the checkpoint's
is refused.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.models import model as TM
from repro_torch.runtime.faults import corrupt_latest_checkpoint

CFG = get_config("qwen2.5-0.5b").reduced()
FORMATS = ["bfloat16", "float32", "int8", "nf4"]


def _params(fmt):
    cfg = dataclasses.replace(CFG, dtype="bfloat16" if fmt == "bfloat16"
                              else "float32")
    p = TM.init_params(cfg, generator=torch.Generator().manual_seed(0))
    return quant.quantize_params(p, fmt if fmt in quant.METHODS else "none")


def _moments(tree, gen):
    """An adamw-style moment tree: f32 at the LoRA leaves, None elsewhere."""
    return {k: _moments(v, gen) if isinstance(v, dict) and
            not (quant.is_quantized(v) or quant.is_packed(v)) else
            (torch.randn(v.shape, generator=gen) if k in ("a", "b")
             else None) for k, v in tree.items()}


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("fmt", FORMATS)
def test_round_trip_is_bit_for_bit(tmp_path, fmt):
    params = _params(fmt)
    gen = torch.Generator().manual_seed(1)
    opt = {"step": 5, "m": _moments(params, gen), "v": _moments(params, gen)}
    data = {"epoch": 0, "cursor": 99, "seed": 0}
    save_checkpoint(str(tmp_path), 5, params, opt, data_state=data,
                    extra={"spec": {"quantize": fmt}})
    got_p, got_o, got_d, extra = load_checkpoint(str(tmp_path), 5, params,
                                                 opt)
    _assert_same(got_p, params)
    _assert_same(got_o, opt)
    assert got_d == data and extra == {"spec": {"quantize": fmt}}
    # the state before any update: moments not made yet
    save_checkpoint(str(tmp_path), 6, params, {"step": 0, "m": None})
    _, o, _, _ = load_checkpoint(str(tmp_path), 6)
    assert o == {"step": 0, "m": None}


@pytest.mark.parametrize("fmt", FORMATS)
def test_files_and_digests_are_the_reference_s(tmp_path, fmt):
    jcfg = dataclasses.replace(jget_config("qwen2.5-0.5b").reduced(),
                               dtype="bfloat16" if fmt == "bfloat16"
                               else "float32")
    quantize = fmt if fmt in ("int8", "nf4") else None
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, quantize=quantize)
    tp = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    jsave(str(tmp_path / "jax"), 3, jp, {"step": jnp.asarray(3, jnp.int32)})
    save_checkpoint(str(tmp_path / "torch"), 3, tp,
                    {"step": torch.tensor(3, dtype=torch.int32)})
    man = [json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))
           for d in ("torch", "jax")]
    assert man[0]["arrays"] == man[1]["arrays"]
    assert sorted(os.listdir(tmp_path / "torch" / "step_00000003")) == \
        sorted(os.listdir(tmp_path / "jax" / "step_00000003"))
    _assert_same(load_checkpoint(str(tmp_path / "torch"), 3)[0], tp)


def _save_steps(d, steps, params):
    for s in steps:
        save_checkpoint(d, s, params, {"step": s})


def test_corrupt_newest_is_quarantined_and_older_restored(tmp_path):
    d, params = str(tmp_path), _params("float32")
    _save_steps(d, (2, 4), params)
    assert corrupt_latest_checkpoint(d) == 4
    ckpt = Checkpointer(d)
    got = ckpt.restore_latest(params, {"step": 0})
    assert got["step"] == 2 and got["opt_state"] == {"step": 2}
    _assert_same(got["params"], params)
    assert [s for s, _ in ckpt.quarantined] == [4]
    assert "checksum mismatch" in ckpt.quarantined[0][1]
    assert os.path.isdir(os.path.join(d, "corrupt_step_00000004"))
    assert latest_step(d) == 2


def test_all_corrupt_raises(tmp_path):
    d, params = str(tmp_path), _params("int8")
    _save_steps(d, (1,), params)
    corrupt_latest_checkpoint(d)
    ckpt = Checkpointer(d)
    with pytest.raises(IOError, match="no restorable checkpoint"):
        ckpt.restore_latest(params)
    assert ckpt.restore_latest(params) is None    # quarantined: dir empty
    assert Checkpointer(str(tmp_path / "nope")).restore_latest() is None


def test_keeps_three_and_ignores_a_leftover_tmp(tmp_path):
    d, params = str(tmp_path), _params("nf4")
    _save_steps(d, (1, 2, 3, 4, 5), params)
    assert sorted(n for n in os.listdir(d)) == [
        "step_00000003", "step_00000004", "step_00000005"]
    # a crash mid-write leaves step_XXXXXXXX.tmp/ behind, never a step
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    with open(os.path.join(d, "step_00000009.tmp", "manifest.json"), "w"):
        pass
    assert latest_step(d) == 5
    assert Checkpointer(d).restore_latest(params)["step"] == 5


def test_template_mismatch_is_refused_and_meta_templates_do(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _params("int8"))
    meta = lambda t: {k: meta(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.empty(t.shape, dtype=t.dtype,
                                                device="meta")
    load_checkpoint(d, 1, meta(_params("int8")))
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(d, 1, meta(_params("nf4")))
    with pytest.raises(ValueError, match="expected"):
        load_checkpoint(d, 1, meta(_params("float32")))
    ckpt = Checkpointer(d)
    with pytest.raises(IOError, match="no restorable checkpoint"):
        ckpt.restore_latest(meta(_params("bfloat16")))
    assert [s for s, _ in ckpt.quarantined] == [1]
