"""The port's ragged grouped LoRA op (``kernels/ops.lora_grouped_ragged``)
and its host-side schedule (``kernels/tiling.py``) against the JAX
reference, in f32.

The ragged layouts are ``tests/test_grouped.py``'s: nothing tile-aligned,
empty groups interleaved and leading, one group; K 72, N 88 and rank 6 are
aligned to nothing either. Over a dense f32 W0, int8 and nf4 stacks (the
reference's quantized leaves, bridged), the op's output and its x / A / B
gradients agree with ``repro.kernels.ops.lora_grouped_ragged`` (its
Pallas kernels in interpret mode) element-wise at 1e-5, and the summed
loss at 1e-4 relative (``ROADMAP.md`` §3: the reference's own int8 case
(8, 0, 13, 0, 2) differs from its loop by 1.9e-5 relative in such a sum).
The schedule's ``gid``, offsets and packed layout equal the reference's
bit for bit. On the CPU the grouped kernels' plain versions run, so the
op launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import tiling as jtiling
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tiling as ttiling

K, N, R = 72, 88, 6
SIZES = [(5, 11, 3), (8, 0, 13, 0, 2), (17,), (0, 0, 9)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _mats(E, method, seed=0):
    """(w0 as the reference's leaf, a, b) as numpy, the W0 stack in
    ``method``'s format (``"none"``: dense f32)."""
    rng = np.random.default_rng(seed)
    w0 = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((E, K, R)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((E, R, N)) * 0.3).astype(np.float32)
    if method != "none":
        w0 = jax.tree_util.tree_map(
            np.asarray, jquant.quantize_leaf(jnp.asarray(w0), method))
    return w0, a, b


def _to_torch(t):
    return bridge.from_numpy_tree(t) if isinstance(t, dict) \
        else torch.from_numpy(t)


@pytest.mark.parametrize("method", ["none", "int8", "nf4"])
@pytest.mark.parametrize("sizes", SIZES)
def test_ragged_matches_reference(sizes, method):
    E = len(sizes)
    w0, a, b = _mats(E, method)
    x = (np.random.default_rng(9).standard_normal((sum(sizes), K))
         * 0.3).astype(np.float32)
    jw0 = jax.tree_util.tree_map(jnp.asarray, w0)

    def f(x, a, b):
        y = jops.lora_grouped_ragged(x, sizes, jw0, a, b, 2.0)
        return jnp.sum(jnp.tanh(y)), y

    (jl, jy), jg = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    tx, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    tops.reset_launch_counts()
    ty = tops.lora_grouped_ragged(tx, sizes, _to_torch(w0), ta, tb, 2.0)
    tl = torch.tanh(ty).sum()
    tg = torch.autograd.grad(tl, (tx, ta, tb))
    assert set(tops.launch_counts().values()) == {0}
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for name, got, want in zip("xab", tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    for g, sz in enumerate(sizes):          # no tile, no gradient
        if sz == 0:
            assert float(tg[1][g].abs().max()) == 0.0
            assert float(tg[2][g].abs().max()) == 0.0


def test_all_groups_empty_gives_no_rows():
    w0, a, b = _mats(3, "none")
    y = tops.lora_grouped_ragged(torch.zeros(0, K), (0, 0, 0),
                                 torch.from_numpy(w0), torch.from_numpy(a),
                                 torch.from_numpy(b))
    assert tuple(y.shape) == (0, N)
    jy = jops.lora_grouped_ragged(jnp.zeros((0, K)), (0, 0, 0),
                                  jnp.asarray(w0), jnp.asarray(a),
                                  jnp.asarray(b))
    assert tuple(jy.shape) == tuple(y.shape)


@pytest.mark.parametrize("bm", [1, 8, 16])
@pytest.mark.parametrize("sizes", SIZES + [(0, 0), (64, 1, 0, 7)])
def test_schedule_and_packing_are_the_reference_s(sizes, bm):
    gid, offs = ttiling.grouped_schedule(sizes, bm)
    jgid, joffs = jtiling.grouped_schedule(sizes, bm)
    assert gid.dtype == jgid.dtype and np.array_equal(gid, jgid)
    assert offs.dtype == joffs.dtype and np.array_equal(offs, joffs)
    assert ttiling.grouped_schedule_stats(sizes, bm) == \
        jtiling.grouped_schedule_stats(sizes, bm)
    x = np.random.default_rng(2).standard_normal(
        (sum(sizes), 5)).astype(np.float32)
    packed = ttiling.pack_ragged_rows(torch.from_numpy(x), sizes, bm)
    jpacked = np.asarray(jtiling.pack_ragged_rows(jnp.asarray(x), sizes, bm))
    assert packed.numpy().tobytes() == jpacked.tobytes()
    back = ttiling.unpack_ragged_rows(packed, sizes, bm)
    assert np.array_equal(back.numpy(), x)
    jback = jtiling.unpack_ragged_rows(jnp.asarray(jpacked), sizes, bm)
    assert np.array_equal(np.asarray(jback), x)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pad_dim_is_the_reference_s(axis):
    x = np.arange(3 * 5 * 7, dtype=np.float32).reshape(3, 5, 7)
    got = ttiling.pad_dim(torch.from_numpy(x), 4, axis).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jtiling.pad_dim(jnp.asarray(x), 4, axis)))
    assert ttiling.ceil_to(13, 8) == jtiling.ceil_to(13, 8) == 16
