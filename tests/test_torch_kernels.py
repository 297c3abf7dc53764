"""The port's kernel modules against the JAX reference kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel in interpret mode (and against the reference's
dispatch layer) on the same numpy-seeded inputs, at rtol = atol = 1e-5 in
f32: the two differ only in summation order. The tests marked ``cuda``
hold the CUDA kernels against their plain versions on a card and skip
without one; this module imports JAX only inside the parity tests, so
that the card-only tests also run where JAX is not installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.api.policy import ExecutionPolicy
from repro_torch.kernels import lora_grouped as tlg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn

TOL = dict(rtol=1e-5, atol=1e-5)
CUDA_POLICY = ExecutionPolicy(backend="cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's kernel modules."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.api.policy import ExecutionPolicy as JaxPolicy
    from repro.kernels import lora_grouped, ops, rmsnorm
    return SimpleNamespace(jnp=jnp, Policy=JaxPolicy, lg=lora_grouped,
                           ops=ops, rn=rmsnorm)


def _grouped_inputs(seed, M, K, N, R, r, gid):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(M, K), f(K, N) * K ** -0.5, f(R, K, r) * r ** -0.5,
            f(R, r, N), np.asarray(gid, np.int32), f(N))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# (M, K, N, R, r, bm, gid): non-aligned K/N, repeated and unused slots
GROUPED_CASES = [
    (32, 72, 40, 3, 4, 8, [2, 0, 2, 2]),        # slot 1 unused
    (8, 72, 40, 3, 8, 2, [1, 1, 0, 1]),         # decode tile 2, slot 2 unused
    (6, 33, 129, 3, 8, 3, [0, 0]),              # one slot for everything
]


@pytest.mark.parametrize("M,K,N,R,r,bm,gid", GROUPED_CASES)
def test_grouped_plain_matches_pallas_kernel(jx, M, K, N, R, r, bm, gid):
    jnp = jx.jnp
    x, w0, a, b, g, _ = _grouped_inputs(0, M, K, N, R, r, gid)
    want = jx.lg.lora_grouped(jnp.asarray(x), jnp.asarray(w0)[None],
                            jnp.asarray(a), jnp.asarray(b), jnp.asarray(g),
                            2.0, bm=bm, interpret=True)
    got = tlg.lora_grouped(*_t(x, w0, a, b, g), 2.0, bm=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("M,K,N,R,r,bm,gid", GROUPED_CASES[:2])
def test_grouped_decode_dispatch_matches_reference(jx, M, K, N, R, r, bm,
                                                   gid, with_bias):
    jnp = jx.jnp
    x, w0, a, b, g, bias = _grouped_inputs(1, M, K, N, R, r, gid)
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    tx, tw, ta, tbb, tg = _t(x, w0, a, b, g)
    for jpol, tpol in ((jx.Policy(backend="pallas", interpret=True),
                        CUDA_POLICY),
                       (jx.Policy(), ExecutionPolicy())):
        want = jx.ops.lora_grouped_decode(
            jnp.asarray(x), jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(g), jb, 2.0, bm=bm, policy=jpol)
        got = tops.lora_grouped_decode(tx, tw, ta, tbb, tg, tb, 2.0, bm=bm,
                                       policy=tpol)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_decode_rejects_partial_tiles():
    x, w0, a, b, g, _ = _grouped_inputs(2, 6, 8, 8, 2, 4, [0, 1])
    with pytest.raises(ValueError, match="multiple of tile"):
        tops.lora_grouped_decode(*_t(x, w0, a, b, g), bm=4,
                                 policy=CUDA_POLICY)


@pytest.mark.parametrize("M,d", [(10, 72), (8, 64), (1, 33)])
def test_rmsnorm_plain_matches_pallas_kernel(jx, M, d):
    jnp = jx.jnp
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, d)).astype(np.float32) * 3
    w = rng.standard_normal(d).astype(np.float32)
    want = jx.rn.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6, interpret=True)
    got = trn.rmsnorm(*_t(x, w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the dispatch keeps leading dims, as the reference's does
    want3 = jx.ops.rmsnorm(jnp.asarray(x)[:, None], jnp.asarray(w), 1e-6,
                         interpret=True)
    got3 = tops.rmsnorm(torch.from_numpy(x)[:, None], torch.from_numpy(w),
                        1e-6)
    assert got3.shape == (M, 1, d)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), **TOL)


def test_cpu_tensors_never_launch_kernels():
    tops.reset_launch_counts()
    x, w0, a, b, g, bias = _grouped_inputs(4, 8, 16, 24, 2, 4, [0, 1, 1, 0])
    tops.lora_grouped_decode(*_t(x, w0, a, b, g), torch.from_numpy(bias),
                             bm=2, policy=CUDA_POLICY)
    tops.rmsnorm(torch.from_numpy(x), torch.ones(16))
    assert tops.launch_counts() == {"lora_grouped_fwd": 0, "rmsnorm_fwd": 0}


# ------------------------------------------------------------- card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,R,r,bm,gid", GROUPED_CASES + [
    (8, 896, 4864, 4, 8, 2, [3, 0, 3, 1]),
    (8, 4864, 896, 4, 8, 2, [2, 2, 0, 1]),
    (24, 300, 130, 2, 16, 3, [1, 0, 0, 1, 1, 0, 1, 0]),
])
def test_grouped_kernel_matches_plain_on_card(M, K, N, R, r, bm, gid, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    x, w0, a, b, g, _ = _grouped_inputs(5, M, K, N, R, r, gid)
    args = [t.cuda() for t in _t(x, w0, a, b)]
    args = [t.to(dt) for t in args] + [torch.from_numpy(g).cuda()]
    before = tlg.lora_grouped.launches
    got = tlg.lora_grouped(*args, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert tlg.lora_grouped.launches == before + 1
    want = tlg.lora_grouped_ref(*args, 2.0, bm=bm)
    # f32: summation order only; bf16: one output rounding (2^-8 relative)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_grouped_kernel_marks_bad_gid_and_rejects_bad_input():
    _need_card()
    x, w0, a, b, g, _ = _grouped_inputs(6, 4, 32, 40, 2, 4, [0, 5])
    args = [t.cuda() for t in _t(x, w0, a, b, g)]
    y = tlg.lora_grouped(*args, 2.0, bm=2)
    torch.cuda.synchronize()
    assert torch.isfinite(y[:2]).all() and torch.isnan(y[2:]).all()
    with pytest.raises(TypeError, match="int32"):
        tlg.lora_grouped(*args[:4], args[4].long(), 2.0, bm=2)
    with pytest.raises(ValueError, match="rank"):
        big = torch.zeros(2, 32, 17, device="cuda")
        tlg.lora_grouped(args[0], args[1], big,
                         torch.zeros(2, 17, 40, device="cuda"), args[4],
                         2.0, bm=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,d", [(8, 896), (3, 1000), (64, 72)])
def test_rmsnorm_kernel_matches_plain_on_card(M, d, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(M, d, generator=g) * 3).to(dt).cuda()
    w = torch.randn(d, generator=g).to(dt).cuda()
    got = trn.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    want = trn.rmsnorm_ref(x, w, 1e-6)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
