"""The port's kernel modules against the JAX reference kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel in interpret mode (and against the reference's
dispatch layer) on the same numpy-seeded inputs, at rtol = atol = 1e-5 in
f32: the two differ only in summation order. The tests marked ``cuda``
hold the CUDA kernels against their plain versions on a card and skip
without one; this module imports JAX only inside the parity tests, so
that the card-only tests also run where JAX is not installed.
"""
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.api.policy import ExecutionPolicy
from repro_torch.kernels import lora_fused as tlf
from repro_torch.kernels import lora_grouped as tlg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)
CUDA_POLICY = ExecutionPolicy(backend="cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's kernel modules."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.api.policy import ExecutionPolicy as JaxPolicy
    from repro.kernels import lora_fused, lora_grouped, ops, rmsnorm
    return SimpleNamespace(jnp=jnp, Policy=JaxPolicy, lg=lora_grouped,
                           lf=lora_fused, ops=ops, rn=rmsnorm)


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


def _fused_inputs(seed, M, K, N, r):
    """x [M,K], w0 [K,N], a [K,r], b [r,N] (drawn nonzero, so dA and the
    h@B term are tested), g [M,N]."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(M, K) * 0.3, f(K, N) * K ** -0.5, f(K, r) * 0.3,
            f(r, N) * 0.3, f(M, N) * 0.3)


# (M, K, N, r): none tile-aligned; M = batch 2 x seq 48 of the model tests
FUSED_CASES = [(96, 160, 192, 8), (37, 72, 40, 4), (5, 33, 129, 16)]


@pytest.mark.parametrize("M,K,N,r", FUSED_CASES)
def test_lora_fused_plain_matches_pallas_kernel(jx, M, K, N, r):
    x, w0, a, b, _ = _fused_inputs(10, M, K, N, r)
    jnp = jx.jnp
    want = jx.lf.lora_fused(*map(jnp.asarray, (x, w0, a, b)), 2.0,
                            interpret=True)
    got = tlf.lora_fused(*_t(x, w0, a, b), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# the LoRA scale: the model's alpha / r = 2, and one that is no power of
# two (the bf16 dx kernel scales g itself then)
DX_SCALES = [2.0, 1.5]


@pytest.mark.parametrize("scale", DX_SCALES)
@pytest.mark.parametrize("M,K,N,r", FUSED_CASES)
def test_lora_dx_plain_matches_pallas_kernel(jx, M, K, N, r, scale):
    x, w0, a, b, g = _fused_inputs(11, M, K, N, r)
    jnp = jx.jnp
    want = jx.lf.lora_dx(*map(jnp.asarray, (g, w0, a, b)), scale,
                         interpret=True)
    got = tlf.lora_dx(*_t(g, w0, a, b), scale)
    assert got.shape == (M, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# beside FUSED_CASES, the ranks the bf16 dA/dB body takes in its 16- and
# 32-wide instances, and 40 rows (OLMoE's capacity: a chunk of three m16
# fragments)
DAB_CPU_CASES = FUSED_CASES + [(40, 72, 40, 16), (40, 33, 129, 32),
                               (12, 40, 24, 32)]


@pytest.mark.parametrize("M,K,N,r", DAB_CPU_CASES)
def test_lora_dab_plain_matches_pallas_kernel(jx, M, K, N, r):
    x, w0, a, b, g = _fused_inputs(12, M, K, N, r)
    jnp = jx.jnp
    wda, wdb = jx.lf.lora_dab(*map(jnp.asarray, (x, g, a, b)), 2.0,
                              interpret=True)
    da, db = tlf.lora_dab(*_t(x, g, a, b), 2.0)
    assert np.abs(np.asarray(wda)).max() > 0.1      # B != 0: dA is tested
    np.testing.assert_allclose(da.numpy(), np.asarray(wda), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(wdb), **TOL)


@pytest.mark.parametrize("M,d", [(96, 160), (10, 72), (1, 33)])
def test_rmsnorm_bwd_plain_matches_pallas_kernel(jx, M, d):
    jnp = jx.jnp
    rng = np.random.default_rng(13)
    x = rng.standard_normal((M, d)).astype(np.float32) * 3
    w = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((M, d)).astype(np.float32)
    wdx, wdw = jx.rn.rmsnorm_bwd(*map(jnp.asarray, (x, w, g)), 1e-6,
                                 interpret=True)
    dx, dw = trn.rmsnorm_bwd(*_t(x, w, g), 1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(wdw), **TOL)
    dx2, none = trn.rmsnorm_bwd(*_t(x, w, g), 1e-6, need_dw=False)
    assert none is None and torch.equal(dx2, dx)


# the bf16 decode body's plan (kernels/lora_grouped.decode_plan): decode
# shapes (M, K, N, r, bm) and edges of rank, tile and K
DECODE_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
PLAN_CASES = ([(8, K, N, 8, bm) for K, N in DECODE_SHAPES for bm in (2, 4)]
              + [(16, 97, 131, 16, 2), (24, 301, 130, 16, 3),
                 (16, 896, 896, 16, 1), (16, 896, 896, 8, 1),
                 (16, 896, 896, 16, 2), (32, 128, 64, 16, 1),
                 (32, 4863, 896, 3, 2), (5, 33, 129, 8, 5)])


@pytest.mark.parametrize("M,K,N,r,bm", PLAN_CASES)
def test_decode_plan_splits_k_in_whole_code_rows(M, K, N, r, bm):
    """Each member of a cluster gets a nonempty K range that starts on a
    whole code row (even: a packed byte holds two K rows) and the ranges
    cover K in order; the cluster is at most 8; a part's slots fit the h
    columns, which the body holds at most 128 of."""
    plan = tlg.decode_plan(M, K, N, r, bm=bm)
    ranges = plan["k_ranges"]
    assert 1 <= plan["split"] <= 8 and len(ranges) == plan["split"]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo and lo % 2 == 0 and lo % tlg.DECODE_KD == 0
               for lo, hi in ranges)
    part, rw = plan["part"], 8 if r <= 8 else 16
    slots = max((min(m0 + part, M) - 1) // bm - m0 // bm + 1
                for m0 in range(0, M, part))
    assert slots * rw <= plan["h_cols"] <= tlg.DECODE_MAX_H_COLS
    assert plan["h_cols"] % 16 == 0 and part in (4, 8, 16)
    assert plan["bn"] in (64, 128)
    assert plan["blocks"] == (-(-N // plan["bn"]) * -(-M // part)
                              * plan["split"])


@pytest.mark.parametrize("K,N,bn,split", [
    (896, 896, 128, 7), (896, 128, 64, 7), (896, 4864, 128, 3),
    (4864, 896, 128, 8)])
def test_decode_plan_at_the_decode_shapes(K, N, bn, split):
    """At the decode path's shapes (8 slots in tiles of 2, r 8) on an H100's
    132 SMs: 128-column tiles but at k·v (N 128: two of 64), the widest
    split at q·o, k·v (a member a slab of K 896) and down, gate·up split 3;
    every grid runs in one wave (one block an SM at 128 columns)."""
    plan = tlg.decode_plan(8, K, N, 8, bm=2)
    assert (plan["bn"], plan["split"], plan["part"], plan["h_cols"]) == \
        (bn, split, 16, 32)
    assert plan["blocks"] <= (1 if bn == 128 else 2) * tlg.H100_SMS


def test_cpu_tensors_never_launch_kernels():
    tops.reset_launch_counts()
    x, w0, a, b, g, bias = _grouped_inputs(4, 8, 16, 24, 2, 4, [0, 1, 1, 0])
    tops.lora_grouped_decode(*_t(x, w0, a, b, g), torch.from_numpy(bias),
                             bm=2, policy=CUDA_POLICY)
    tops.rmsnorm(torch.from_numpy(x), torch.ones(16))
    fx, fw0, fa, fb, fg = _t(*_fused_inputs(4, 6, 16, 24, 4))
    fx.requires_grad_(True)
    fa.requires_grad_(True)
    y = tops.lora_linear(fx, fw0, fa, fb, None, 2.0)
    xn = tops.rmsnorm(fx, torch.ones(16))
    # from 64 query rows the dispatch takes the flash Function
    q = torch.randn(1, 2, 64, 8).requires_grad_(True)
    o = tops.sdpa(q, torch.randn(1, 1, 64, 8), torch.randn(1, 1, 64, 8))
    # the MoE expert linear over [E, C, K] stacks, float and int8
    ex = torch.randn(2, 5, 16).requires_grad_(True)
    ea, eb = torch.randn(2, 16, 4), torch.randn(2, 4, 24)
    ey = tops.lora_grouped_linear(ex, torch.randn(2, 16, 24), ea, eb)
    codes = {"q": torch.ones(2, 16, 24, dtype=torch.int8),
             "scale": torch.ones(2, 1, 24)}
    ey = ey + tops.lora_grouped_linear(ex, codes, ea, eb)
    # the standalone RoPE (on no path of the model)
    rx = torch.randn(1, 6, 2, 8).requires_grad_(True)
    ry = trope.rope_apply(rx, *trope.rope_tables(torch.arange(6), 1e4, 8))
    torch.autograd.grad((y * fg).sum() + xn.sum() + o.sum() + ey.sum()
                        + ry.sum(), (fx, fa, q, ex, rx))
    counts = tops.launch_counts()
    assert set(counts) == {"lora_grouped_fwd", "lora_grouped_q",
                           "lora_grouped_q4", "rmsnorm_fwd",
                           "lora_fused_fwd", "lora_dx", "lora_dab",
                           "rmsnorm_bwd", "flash_fwd", "flash_bwd_dq",
                           "flash_bwd_dkv", "lora_fused_q", "lora_dx_q",
                           "lora_fused_q4", "lora_dx_q4",
                           "lora_grouped_gemm", "lora_grouped_dx",
                           "lora_grouped_dab", "lora_grouped_gemm_q",
                           "lora_grouped_gemm_q4", "lora_grouped_dx_q",
                           "lora_grouped_dx_q4", "rope_fwd"}
    assert set(counts.values()) == {0}


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
@pytest.mark.parametrize("M,d", [(8, 896), (3, 1000), (64, 72), (1, 896),
                                 (256, 896), (256, 2048), (5, 899),
                                 (3, 5000), (256, 384), (1500, 384),
                                 (512, 896)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_takes_an_unaligned_row_base(dtype):
    """x, w and y one element (2 bytes in bf16) off 16-byte alignment: the
    kernel's element-by-element loads, held as tightly as the aligned
    ones."""
    _need_card()
    dt = getattr(torch, dtype)
    M, d = 8, 896
    g = torch.Generator().manual_seed(8)
    xb = (torch.randn(M * d + 1, generator=g) * 3).to(dt).cuda()
    wb = torch.randn(d + 1, generator=g).to(dt).cuda()
    x, w = xb[1:].view(M, d), wb[1:]
    assert x.data_ptr() % 16 and x.is_contiguous()
    got = trn.rmsnorm(x, w, 1e-6)
    torch.cuda.synchronize()
    want = trn.rmsnorm_ref(x, w, 1e-6)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


# the bf16 decode body (csrc/lora_grouped_decode_tc.cuh) over a bf16 base:
# (M, bm, K, N, R, r, gid). The decode shapes at M 8 in tiles of 2 and of
# 4 (the serve CLI's default tile for 8 slots), two parts of 16 rows and
# more, M 24 in tiles of 3 (parts that start inside a tile), and
# chip_smoke.GROUPED_Q_EDGES (odd K, ragged N, ranks 3 and 16, repeated
# slots, a bad gid)
DECODE_GID = [3, 0, 3, 1]
DECODE_CASES = {
    **{f"M8_bm{bm}_{K}x{N}": (8, bm, K, N, 4, 8, DECODE_GID[:8 // bm])
       for K, N in DECODE_SHAPES for bm in (2, 4)},
    "M16": (16, 2, 896, 896, 4, 8, [3, 0, 3, 1, 2, 2, 0, 1]),
    "M24_bm3": (24, 3, 896, 4864, 4, 8, [1, 0, 0, 1, 1, 0, 1, 0]),
    "M32": (32, 2, 4864, 896, 4, 8, [i % 4 for i in range(16)]),
    "odd_k_ragged_n": (8, 2, 97, 131, 4, 8, DECODE_GID),
    "odd_k_wide": (8, 2, 4863, 896, 4, 8, DECODE_GID),
    "n130_rank3": (8, 2, 896, 130, 4, 3, [1, 2, 3, 0]),
    "rank16": (8, 2, 896, 896, 4, 16, DECODE_GID),
    "rows16": (16, 2, 896, 128, 4, 8, [3, 0, 3, 1, 2, 2, 0, 1]),
    "gid_repeated": (8, 2, 896, 4864, 4, 8, [2, 2, 0, 2]),
    "bad_gid": (8, 2, 896, 896, 4, 8, [3, 7, 0, -1]),
    "bm1_rank16": (16, 1, 300, 200, 16, 16, list(range(15, -1, -1))),
}


def _decode_bf16(case, seed):
    M, bm, K, N, R, r, gid = DECODE_CASES[case]
    x, w0, a, b, g, _ = _grouped_inputs(seed, M, K, N, R, r, gid)
    args = [t.cuda().to(torch.bfloat16) for t in _t(x, w0, a, b)]
    return args + [torch.from_numpy(g).cuda()], bm, R


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_grouped_decode_bf16_matches_plain_on_card(case):
    """One launch of the tensor-core body, within chip_smoke.KERNEL_TOL's
    scheme of the plain version (one output rounding, doubled where a
    rounding of h flips; the floor relative to the largest output); rows
    of a gid outside [0, R) NaN in both."""
    _need_card()
    args, bm, R = _decode_bf16(case, 9)
    before = tlg.lora_grouped.launches
    got = tlg.lora_grouped(*args, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert tlg.lora_grouped.launches == before + 1
    want = tlg.lora_grouped_ref(*args, 2.0, bm=bm)
    bad = torch.tensor([not 0 <= t < R for t in args[4].tolist()],
                       device="cuda").repeat_interleave(bm)
    for t in (got, want):
        assert torch.equal(torch.isnan(t).all(1), bad)
        assert torch.isfinite(t[~bad]).all()
    scale = max(1.0, float(want[~bad].float().abs().max()))
    torch.testing.assert_close(got[~bad].float(), want[~bad].float(),
                               rtol=2.0 ** -6, atol=1e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["M8_bm2_896x4864", "M8_bm2_4864x896",
                                  "M24_bm3", "odd_k_ragged_n"])
def test_grouped_decode_bf16_is_bitwise_on_repeat(case):
    """Partials are added in a fixed order of members and warps: two
    launches on the same inputs give the same bits."""
    _need_card()
    args, bm, _ = _decode_bf16(case, 10)
    y1 = tlg.lora_grouped(*args, 2.0, bm=bm)
    y2 = tlg.lora_grouped(*args, 2.0, bm=bm)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))


def _assert_close_scaled(got, want, tol):
    """assert_close with the absolute floor taken relative to the output's
    largest magnitude (at least 1): dA, dB and dw are sums over all rows,
    whose size grows with M, and an entry near zero is a cancellation of
    such terms."""
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# the dense forward's card cases beyond the seq-48 path: the paper path's
# M 256 at qwen2.5-0.5b's four shapes and OLMoE's 2048 x 2048; M 1, 16, 63,
# 64 and 65 (one to four m16 fragments, a row tile plus one row); K 4864
# into N 128, which takes the deepest K split (8 blocks a cluster)
TC_CASES = [
    (256, 896, 896, 8), (256, 896, 128, 8), (256, 896, 4864, 8),
    (256, 4864, 896, 8), (256, 2048, 2048, 8), (1, 896, 896, 8),
    (16, 896, 4864, 8), (63, 97, 131, 16), (64, 896, 896, 8),
    (65, 4864, 128, 32), (256, 4864, 128, 8),
]
DEEPEST_SPLIT = (256, 4864, 128)


# Whisper-tiny's three (K, N) (K 384: the K split at its narrowest) at the
# text's 256 rows and the frames' 1,500 (an M tail); single-stream decode's
# M 4 and the cross-attention's k, v over 4 x 1,500 frames
WHISPER_CASES = [(m, k, n, 8) for m in (256, 1500)
                 for k, n in ((384, 384), (384, 1536), (1536, 384))] + [
    (4, 384, 384, 8), (6000, 384, 384, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,r", FUSED_CASES + [
    (192, 896, 896, 8), (192, 896, 128, 8), (192, 896, 4864, 8),
    (192, 4864, 896, 8), (130, 300, 70, 32), (64, 64, 64, 1),
    (40, 97, 131, 1), (256, 2048, 2048, 32),
] + TC_CASES + WHISPER_CASES)
def test_lora_training_kernels_match_plain_on_card(M, K, N, r, dtype):
    """lora_fused_fwd, lora_dx and lora_dab against their plain versions.
    f32: summation order only. bf16: one output rounding (2^-8 relative),
    doubled where a rounding of h or dh flips, and an absolute floor for
    outputs near zero: the tolerance of the serving kernel's check."""
    _need_card()
    dt = getattr(torch, dtype)
    x, w0, a, b, g = [t.to(dt).cuda() for t in _t(*_fused_inputs(
        14, M, K, N, r))]
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    counts = (tlf.lora_fused.launches, tlf.lora_dx.launches,
              tlf.lora_dab.launches)
    y = tlf.lora_fused(x, w0, a, b, 2.0)
    dx = tlf.lora_dx(g, w0, a, b, 2.0)
    da, db = tlf.lora_dab(x, g, a, b, 2.0)
    torch.cuda.synchronize()
    assert (tlf.lora_fused.launches, tlf.lora_dx.launches,
            tlf.lora_dab.launches) == tuple(c + 1 for c in counts)
    assert y.dtype == dx.dtype == da.dtype == db.dtype == dt
    wda, wdb = tlf.lora_dab_ref(x, g, a, b, 2.0)
    for got, want in ((y, tlf.lora_fused_ref(x, w0, a, b, 2.0)),
                      (dx, tlf.lora_dx_ref(g, w0, a, b, 2.0)),
                      (da, wda), (db, wdb)):
        _assert_close_scaled(got, want, tol)
    # deterministic: the partials are reduced in a fixed order
    da2, db2 = tlf.lora_dab(x, g, a, b, 2.0)
    assert torch.equal(da, da2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", [(192, 896, 896, 8), (37, 72, 40, 4)]
                         + TC_CASES)
def test_lora_fused_bf16_is_bitwise_on_repeat(M, K, N, r):
    """The bf16 forward on tensor cores adds its K split's partials in a
    fixed order (no atomics): the same bits on every call. The split is
    1 to 8 blocks, 8 at K 4864 into N 128."""
    _need_card()
    x, w0, a, b, _ = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(16, M, K, N, r))]
    y = tlf.lora_fused(x, w0, a, b, 2.0)
    for _ in range(3):
        assert torch.equal(tlf.lora_fused(x, w0, a, b, 2.0), y)
    plan = tlf.forward_plan(M, K, N)
    assert 1 <= plan["split"] <= 8 and plan["smem_bytes"] > 0
    if (M, K, N) == DEEPEST_SPLIT:
        assert plan["split"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["fwd", "dx"])
def test_dense_split_is_the_callers_and_checked_on_card(body):
    """The bf16 dense bodies take their split from the caller: every split
    the hard limits allow matches the plain version; one past them (0, 9,
    or more members than K's or N's slabs) is refused by the C entry
    (cudaErrorInvalidValue), never clamped; a plan in the autotuner's
    cache reaches the launch, and a cached plan the kernel refuses raises
    rather than giving way to the heuristic."""
    _need_card()
    from repro_torch.kernels import autotune
    M, K, N = (256, 896, 128) if body == "fwd" else (256, 896, 96)
    x, w0, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(31, M, K, N, 8))]
    if body == "fwd":
        op, call = "lora_fused", lambda s: tlf.lora_fused(x, w0, a, b,
                                                          split=s)
        want, slabs = tlf.lora_fused_ref(x, w0, a, b), -(-K // 32)
    else:
        op, call = "lora_dx", lambda s: tlf.lora_dx(g, w0, a, b, split=s)
        want, slabs = tlf.lora_dx_ref(g, w0, a, b), -(-N // 32)
    for split in range(1, min(8, slabs) + 1):
        _assert_close_scaled(call(split), want, dict(rtol=2.0 ** -6,
                                                     atol=1e-2))
    for split in (0, 9, slabs + 1):
        with pytest.raises(RuntimeError, match=f"split {split}"):
            call(split)
    key = autotune._key(op, {"M": M, "K": K, "N": N}, torch.bfloat16)
    autotune._ensure_loaded()
    try:
        autotune._CACHE[key] = {"split": 2}
        assert torch.equal(call(None), call(2))
        assert autotune.choose_blocks(op, torch.bfloat16, M=M, K=K,
                                      N=N) == {"split": 2}
        autotune._CACHE[key] = {"split": 9}
        with pytest.raises(RuntimeError, match="split 9"):
            call(None)
    finally:
        autotune._CACHE.pop(key, None)


# the bf16 dx's card cases, g [M, N] -> dx [M, K] at r 8: every path shape
# (K, N) of q, o; k, v; gate, up; down and OLMoE's q, k, v, o at M 1, 17,
# 65, 192 and 256 (one to four m16 fragments, a row tile plus one row);
# ragged K and N at other ranks (r 3: A and B element by element). K 896
# from N 4864 takes the deepest split of the contraction, 8 blocks.
DX_PATH_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
                  (2048, 2048)]
DX_ROWS = [1, 17, 65, 192, 256]
DX_CASES = [(m, k, n, 8) for m in DX_ROWS for k, n in DX_PATH_SHAPES] + [
    (50, 97, 131, 16), (130, 300, 70, 32), (33, 1001, 4863, 3)]
DX_DEEPEST = (256, 896, 4864)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", DX_SCALES)
@pytest.mark.parametrize("M,K,N,r", DX_CASES)
def test_lora_dx_bf16_matches_plain_on_card(M, K, N, r, scale):
    """The bf16 dx on tensor cores, dh summed in its own loop, against its
    plain version: one output rounding (2^-8 relative), doubled where a
    rounding of dh flips, and an absolute floor (the tolerance of the other
    LoRA kernels' card check). At s 1.5 the kernel scales g itself."""
    _need_card()
    x, w0, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(17, M, K, N, r))]
    before = tlf.lora_dx.launches
    dx = tlf.lora_dx(g, w0, a, b, scale)
    torch.cuda.synchronize()
    assert tlf.lora_dx.launches == before + 1
    assert dx.dtype == torch.bfloat16 and dx.shape == (M, K)
    _assert_close_scaled(dx, tlf.lora_dx_ref(g, w0, a, b, scale),
                         dict(rtol=2.0 ** -6, atol=1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", DX_SCALES)
@pytest.mark.parametrize("M,K,N", [(192, 896, 896), (256, 896, 128),
                                   DX_DEEPEST, (256, 4864, 896),
                                   (17, 2048, 2048), (50, 97, 131)])
def test_lora_dx_bf16_is_bitwise_on_repeat(M, K, N, scale):
    """The bf16 dx adds its split's partials of g @ W0^T and of dh in a
    fixed order (no atomics): the same bits on every call. The split of N
    is 1 to 8 blocks, 8 at K 896 from N 4864."""
    _need_card()
    _, w0, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(19, M, K, N, 8))]
    dx = tlf.lora_dx(g, w0, a, b, scale)
    for _ in range(3):
        assert torch.equal(tlf.lora_dx(g, w0, a, b, scale), dx)
    plan = tlf.dx_plan(M, K, N)
    assert 1 <= plan["split"] <= 8 and plan["smem_bytes"] > 0
    if (M, K, N) == DX_DEEPEST:
        assert plan["split"] == 8


# one bf16 dx call in each base format under torch.profiler, in a process of
# its own: in a process that has already traced the card, later profiler
# sessions have come back without the card's kernels
_PROFILE_DX = r"""
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import quant
from repro_torch.kernels import lora_fused as lf
from repro_torch.kernels import lora_pack4 as lp4
from repro_torch.kernels import lora_quant as lq

gen = torch.Generator(device="cuda").manual_seed(0)
M, K, N, r = 256, 896, 4864, 8
rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
w = rn(K, N) * K ** -0.5
g, a, b = rn(M, N).bfloat16(), rn(K, r).bfloat16(), rn(r, N).bfloat16()
wb, q8, q4 = (w.bfloat16(), quant.quantize_leaf(w, "int8"),
              quant.quantize_leaf(w, "nf4"))
calls = [lambda: lf.lora_dx(g, wb, a, b, 2.0),
         lambda: lq.lora_dx_q(g, q8["q"], q8["scale"], a, b, 2.0)] + [
    lambda m=m: lp4.lora_dx_q4(g, q4["q4"], q4["scale"], a, b, 2.0,
                               method=m) for m in ("int4", "nf4")]
for fn in calls:
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for fn in calls:
        fn()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


@pytest.mark.cuda
def test_lora_dx_bf16_is_one_device_kernel():
    """A bf16 dx call, in every base format, runs one device kernel (dh is
    summed in it): four calls, four kernels, each the tensor-core body of
    its format (dense_dx_tc<MF, format>). And no PyTorch operator but the
    output's allocation; an f32 call still computes dh in PyTorch."""
    import json
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path
    from torch.utils._python_dispatch import TorchDispatchMode
    _need_card()
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out = subprocess.run([sys.executable, "-c", _PROFILE_DX], env=env,
                         check=True, capture_output=True, text=True).stdout
    kernels = json.loads(out.strip().splitlines()[-1])
    fmts = [re.search(r"dense_dx_tc<4, \(wfmt::WFmt\)(\d)>", k)
            for k in kernels]
    assert len(kernels) == 4 and all(fmts), kernels
    assert [int(f.group(1)) for f in fmts] == [0, 1, 2, 3], kernels

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))
    _, w0, a, b, g = [t.cuda() for t in _t(*_fused_inputs(20, 256, 896,
                                                           4864, 8))]
    bf = [t.bfloat16() for t in (g, w0, a, b)]
    for args, only_empty in ((bf, True), ((g, w0, a, b), False)):
        tlf.lora_dx(*args, 2.0)
        with Ops() as ops:
            tlf.lora_dx(*args, 2.0)
        assert all(o.startswith("aten.empty") for o in ops.names) == \
            only_empty, ops.names


# SHA-256 of the f32 dx (lora_gemm.cuh's CUDA-core body) on
# _fused_inputs(18, M, K, N, 8) at s 2, by (M, K, N): the bits it had
# before the bf16 dx moved to tensor cores
DX_F32_SHA256 = {
    (192, 896, 896):
        "eb3926e12ae1431c9f5f16259db157ff1406d4cd6ea45add7c9859c925f63de6",
    (256, 896, 4864):
        "d0a8978f9b9c066550d63a5c804f1fc110f3739d7f71fc9a85b6560b5ed0a06b",
    (50, 97, 131):
        "b164a4e59468b71ab367397131e3f813fb23b675c2278d8195bbd59c69c65a5b",
}


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", list(DX_F32_SHA256))
def test_lora_dx_f32_bits_are_unchanged(M, K, N):
    _need_card()
    _, w0, a, b, g = [t.cuda() for t in _t(*_fused_inputs(18, M, K, N, 8))]
    dx = tlf.lora_dx(g, w0, a, b, 2.0)
    got = hashlib.sha256(dx.cpu().numpy().tobytes()).hexdigest()
    assert got == DX_F32_SHA256[(M, K, N)]


# the bf16 dA/dB's card cases (M, K, N, r): every path shape (q, o; k, v;
# gate, up; down; OLMoE's 2048 x 2048) at M 192 and 256 (8 sub-runs of 24
# and 32 rows); M 1, 16, 40, 63, 64 and 65 (one sub-run, then several, one
# to four m16 fragments a chunk); r 1, 16 and 32 (the 8-, 16- and 32-wide
# instances; 32 at gate/up takes two passes over a member's columns);
# ragged, unaligned K and N (x, g and B element by element)
DAB_CASES = (
    [(m, k, n, 8) for m in (192, 256) for k, n in DX_PATH_SHAPES]
    + [(m, 896, 4864, 8) for m in (1, 16, 40, 63, 64, 65)]
    + [(256, 896, 4864, r) for r in (1, 16, 32)]
    + [(65, 4864, 896, 32), (40, 2048, 2048, 16), (63, 97, 131, 8),
       (40, 97, 131, 3), (130, 300, 70, 32), (300, 97, 131, 16)])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", DX_SCALES)
@pytest.mark.parametrize("M,K,N,r", DAB_CASES)
def test_lora_dab_bf16_matches_plain_on_card(M, K, N, r, scale):
    """The bf16 dA/dB on tensor cores (one launch, x and g read once, h and
    dh recomputed on chip) against its plain version: one output rounding
    (2^-8 relative), doubled where a rounding of h or dh flips, and an
    absolute floor relative to the largest output (the other LoRA kernels'
    card tolerance). At s 1.5 round(s g) really rounds, in the kernel's
    registers. Two launches give the same bits; the workspace holds at most
    8 sub-run partials."""
    _need_card()
    x, _, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(20, M, K, N, r))]
    before = tlf.lora_dab.launches
    da, db = tlf.lora_dab(x, g, a, b, scale)
    torch.cuda.synchronize()
    assert tlf.lora_dab.launches == before + 1
    assert da.dtype == db.dtype == torch.bfloat16
    wda, wdb = tlf.lora_dab_ref(x, g, a, b, scale)
    for got, want in ((da, wda), (db, wdb)):
        _assert_close_scaled(got, want, dict(rtol=2.0 ** -6, atol=1e-2))
    da2, db2 = tlf.lora_dab(x, g, a, b, scale)
    assert torch.equal(da, da2) and torch.equal(db, db2)
    plan = tlf.dab_plan(M, K, N, r)
    assert 1 <= plan["members"] <= 8 and 1 <= plan["sub_runs"] <= 8
    assert plan["workspace"] == (0 if plan["sub_runs"] == 1 else
                                 plan["sub_runs"] * r * (K + N))
    assert 0 < plan["smem_bytes"] <= 232448
    if M >= 192:   # the path's rows fill the card: 8 sub-runs of 8 members
        assert plan["sub_runs"] * plan["members"] >= 48


# qwen2.5-32b's MLP (K or N 27,648) and a ragged rank-16 case there: at 8
# members a member's slice does not fit shared memory, and the plan takes
# one of H100's non-portable clusters of up to 16
DAB_WIDE_CASES = [(256, 5120, 27648, 8), (256, 27648, 5120, 8),
                  (65, 27648, 5120, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,r", DAB_WIDE_CASES)
def test_lora_dab_bf16_wide_slices_take_wide_clusters(M, K, N, r):
    """dA/dB where 8 members' slices would not fit: its plan takes 9-16
    members, and it matches its plain version (the card tolerance above)
    with the same bits on a second launch."""
    _need_card()
    x, _, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(21, M, K, N, r))]
    plan = tlf.dab_plan(M, K, N, r)
    assert 8 < plan["members"] <= 16
    assert 0 < plan["smem_bytes"] <= 232448
    da, db = tlf.lora_dab(x, g, a, b, 2.0)
    torch.cuda.synchronize()
    wda, wdb = tlf.lora_dab_ref(x, g, a, b, 2.0)
    for got, want in ((da, wda), (db, wdb)):
        _assert_close_scaled(got, want, dict(rtol=2.0 ** -6, atol=1e-2))
    da2, db2 = tlf.lora_dab(x, g, a, b, 2.0)
    assert torch.equal(da, da2) and torch.equal(db, db2)


# one bf16 lora_dab call (M 256, gate/up: 8 sub-runs) and one bf16
# lora_grouped_dab call (OLMoE's E 64 x 40 rows) under torch.profiler, in a
# process of its own (as _PROFILE_DX)
_PROFILE_DAB = r"""
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import lora_fused as lf
from repro_torch.kernels import lora_grouped as lg

gen = torch.Generator(device="cuda").manual_seed(0)
rn = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
x, g, a, b = rn(256, 896), rn(256, 4864), rn(896, 8), rn(8, 4864)
xe, ge, ae, be = rn(2560, 2048), rn(2560, 1024), rn(64, 2048, 8), rn(64, 8,
                                                                    1024)
gid = torch.arange(64, dtype=torch.int32, device="cuda")
calls = [lambda: lf.lora_dab(x, g, a, b, 2.0),
         lambda: lg.lora_grouped_dab(xe, ge, ae, be, gid, 2.0, bm=40)]
for fn in calls:
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for fn in calls:
        fn()
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


@pytest.mark.cuda
def test_lora_dab_bf16_is_one_device_kernel():
    """A bf16 dA/dB call, dense or grouped, runs one device kernel, the
    tensor-core body (dab_tc<8>): no reduce pass. And no PyTorch operator
    but the allocations of the outputs and of the few sub-run partials."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    from torch.utils._python_dispatch import TorchDispatchMode
    _need_card()
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out = subprocess.run([sys.executable, "-c", _PROFILE_DAB], env=env,
                         check=True, capture_output=True, text=True).stdout
    kernels = json.loads(out.strip().splitlines()[-1])
    assert len(kernels) == 2, kernels
    assert all("dab_tc<8>" in k for k in kernels), kernels

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))
    x, _, a, b, g = [t.to(torch.bfloat16).cuda() for t in _t(
        *_fused_inputs(21, 256, 896, 4864, 8))]
    tlf.lora_dab(x, g, a, b, 2.0)   # the zeroed counts are made once
    with Ops() as ops:
        tlf.lora_dab(x, g, a, b, 2.0)
    assert set(ops.names) == {"aten.empty.memory_format"}, ops.names


@pytest.mark.cuda
def test_lora_training_kernels_reject_bad_input():
    _need_card()
    x, w0, a, b, g = [t.cuda() for t in _t(*_fused_inputs(15, 8, 32, 40, 4))]
    with pytest.raises(TypeError, match="expected"):
        tlf.lora_fused(x, w0.bfloat16(), a, b)
    with pytest.raises(ValueError, match="contiguous"):
        tlf.lora_dx(g, w0.T.contiguous().T, a, b)
    with pytest.raises(ValueError, match="rank"):
        tlf.lora_dab(x, g, torch.zeros(32, 33, device="cuda"),
                     torch.zeros(33, 40, device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        tlf.lora_fused(x, w0, a, b[:, :39].contiguous())


def _rms_bwd_inputs(M, d, dtype, seed, off=0):
    """x, w, g for the RMSNorm backward, each ``off`` elements into a fresh
    buffer (off 1: bases off 16-byte alignment)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(M * d + off, generator=gen) * 3).to(dt).cuda()
    w = torch.randn(d + off, generator=gen).to(dt).cuda()
    g = torch.randn(M * d + off, generator=gen).to(dt).cuda()
    return x[off:].view(M, d), w[off:], g[off:].view(M, d)


def _check_rms_bwd(x, w, g, dtype):
    before = trn.rmsnorm_bwd.launches
    dx, dw = trn.rmsnorm_bwd(x, w, g, 1e-6)
    torch.cuda.synchronize()
    assert trn.rmsnorm_bwd.launches == before + 1
    wdx, wdw = trn.rmsnorm_bwd_ref(x, w, g, 1e-6)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    _assert_close_scaled(dx, wdx, tol)
    _assert_close_scaled(dw, wdw, tol)
    dx2, none = trn.rmsnorm_bwd(x, w, g, 1e-6, need_dw=False)
    assert none is None and torch.equal(dx2, dx)


# one row, a part block of rows, the paths' [192-256, 896] and [256, 2048]
# in 16-byte units, widths that take element loads (1000, 72, 899), and a
# row wider than a warp holds (5000: two passes)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,d", [(192, 896), (3, 1000), (64, 72), (1, 896),
                                 (8, 896), (256, 896), (256, 2048), (5, 899),
                                 (3, 5000), (256, 384), (1500, 384),
                                 (512, 896)])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(M, d, dtype):
    _need_card()
    _check_rms_bwd(*_rms_bwd_inputs(M, d, dtype, 8), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_kernel_takes_an_unaligned_row_base(dtype):
    """x, w and g one element (2 bytes in bf16) off 16-byte alignment: the
    kernel's element-by-element loads, held as tightly as the aligned
    ones."""
    _need_card()
    x, w, g = _rms_bwd_inputs(8, 896, dtype, 9, off=1)
    assert x.data_ptr() % 16 and x.is_contiguous()
    _check_rms_bwd(x, w, g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,d", [(256, 896), (256, 2048), (3, 5000)])
def test_rmsnorm_bwd_kernel_is_bitwise_on_repeat(M, d, dtype):
    """Two launches on the same inputs give the same dx and dw bits (sums
    by warp shuffles and dw partials added in a fixed order)."""
    _need_card()
    x, w, g = _rms_bwd_inputs(M, d, dtype, 10)
    dx, dw = trn.rmsnorm_bwd(x, w, g, 1e-6)
    dx2, dw2 = trn.rmsnorm_bwd(x, w, g, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
