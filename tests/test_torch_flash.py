"""The port's flash attention against the JAX reference's flash kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against ``repro.kernels.flash_attention`` run with ``interpret=True`` (as
``test_pallas_mode.py`` runs it) on the same numpy-seeded inputs: out, lse,
dq, dk and dv at rtol = atol = 1e-5 in f32 (the two differ only in
summation order), and lse exactly -1e30 on rows that see no key. The
autograd Function of the dispatch is held against the reference's
``ops.flash_attention`` VJP. The tests marked ``cuda`` hold the CUDA
kernels against their plain versions on a card and skip without one; JAX
is imported only inside the parity tests, so that the card-only tests also
run where JAX is not installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rope as trope
from repro_torch.core import structured as TS

TOL = dict(rtol=1e-5, atol=1e-5)
THETA = 10000.0
BLK = 64        # the reference's tiles, so its sparse grid has many tiles


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's flash and RoPE modules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import flash_attention, ops, rope
    return SimpleNamespace(jax=jax, jnp=jnp, fa=flash_attention, ops=ops,
                           rope=rope)


def _inputs(seed, BHkv, G, nq, nk, D):
    """q, k, v, g as numpy f32: q and g [BHkv·G, nq, D], k and v
    [BHkv, nk, D]."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.7).astype(np.float32)
    return f(BHkv * G, nq, D), f(BHkv, nk, D), f(BHkv, nk, D), \
        f(BHkv * G, nq, D)


# (nq, nk, D, G, causal, window, rope): together they cover causal and not,
# window 0 and 32, G 1 and 4, (Nq, Nk) in {(96, 96), (128, 128), (300,
# 300)}, D 16 and 40, rope on and off, Nq != Nk and rows that see no key
# (causal + window with Nq > Nk + window: rows from 127 on)
CASES = {
    "96-causal-G4-d40": (96, 96, 40, 4, True, 0, False),
    "96-window-G1-d16-rope": (96, 96, 16, 1, True, 32, True),
    "128-full-G1-d40-rope": (128, 128, 40, 1, False, 0, True),
    "128-full-window-G4-d16": (128, 128, 16, 4, False, 32, False),
    "300-causal-window-G4-d40-rope": (300, 300, 40, 4, True, 32, True),
    "300-causal-G1-d16": (300, 300, 16, 1, True, 0, False),
    "300-full-G4-d16-rope": (300, 300, 16, 4, False, 0, True),
    "dead-rows-160x96-G4-d16": (160, 96, 16, 4, True, 32, False),
}


def _kw(case):
    _, _, _, G, causal, window, _ = CASES[case]
    return dict(causal=causal, window=window, q_per_kv=G)


@pytest.fixture(scope="module")
def jax_flash(jx):
    """{case: (inputs, out, lse, dq, dk, dv)} from the reference kernels in
    interpret mode, computed once per case."""
    cache = {}

    def run(case):
        if case not in cache:
            nq, nk, D, G, causal, window, rope = CASES[case]
            ins = _inputs(len(cache), 2, G, nq, nk, D)
            q, k, v, g = (jx.jnp.asarray(a) for a in ins)
            tabs = jx.rope.rope_tables(jx.jnp.arange(nq), THETA, D) \
                if rope else None
            kw = dict(_kw(case), interpret=True, bq=BLK, bk=BLK)
            out, lse = jx.fa.flash_attention_fwd(q, k, v, tabs,
                                                 return_lse=True, **kw)
            grads = jx.fa.flash_attention_bwd(q, k, v, out, lse, g, tabs,
                                              **kw)
            cache[case] = (ins, *(np.array(a) for a in (out, lse, *grads)))
        return cache[case]
    return run


def _torch_rope(case):
    nq, _, D, _, _, _, rope = CASES[case]
    return trope.rope_tables(torch.arange(nq), THETA, D) if rope else None


@pytest.mark.parametrize("case", list(CASES))
def test_fwd_ref_matches_pallas_kernel(jax_flash, case):
    ins, out, lse, *_ = jax_flash(case)
    q, k, v, _ = map(torch.from_numpy, ins)
    got, got_lse = tfa.flash_attention_fwd_ref(q, k, v, _torch_rope(case),
                                               return_lse=True, **_kw(case))
    assert got.dtype == q.dtype and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), out, **TOL)
    dead = lse == tfa.NEG_INF
    np.testing.assert_array_equal(got_lse.numpy() == tfa.NEG_INF, dead)
    np.testing.assert_allclose(got_lse.numpy(), lse, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_pallas_kernel(jax_flash, case):
    ins, out, lse, dq, dk, dv = jax_flash(case)
    q, k, v, g = map(torch.from_numpy, ins)
    got = tfa.flash_attention_bwd_ref(
        q, k, v, torch.from_numpy(out), torch.from_numpy(lse), g,
        _torch_rope(case), **_kw(case))
    for name, t, want in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert t.shape == want.shape, name
        np.testing.assert_allclose(t.numpy(), want, err_msg=name, **TOL)


def test_rows_that_see_no_key_give_zeros(jax_flash):
    """causal + window 32 with Nq 160 > Nk 96 + 32: rows from 127 on see
    no key. out 0, lse exactly -1e30, no NaN, zero dq there."""
    case = "dead-rows-160x96-G4-d16"
    ins, out, lse, dq, *_ = jax_flash(case)
    q, k, v, g = map(torch.from_numpy, ins)
    o, l = tfa.flash_attention_fwd(q, k, v, return_lse=True, **_kw(case))
    assert bool((l[:, 127:] == tfa.NEG_INF).all())
    assert bool((l[:, :127] > tfa.NEG_INF).all())
    assert bool((o[:, 127:] == 0).all()) and np.all(out[:, 127:] == 0)
    grads = tfa.flash_attention_bwd(q, k, v, o, l, g, **_kw(case))
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    assert bool((grads[0][:, 127:] == 0).all()) and np.all(dq[:, 127:] == 0)


def test_cpu_wrappers_take_the_plain_versions():
    """CPU tensors: the wrappers return the plain versions' results and
    launch nothing; a bad layout raises on the CPU too."""
    q, k, v, g = map(torch.from_numpy, _inputs(9, 2, 2, 70, 70, 24))
    kw = dict(causal=True, window=0, q_per_kv=2)
    tops.reset_launch_counts()
    out, lse = tfa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    wout, wlse = tfa.flash_attention_fwd_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, wout) and torch.equal(lse, wlse)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    want = tfa.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts = tops.launch_counts()
    assert {counts[n] for n in ("flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv")} == {0}
    with pytest.raises(ValueError, match="q_per_kv"):
        tfa.flash_attention_fwd(q, k, v, q_per_kv=3)
    with pytest.raises(ValueError, match="rope"):
        tfa.flash_attention_fwd(q, k[:, :64].contiguous(),
                                v[:, :64].contiguous(),
                                trope.rope_tables(torch.arange(70), THETA,
                                                  24), q_per_kv=2)


# ----------------------------------------------- the dispatch's Function


@pytest.mark.parametrize("rope,window", [(False, 0), (True, 0), (True, 48)])
def test_flash_function_matches_reference_vjp(jx, rope, window):
    """``ops.sdpa`` from 64 query rows (the ``_FlashAttention`` Function)
    against ``repro.kernels.ops.flash_attention`` in interpret mode: out
    and the gradients of q, k and v, on [B, H, N, D] layouts (B 2, H 4,
    Hkv 2, N 100, D 40)."""
    jnp = jx.jnp
    rng = np.random.default_rng(11)
    f = lambda *s: (rng.standard_normal(s) * 0.7).astype(np.float32)
    q, k, v, g = f(2, 4, 100, 40), f(2, 2, 100, 40), f(2, 2, 100, 40), \
        f(2, 4, 100, 40)
    jtabs = jx.rope.rope_tables(jnp.arange(100), THETA, 40) if rope else None
    jout, vjp = jx.jax.vjp(
        lambda q, k, v: jx.ops.flash_attention(q, k, v, True, window, True,
                                               jtabs),
        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    tabs = trope.rope_tables(torch.arange(100), THETA, 40) if rope else None
    out = tops.sdpa(tq, tk, tv, causal=True, window=window, rope=tabs)
    assert out.grad_fn.name().endswith("_FlashAttentionBackward")
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for t, j in zip(grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_flash_function_saves_q_k_v_out_lse():
    """The Function's residuals, seen through ``saved_tensors_hooks``: the
    kernels' q, k, v, out and lse, and nothing else (no [N, N]
    probabilities, no rotated q or k with fused RoPE)."""
    rng = np.random.default_rng(12)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).requires_grad_(True)
    q, k, v = f(2, 4, 80, 16), f(2, 2, 80, 16), f(2, 2, 80, 16)
    for tabs in (None, trope.rope_tables(torch.arange(80), THETA, 16)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            out = tops.sdpa(q, k, v, causal=True, rope=tabs)
        assert [tuple(t.shape) for t in saved] == [
            (8, 80, 16), (4, 80, 16), (4, 80, 16), (8, 80, 16), (8, 80)]
        assert torch.equal(saved[0], q.detach().reshape(8, 80, 16))
        assert saved[3].data_ptr() == out.data_ptr()
        assert saved[4].dtype == torch.float32


def test_sdpa_below_64_rows_takes_the_structured_path_with_tables():
    """Below 64 query rows the dispatch applies deferred RoPE tables in
    torch and runs the structured sdpa, as the reference's fallback."""
    rng = np.random.default_rng(13)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q, k, v = f(2, 4, 40, 16), f(2, 2, 40, 16), f(2, 2, 40, 16)
    tabs = trope.rope_tables(torch.arange(40), THETA, 16)
    out = tops.sdpa(q.requires_grad_(True), k, v, causal=True, rope=tabs)
    assert "Flash" not in out.grad_fn.name()
    want = TS.sdpa(trope.apply_rope_tables(q, *tabs),
                   trope.apply_rope_tables(k, *tabs), v, 0, True)
    assert torch.equal(out, want)


def test_rope_tables_match_reference(jx):
    pos = np.arange(37)
    jc, js = jx.rope.rope_tables(jx.jnp.asarray(pos), THETA, 24)
    tc, ts = trope.rope_tables(torch.from_numpy(pos), THETA, 24)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    x = np.random.default_rng(14).standard_normal((3, 37, 24)).astype(
        np.float32)
    np.testing.assert_allclose(
        trope.apply_rope_tables(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jx.rope.apply_rope_tables(jx.jnp.asarray(x), jc, js)),
        **TOL)


# ------------------------------------------------------------- card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


def _close_scaled(got, want, tol):
    """assert_close with the absolute floor taken relative to the output's
    largest magnitude (at least 1)."""
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# (BHkv, G, nq, nk, D, causal, window, rope): the training path's shape
# (B·H 14, B·Hkv 2, N 256, D 64, causal) and the edge cases
CARD_CASES = {
    "path": (2, 7, 256, 256, 64, True, 0, False),
    "path-rope": (2, 7, 256, 256, 64, True, 0, True),
    "window32": (2, 7, 256, 256, 64, True, 32, False),
    "full": (2, 7, 256, 256, 64, False, 0, True),
    "ragged300": (2, 7, 300, 300, 64, True, 0, True),
    "nq-ne-nk": (2, 3, 200, 136, 64, True, 0, False),
    "dead-rows": (2, 3, 384, 128, 64, True, 64, False),
    "G1": (4, 1, 256, 256, 64, True, 0, False),
    "d40": (2, 2, 96, 96, 40, True, 32, True),
    "d128": (2, 7, 256, 256, 128, True, 0, True),
    # the 128 instance with D padded to 80 on tensor cores
    "d72": (2, 7, 256, 256, 72, True, 0, True),
    # one row and one column past a tile
    "nk65": (2, 7, 65, 65, 64, True, 0, False),
    # the parallel dk/dv group sum under a window
    "G7-window-rope": (2, 7, 256, 256, 64, True, 48, True),
    # dk/dv clusters of 8 blocks, 2 group members each; 11 and 12 members
    # over 8 blocks (shares of 1 or 2), the second in the 128 instance
    "G16": (1, 16, 130, 130, 64, True, 0, True),
    "G11": (1, 11, 96, 96, 40, False, 0, False),
    "G12-d128": (1, 12, 128, 128, 128, True, 0, True),
    # the 256 instance: Gemma3-12B's two path shapes (B·H 16, B·Hkv 8, N
    # 2048, D 256; a local layer's window 1024 and a global layer), ragged
    # N, Nq != Nk, D 200 (padded to 208) under a window, G 1
    "gemma3-local": (8, 2, 2048, 2048, 256, True, 1024, False),
    "gemma3-global-rope": (8, 2, 2048, 2048, 256, True, 0, True),
    "d256-ragged300": (2, 2, 300, 300, 256, True, 0, True),
    "d256-nq-ne-nk": (2, 2, 200, 136, 256, True, 0, False),
    "d200-window48": (2, 2, 256, 256, 200, True, 48, True),
    "d256-G1": (4, 1, 256, 256, 256, False, 0, False),
    # Whisper-tiny over 6 heads (a key read past Nk would land on the next
    # head's keys): its encoder, non-causal over 1,500 frames (23 tiles of
    # 64 and a tail of 28, masked by the key count alone); its
    # cross-attention, 256 queries over them (dk/dv of every key tile back
    # to the encoder); its causal decoder; InternVL2-1B at 512 rows, G 7
    "whisper-encoder": (6, 1, 1500, 1500, 64, False, 0, False),
    "whisper-cross": (6, 1, 256, 1500, 64, False, 0, False),
    "whisper-decoder": (6, 1, 256, 256, 64, True, 0, False),
    "internvl": (2, 7, 512, 512, 64, True, 0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_flash_kernels_match_plain_on_card(case, dtype):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain
    versions on the same inputs. f32: summation order only (1e-4). bf16:
    the LoRA kernels' scheme, about one bf16 step of each output's
    largest magnitude (2^-6 relative, 1e-2 of the largest magnitude
    absolute: p and ds are rounded from f32 values that differ by
    summation order, so a rounding may fall the other way). lse is f32 in
    both: 1e-4, and exactly -1e30 on the same rows."""
    _need_card()
    BHkv, G, nq, nk, D, causal, window, rope = CARD_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(a).to(dt).cuda()
                  for a in _inputs(21, BHkv, G, nq, nk, D))
    tabs = tuple(t.cuda() for t in trope.rope_tables(
        torch.arange(nq), THETA, D)) if rope else None
    kw = dict(causal=causal, window=window, q_per_kv=G)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2.0 ** -6, atol=1e-2)
    before = tops.launch_counts()
    out, lse = tfa.flash_attention_fwd(q, k, v, tabs, return_lse=True, **kw)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, g, tabs, **kw)
    torch.cuda.synchronize()
    after = tops.launch_counts()
    assert all(after[n] == before[n] + 1
               for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    wout, wlse = tfa.flash_attention_fwd_ref(q, k, v, tabs, return_lse=True,
                                             **kw)
    assert torch.equal(lse == tfa.NEG_INF, wlse == tfa.NEG_INF)
    torch.testing.assert_close(lse, wlse, rtol=1e-4, atol=1e-4)
    _close_scaled(out, wout, tol)
    # the backward's plain version from the kernel's own out and lse
    want = tfa.flash_attention_bwd_ref(q, k, v, out, lse, g, tabs, **kw)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dt and got.shape == w.shape
        _close_scaled(got, w, tol)
    # dk and dv: each tile summed in a fixed order, the same bits again
    dk2, dv2 = tfa.flash_bwd_dkv(q, k, v, g.to(dt), lse,
                                 tfa.bwd_delta(g, out), tabs, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
def test_flash_kernels_reject_bad_input():
    _need_card()
    q, k, v, _ = (torch.from_numpy(a).cuda()
                  for a in _inputs(22, 2, 2, 64, 64, 36))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, k, v, q_per_kv=2)
    q, k, v, _ = (torch.from_numpy(a).cuda()
                  for a in _inputs(22, 2, 2, 64, 64, tfa.MAX_D + 8))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q, k, v, q_per_kv=2)
    q, k, v, _ = (torch.from_numpy(a).cuda()
                  for a in _inputs(22, 2, 2, 64, 64, 32))
    with pytest.raises(TypeError, match="expected"):
        tfa.flash_attention_fwd(q, k.bfloat16(), v, q_per_kv=2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q.transpose(0, 1).contiguous().transpose(
            0, 1), k, v, q_per_kv=2)


@pytest.mark.cuda
def test_flash_kernels_reject_misaligned_bf16():
    """The bf16 kernels copy 16-byte rows: a q that starts 2 bytes into a
    buffer (contiguous, at an element offset of 1) raises, it is not run
    on another body."""
    _need_card()
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16).cuda()
                  for a in _inputs(23, 2, 2, 64, 64, 32))
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    qm = buf[1:].view(q.shape)
    qm.copy_(q)
    assert qm.is_contiguous() and qm.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_fwd(qm, k, v, q_per_kv=2)
    out, lse = tfa.flash_attention_fwd(q, k, v, q_per_kv=2, return_lse=True)
    delta = tfa.bwd_delta(g, out)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_bwd_dq(qm, k, v, g, lse, delta, q_per_kv=2)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_bwd_dkv(qm, k, v, g, lse, delta, q_per_kv=2)
