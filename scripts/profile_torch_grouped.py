"""Per-launch device time of the port's bf16 LoRA kernels on the card: the
grouped forward and input gradient over expert stacks
(``lora_grouped_gemm`` / ``lora_grouped_dx``, ``_gemm_q`` / ``_dx_q`` over
int8, ``_gemm_q4`` / ``_dx_q4`` over int4 and nf4) at the OLMoE-1B-7B
training path's shapes, and the dense forward over one W0
(``lora_fused``, ``lora_fused_q``, ``lora_fused_q4``) at the training
paths' shapes.

Grouped (``--family grouped``):

E 64 experts, capacity C = bm = 40 (M 2,560 rows, every expert one tile),
r 8, (K, N) of gate/up (2048 x 1024) and down (1024 x 2048); random inputs
made from a seed, timed cold with ``chip_smoke.py``'s timer and input sets
(``_time_ms`` over ``_cold_sets``: enough copies that every launch finds
its inputs out of L2). It uses the ``chip_smoke`` and ``repro_torch`` found
on the path, so one call can time two checkouts in turns:

    PYTHONPATH=src:. python scripts/profile_torch_grouped.py \
        [--family grouped|dense|both|dab|decode|decode_sweep|norm_rope|
                  rmsnorm_bwd_sweep] [--label L]

Prints one JSON line: ms per launch by format and shape, the bound (bytes
at 3.35 TB/s or FLOPs at 989 TFLOP/s), the card and its power limit; and,
for the bf16 forward over a bf16 stack at each shape, the share of outputs
that round otherwise than the plain version's and the mean |error| of each
against an f64 product over the same inputs (h rounded to bf16 as both
round it); and the SHA-256 of each format's output at each shape on the
first input set, so two checkouts' bits can be compared.

The grouped dx (same family, same shapes and inputs): ms per launch of the
wrapper (its PyTorch dh = round((s g) @ B^T) and the kernel; ``dh_ms`` the
dh alone, ``kernel_ms`` the kernel alone on the same dh), its plain
version and the per-expert ``torch.matmul`` of g @ W0^T (over the
dequantized stack for codes) as context, beside the bound; for every format the share of outputs that round otherwise than the
plain version and the mean |error| of each against an f64 product of the
same bf16 operands (g, or round(g * round(S)) over codes; the codes as
weights; dh as the wrapper rounds it), and the SHA-256 of the output; and
the SHA-256 of the f32 dx (the CUDA-core body) on one f32 input set.

Dense (``--family dense``): the paper path's M 256 and the seq-48 path's
M 192 at qwen2.5-0.5b's four shapes, and OLMoE-1B-7B's q, k, v, o at M 256
(2048 x 2048), over bf16, int8, int4 and nf4, r 8, inputs from
``chip_smoke._train_cases`` / ``_quant_cases``, cold as above: ms per
launch of the forward, its plain version and ``torch.matmul`` of x @ W0
(over the dequantized W0 for a quantized base) as context, beside the
bound. The dense dx at the same shapes and formats (g [M, N] -> dx [M,
K]): ms per launch of the kernel alone (its C entry: on a tree whose bf16
dx sums dh itself, that entry; on one whose wrapper computes dh first, the
entry on that dh made beforehand), of the whole wrapper, of its plain
version and of ``torch.matmul`` of g @ W0^T, beside the bound; and, at M
256, the share of outputs that round otherwise than the plain version and
the mean |error| of each against an f64 product of the same bf16 operands
(g, or round(g * round(S)) over codes; dh as the plain version rounds it),
and the SHA-256 of the kernel's output. The same JSON line carries them.

Factor gradients (``--family dab``): the bf16 ``lora_dab`` at the dense
shapes above and the bf16 ``lora_grouped_dab`` at the grouped ones (E 64,
C = bm 40), cold as above: ms per launch of the kernel (its wrapper), of
its plain version, and of two products as context (``torch.mm`` of x^T by
r columns of g and of r columns of x, transposed, by g: the shapes of its
two row contractions; per expert ``torch.bmm`` grouped), beside the bound
(x, g, A and B read once, dA and dB written once); the share of dA's and
dB's entries that round otherwise than the plain version's and the mean
|error| of each against an f64 product of the same bf16 operands (x,
round(s g), and h and dh as the plain version rounds them); the SHA-256 of
the bf16 dA and dB, and of the f32 dA and dB on one f32 input set (the
CUDA-core body, which must keep its bits); and, on a tree that has it, the
bf16 body's plan at each shape (``lora_fused.dab_plan``,
``lora_grouped.dab_plan``).

Decode (``--family decode``): the grouped forward over one shared base
(``lora_grouped``, ``lora_grouped_q``, ``lora_grouped_q4``) at the
qwen2.5-0.5b decode shapes (8 slots in tiles of 2, 4 adapters, r 8, the
routing of ``chip_smoke.PATH_GID``; inputs from ``chip_smoke``'s decode
checks), over bf16, int8, int4 and nf4, cold as above: ms per launch of
the bf16 kernel, its plain version and ``torch.matmul`` of x @ W0 over the
bf16 (or dequantized) W0, beside the bound (x, W0 or its codes and scale,
the A and B of the slots in use and gid read once, y written once), and
the ms of a decode step (each shape's launches a step: 48, 48, 48, 24);
the share of outputs that round otherwise than the plain version and the
mean |error| of each against an f64 product of the same operands (the
codes as weights, h as the plain version rounds it); the SHA-256 of the
bf16 output and of the f32 output (the CUDA-core body, which must keep
its bits) on seeded input sets; on a tree that has it, the bf16 body's
plan (``lora_grouped.decode_plan``). Then the RMSNorm forward at [8, 896]
(decode), [256, 896] and [256, 2048] (training), warm, as
``chip_smoke.py`` times it: ms per launch of the kernel, its plain
version and ``F.rms_norm``, and the bound.

Norms and RoPE (``--family norm_rope``): the RMSNorm backward in bf16,
need_dw false, warm as ``chip_smoke.py`` times it and cold, at [192, 896] and
[256, 896] (the dense paths) and [256, 2048] (OLMoE): ms per launch of the
kernel, its plain version and the library's one call
(``chip_smoke.rms_bwd_library``), beside the bound (x and g read once, w
once, dx written once); the standalone RoPE in bf16, cold, at
``chip_smoke.ROPE_CASES`` beside the plain rotation, a copy of x (one
read and one write of it, as context) and the bound; and
the RMSNorm forward's output SHA-256s (``chip_smoke.rmsnorm_fwd_sha256``).
``chip_smoke`` puts no port on the path when imported, so from a parent
checkout (``cd checkout/parent && PYTHONPATH=src:../.. python
../../scripts/profile_torch_grouped.py --family norm_rope``) this
measures the parent's kernels with this tree's inputs and timing.

Rows a block (``--family rmsnorm_bwd_sweep``): the RMSNorm backward of the
``repro_torch`` on the path, built as it is and, where its source takes
``-DRMS_BWD_WARPS``, with 1, 2 and 4 warps (rows) a block (one ``nvcc``
each into the build directory), timed warm through its C entry at 8 to
1,024 rows of 896 and of 2048, and whether the builds give the same dx
bits. From a parent checkout (as above) it times the parent's kernel.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import subprocess

import torch

import chip_smoke as cs
from repro_torch.core import quant
from repro_torch.kernels import lora_fused as lf
from repro_torch.kernels import lora_grouped as lg
from repro_torch.kernels import lora_pack4 as lp4
from repro_torch.kernels import lora_quant as lq

E, C, R = 64, 40, 8
SHAPES = {"gate_up": (2048, 1024), "down": (1024, 2048)}
CALLS = 400
# the dense forward: (M, K, N) of the paths' LoRA linears
DENSE_SHAPES = {
    **{f"M{m}/{name}": (m, k, n) for m in (256, 192) for name, (k, n) in {
        "q_o": (896, 896), "k_v": (896, 128), "gate_up": (896, 4864),
        "down": (4864, 896)}.items()},
    "olmoe/qkvo": (256, 2048, 2048)}


def _call(method):
    """The bf16 forward of ``method`` ("dense", "int8", "int4", "nf4") on
    the inputs of ``chip_smoke._moe_cases`` / ``_moe_q_cases``."""
    if method == "dense":
        return lambda x, w, a, b, g, gid: lg.lora_grouped_gemm(
            x, w, a, b, gid, 2.0, bm=C)
    if method == "int8":
        return lambda x, q, s, a, b, g, gid, w: lg.lora_grouped_gemm_q(
            x, q, s, a, b, gid, 2.0, bm=C)
    return lambda x, q, s, a, b, g, gid, w: lg.lora_grouped_gemm_q4(
        x, q, s, a, b, gid, 2.0, bm=C, method=method)


def _dx_call(method):
    """(bf16 dx of ``method``, its plain version, g @ W0^T per expert) on
    the inputs of ``chip_smoke._moe_cases`` / ``_moe_q_cases``."""
    def per_expert(t, w):      # [M, ·] rows as [E, M / E, ·]
        return t.view(w.shape[0], -1, t.shape[1])
    if method == "dense":
        return (lambda x, w, a, b, g, gid: lg.lora_grouped_dx(
                    g, w, a, b, gid, 2.0, bm=C),
                lambda x, w, a, b, g, gid: lg.lora_grouped_dx_ref(
                    g, w, a, b, gid, 2.0, bm=C),
                lambda x, w, a, b, g, gid: torch.matmul(per_expert(g, w),
                                                        w.mT))
    if method == "int8":
        dx, ref = lg.lora_grouped_dx_q, lg.lora_grouped_dx_q_ref
    else:
        dx, ref = (functools.partial(f, method=method) for f in (
            lg.lora_grouped_dx_q4, lg.lora_grouped_dx_q4_ref))
    return (lambda x, q, s, a, b, g, gid, w: dx(g, q, s, a, b, gid, 2.0,
                                                bm=C),
            lambda x, q, s, a, b, g, gid, w: ref(g, q, s, a, b, gid, 2.0,
                                                 bm=C),
            lambda x, q, s, a, b, g, gid, w: torch.matmul(per_expert(g, w),
                                                          w.mT))


def _dx_kernel_call(method):
    """The dx kernel alone (its C entry, no counter) on a ``_dx_call`` input
    set with the wrapper's dh appended."""
    if method == "dense":
        def call(x, w, a, b, g, gid, dh):
            M, (E_, K, N), r = g.shape[0], w.shape, a.shape[2]
            return lg._launch_train(
                "lora_grouped_dx", lg._GDX_ARGS, (lg._DTYPES[g.dtype],), g,
                (g, w, a, dh, gid), (M, K), (M, K, N, E_, r, C))
        return call
    entry, argtypes, lead = (
        ("lora_grouped_dx_q", lg._GDXQ_ARGS, ()) if method == "int8" else
        ("lora_grouped_dx_q4", lg._GDXQ4_ARGS,
         (lp4.METHOD_CODES[method],)))

    def call(x, q, s, a, b, g, gid, w, dh):
        M, (E_, K, r), N = g.shape[0], a.shape, g.shape[1]
        return lg._launch_train(
            entry, argtypes, (lg._DTYPES[g.dtype], *lead), g,
            (g, q, s, a, dh, gid), (M, K), (M, K, N, E_, r, C))
    return call


def _dh_call(method):
    """The dx wrapper's own PyTorch part, dh = round((s g) @ B^T)."""
    if method == "dense":
        return lambda x, w, a, b, g, gid: lg._grouped_dh(g, b, gid, 2.0,
                                                         bm=C)
    return lambda x, q, s, a, b, g, gid, w: lg._grouped_dh(g, b, gid, 2.0,
                                                           bm=C)


def dx_rounding(method, args):
    """The bf16 dx and its plain version against f64 on one input set
    (every expert one tile): share of outputs that differ, and each one's
    mean |error|, and the SHA-256 of the kernel's output."""
    kern, plain, _ = _dx_call(method)
    y, ref = kern(*args), plain(*args)
    if method == "dense":
        _, w, a, b, g, gid = args
        p, wt = g, w
    else:
        _, q, s, a, b, g, gid, _ = args
        p = (g.view(E, C, -1) * s.to(g.dtype)).view(g.shape)
        wt = q.double() if method == "int8" else lp4.unpack_weights(
            q, method, g.dtype, a.shape[1])
    dh = lg._grouped_dh(g, b, gid, 2.0, bm=C).view(E, C, -1)
    exact = (p.view(E, C, -1).double() @ wt.double().mT
             + dh.double() @ a.double().mT).view(y.shape)
    torch.cuda.synchronize()
    return {"differ_share": float((y != ref).double().mean()),
            "kernel_mean_abs_err": float((y.double() - exact).abs().mean()),
            "plain_mean_abs_err": float((ref.double() - exact).abs().mean()),
            "sha256": hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()}


def dx_f32_sha256(method, gen, K, N):
    """The SHA-256 of the f32 dx (the CUDA-core body) of ``method`` on one
    f32 input set at K x N."""
    if method == "dense":
        args = cs._moe_cases(torch, gen, torch.float32, E * C, K, N, E, R,
                             list(range(E)))()
    else:
        args = cs._moe_q_cases(torch, quant, gen, torch.float32, method,
                               E * C, K, N, E, R, list(range(E)))()
    y = _dx_call(method)[0](*args)
    torch.cuda.synchronize()
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()


def rounding(x, w, a, b, gid):
    """The bf16 forward and its plain version against f64 on one input
    set: share of outputs that differ, and each one's mean |error|."""
    y = lg.lora_grouped_gemm(x, w, a, b, gid, 2.0, bm=C)
    ref = lg.lora_grouped_gemm_ref(x, w, a, b, gid, 2.0, bm=C)
    xt = x.view(E, C, -1)
    h = (xt.float() @ a.float()).to(torch.bfloat16).double()
    exact = (xt.double() @ w.double() + 2.0 * (h @ b.double())).view(y.shape)
    return {"differ_share": float((y != ref).double().mean()),
            "kernel_mean_abs_err": float((y.double() - exact).abs().mean()),
            "plain_mean_abs_err": float((ref.double() - exact).abs().mean())}


def grouped():
    """The grouped forward's and dx's per-launch times, bf16 rounding and
    output hashes at the MoE path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    gid = list(range(E))
    M = E * C
    out, rnd, bits, dx_out, dx_rnd = {}, {}, {}, {}, {}
    for method in ("dense", "int8", "int4", "nf4"):
        for shape, (K, N) in SHAPES.items():
            if method == "dense":
                make = cs._moe_cases(torch, gen, torch.bfloat16, M, K, N, E,
                                     R, gid)
                w_bytes = 2 * E * K * N
            else:
                make = cs._moe_q_cases(torch, quant, gen, torch.bfloat16,
                                       method, M, K, N, E, R, gid)
                w_bytes = E * (K * N if method == "int8"
                               else (K + 1) // 2 * N) + 4 * E * N
            nbytes = w_bytes + 2 * (M * (K + N) + E * R * (K + N)) + 4 * E
            flops = 2 * M * K * N + 2 * M * R * (K + N)
            bound, by = cs._bound_ms(nbytes, flops)
            sets = cs._cold_sets(make, nbytes)
            out[f"{method}/{shape}"] = {
                "ms": cs._time_ms(_call(method), sets, CALLS),
                "bound_ms": bound, "bound_by": by}
            y = _call(method)(*sets[0])
            torch.cuda.synchronize()
            bits[f"{method}/{shape}"] = hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            if method == "dense":
                rnd[shape] = rounding(*sets[0][:4], sets[0][5])
            # dx reads g [M, N] and writes dx [M, K]: the forward's bytes
            kern, plain, mm = _dx_call(method)
            g_at, b_at = (4, 3) if method == "dense" else (5, 4)
            with_dh = [st + (lg._grouped_dh(st[g_at], st[b_at], st[g_at + 1],
                                            2.0, bm=C),) for st in sets]
            dx_out[f"{method}/{shape}"] = {
                "ms": cs._time_ms(kern, sets, CALLS),
                "kernel_ms": cs._time_ms(_dx_kernel_call(method), with_dh,
                                         CALLS),
                "dh_ms": cs._time_ms(_dh_call(method), sets, CALLS),
                "plain_ms": cs._time_ms(plain, sets, CALLS // 8),
                "matmul_ms": cs._time_ms(mm, sets, CALLS),
                "bound_ms": bound, "bound_by": by}
            dx_rnd[f"{method}/{shape}"] = dx_rounding(method, sets[0])
            del sets, with_dh
            dx_rnd[f"{method}/{shape}"]["f32_sha256"] = dx_f32_sha256(
                method, gen, K, N)
    return {"grouped_fwd_ms_per_launch": out, "bf16_rounding_vs_plain": rnd,
            "grouped_fwd_sha256": bits, "grouped_dx_ms_per_launch": dx_out,
            "grouped_dx_rounding_and_sha256": dx_rnd}


def _dense_calls(method):
    """(kernel, plain version, matmul context) of the dense bf16 forward
    over ``method``'s base, each a call on the inputs of
    ``chip_smoke._train_cases`` (bf16) or ``_quant_cases``."""
    if method == "bf16":
        return (lambda x, w, a, b, g: lf.lora_fused(x, w, a, b),
                lambda x, w, a, b, g: lf.lora_fused_ref(x, w, a, b),
                lambda x, w, a, b, g: torch.matmul(x, w))
    if method == "int8":
        fwd, ref = lq.lora_fused_q, lq.lora_fused_q_ref
    else:
        fwd, ref = (functools.partial(f, method=method) for f in (
            lp4.lora_fused_q4, lp4.lora_fused_q4_ref))
    return (lambda x, q, s, a, b, g, w: fwd(x, q, s, a, b),
            lambda x, q, s, a, b, g, w: ref(x, q, s, a, b),
            lambda x, q, s, a, b, g, w: torch.matmul(x, w))


def _dense_dx_calls(method):
    """(wrapper, plain version, matmul g @ W0^T) of the dense bf16 dx over
    ``method``'s base, each a call on a ``_dense_calls`` input set."""
    if method == "bf16":
        return (lambda x, w, a, b, g: lf.lora_dx(g, w, a, b),
                lambda x, w, a, b, g: lf.lora_dx_ref(g, w, a, b),
                lambda x, w, a, b, g: torch.matmul(g, w.T))
    if method == "int8":
        dx, ref = lq.lora_dx_q, lq.lora_dx_q_ref
    else:
        dx, ref = (functools.partial(f, method=method) for f in (
            lp4.lora_dx_q4, lp4.lora_dx_q4_ref))
    return (lambda x, q, s, a, b, g, w: dx(g, q, s, a, b),
            lambda x, q, s, a, b, g, w: ref(g, q, s, a, b),
            lambda x, q, s, a, b, g, w: torch.matmul(g, w.T))


#: does this tree's bf16 dense dx sum dh in its kernel (a C entry that
#: takes B and the scale)?
DX_SUMS_DH = hasattr(lf, "dx_plan")
#: does this tree's dense bf16 C entry take its split from the caller
#: (``lora_fused.split_of``: a measured plan, else the heuristic)?
TAKES_SPLIT = hasattr(lf, "split_of")


def _dense_dx_kernel(method):
    """The dense bf16 dx kernel alone, its C entry with no counter, on a
    ``_dense_calls`` input set; where the wrapper computes dh first, the
    set carries that dh last (``_with_dh``)."""
    from repro_torch.kernels import _build
    P, I, F = _build.C_PTR, _build.C_INT, _build.C_FLOAT
    lib = {"bf16": "lora_dx", "int8": "lora_quant"}.get(method, "lora_pack4")
    entry = {"bf16": "lora_dx", "int8": "lora_dx_q"}.get(method,
                                                         "lora_dx_q4")
    lead = () if method in ("bf16", "int8") else (lp4.METHOD_CODES[method],)
    n_ptr = 5 if method == "bf16" else 6
    op = {"bf16": "lora_dx", "int8": "lora_dx_q"}.get(method, "lora_dx_q4")
    if DX_SUMS_DH:
        entry += "_tc"
        fn = _build.function(lib, entry, [I] * len(lead) + [P] * n_ptr
                             + [I] * 4 + [F] + [I] * TAKES_SPLIT + [P])
    else:
        fn = _build.function(lib, entry, [I] * (1 + len(lead)) + [P] * n_ptr
                             + [I] * 4 + [P])

    def call(*args):
        if method == "bf16":
            _, w, a, b, g = args[:5]
            ptrs = (g, w, a)
        else:
            _, q, s, a, b, g, _ = args[:7]
            ptrs = (g, q, s, a)
        (M, N), (K, r) = g.shape, a.shape
        dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
        stream = torch.cuda.current_stream().cuda_stream
        if DX_SUMS_DH:
            split = (lf.split_of(op, g.dtype, M, K, N),) * TAKES_SPLIT
            rc = fn(*lead, *(t.data_ptr() for t in ptrs), b.data_ptr(),
                    dx.data_ptr(), M, K, N, r, 2.0, *split, stream)
        else:
            rc = fn(1, *lead, *(t.data_ptr() for t in ptrs),
                    args[-1].data_ptr(), dx.data_ptr(), M, K, N, r, stream)
        _build.check(lib, rc, entry)
        return dx
    return call


def _with_dh(sets, method):
    """Each input set with the wrapper's dh = round((s g) @ B^T) appended
    (for a tree whose bf16 dx kernel takes dh)."""
    if DX_SUMS_DH:
        return sets
    g_at, b_at = (4, 3) if method == "bf16" else (5, 4)
    return [st + (lf._dh(st[g_at], st[b_at], 2.0),) for st in sets]


def dense_dx_rounding(method, args):
    """The bf16 dense dx and its plain version against f64 on one input
    set: share of outputs that differ, and each one's mean |error|."""
    kern, plain, _ = _dense_dx_calls(method)
    y, ref = kern(*args), plain(*args)
    if method == "bf16":
        _, w, a, b, g = args
        p, wt = g, w
    else:
        _, q, s, a, b, g, _ = args
        p = g * s.to(g.dtype)
        wt = q if method == "int8" else lp4.unpack_weights(
            q, method, g.dtype, a.shape[0])
    dh = lf._dh(g, b, 2.0)
    exact = p.double() @ wt.double().T + dh.double() @ a.double().T
    torch.cuda.synchronize()
    return {"differ_share": float((y != ref).double().mean()),
            "kernel_mean_abs_err": float((y.double() - exact).abs().mean()),
            "plain_mean_abs_err": float((ref.double() - exact).abs().mean()),
            "sha256": hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()}


def dense():
    """The dense forward's and dx's per-launch times at the paths'
    shapes."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    out, dx_out, dx_rnd = {}, {}, {}
    for method in ("bf16", "int8", "int4", "nf4"):
        kern, plain, mm = _dense_calls(method)
        dx_wrap, dx_plain, dx_mm = _dense_dx_calls(method)
        dx_kern = _dense_dx_kernel(method)
        for shape, (M, K, N) in DENSE_SHAPES.items():
            if method == "bf16":
                make = cs._train_cases(torch, gen, torch.bfloat16, M, K, N)
                w_bytes = 2 * K * N
            else:
                make = cs._quant_cases(torch, quant, gen, torch.bfloat16,
                                       method, M, K, N)
                w_bytes = (K * N if method == "int8"
                           else (K + 1) // 2 * N) + 4 * N
            nbytes = w_bytes + 2 * (M * (K + N) + R * (K + N))
            flops = 2 * M * K * N + 2 * M * R * (K + N)
            bound, by = cs._bound_ms(nbytes, flops)
            sets = cs._cold_sets(make, nbytes)
            out[f"{method}/{shape}"] = {
                "ms": cs._time_ms(kern, sets, CALLS),
                "plain_ms": cs._time_ms(plain, sets, CALLS),
                "matmul_ms": cs._time_ms(mm, sets, CALLS),
                "bound_ms": bound, "bound_by": by}
            # dx reads g [M, N], W0, A, B and writes dx [M, K]: the same
            # bytes and products as the forward
            dx_out[f"{method}/{shape}"] = {
                "kernel_ms": cs._time_ms(dx_kern, _with_dh(sets, method),
                                         CALLS),
                "ms": cs._time_ms(dx_wrap, sets, CALLS),
                "plain_ms": cs._time_ms(dx_plain, sets, CALLS),
                "matmul_ms": cs._time_ms(dx_mm, sets, CALLS),
                "bound_ms": bound, "bound_by": by}
            if M == 256:
                dx_rnd[f"{method}/{shape}"] = dense_dx_rounding(method,
                                                                sets[0])
            del sets
    return {"dense_fwd_ms_per_launch": out, "dense_dx_ms_per_launch": dx_out,
            "dense_dx_rounding_vs_plain": dx_rnd,
            "dense_dx_sums_dh": DX_SUMS_DH}


def _dab_cases(gen, dtype, M, K, N, E=None):
    """make() of the factor gradients' inputs: x [M, K], g [M, N], A, B
    (per expert [E, ·] and gid, every expert one tile, when E is given)."""
    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        lead = () if E is None else (E,)
        out = tuple(t.to(dtype) for t in (
            rn(M, K), rn(M, N), rn(*lead, K, R) * R ** -0.5,
            rn(*lead, R, N) * 0.1))
        if E is None:
            return out
        return out + (torch.arange(E, dtype=torch.int32, device="cuda"),)
    return make


def _dab_calls(grouped):
    """(kernel, plain version, product context) of the factor gradients."""
    if grouped:
        def mm(x, g, a, b, gid):
            xe, ge = x.view(E, C, -1), g.view(E, C, -1)
            return (torch.bmm(xe.mT, ge[..., :R]),
                    torch.bmm(xe[..., :R].mT, ge))
        return (lambda x, g, a, b, gid: lg.lora_grouped_dab(
                    x, g, a, b, gid, 2.0, bm=C),
                lambda x, g, a, b, gid: lg.lora_grouped_dab_ref(
                    x, g, a, b, gid, 2.0, bm=C), mm)
    return (lambda x, g, a, b: lf.lora_dab(x, g, a, b, 2.0),
            lambda x, g, a, b: lf.lora_dab_ref(x, g, a, b, 2.0),
            lambda x, g, a, b: (torch.mm(x.T, g[:, :R]),
                                torch.mm(x[:, :R].T, g)))


def dab_rounding(grouped, args):
    """The bf16 dA/dB and its plain version against f64 products of the
    same bf16 operands on one input set: share of entries that differ,
    each one's mean |error|, and the SHA-256 of the kernel's dA and dB."""
    kern, plain, _ = _dab_calls(grouped)
    got, ref = kern(*args), plain(*args)
    x, g, a, b = args[:4]
    if grouped:    # every expert one tile of C rows
        x, g = x.view(E, C, -1), g.view(E, C, -1)
    sg = (2.0 * g.float()).to(g.dtype)
    h = (x.float() @ a.float()).to(x.dtype).double()
    dh = (sg.float() @ b.float().mT).to(x.dtype).double()
    exact = (x.double().mT @ dh, h.mT @ sg.double())
    torch.cuda.synchronize()
    n = sum(t.numel() for t in got)
    return {"differ_share": sum(float((u != v).double().sum())
                                for u, v in zip(got, ref)) / n,
            "kernel_mean_abs_err": sum(
                float((u.double() - e).abs().sum())
                for u, e in zip(got, exact)) / n,
            "plain_mean_abs_err": sum(
                float((v.double() - e).abs().sum())
                for v, e in zip(ref, exact)) / n,
            "sha256": hashlib.sha256(b"".join(
                t.view(torch.int16).cpu().numpy().tobytes()
                for t in got)).hexdigest()}


def dab():
    """The bf16 factor gradients' per-launch times, rounding, output hashes
    and plans at the dense and grouped paths' shapes."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    out, rnd, plans = {}, {}, {}
    shapes = {**{f"dense/{k}": (M, K, N, None)
                 for k, (M, K, N) in DENSE_SHAPES.items()},
              **{f"grouped/{k}": (E * C, K, N, E)
                 for k, (K, N) in SHAPES.items()}}
    for shape, (M, K, N, Eg) in shapes.items():
        grouped = Eg is not None
        kern, plain, mm = _dab_calls(grouped)
        experts = Eg or 1
        nbytes = 2 * (M * (K + N) + 2 * experts * R * (K + N)) + (
            4 * Eg if grouped else 0)
        flops = 4 * M * R * (K + N)
        bound, by = cs._bound_ms(nbytes, flops)
        sets = cs._cold_sets(_dab_cases(gen, torch.bfloat16, M, K, N, Eg),
                             nbytes)
        out[shape] = {"ms": cs._time_ms(kern, sets, CALLS),
                      "plain_ms": cs._time_ms(plain, sets, CALLS // 4),
                      "mm_ms": cs._time_ms(mm, sets, CALLS),
                      "bound_ms": bound, "bound_by": by}
        rnd[shape] = dab_rounding(grouped, sets[0])
        del sets
        f32 = _dab_cases(gen, torch.float32, M, K, N, Eg)()
        got = kern(*f32)
        torch.cuda.synchronize()
        rnd[shape]["f32_sha256"] = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in got)).hexdigest()
        del f32, got
        if grouped and hasattr(lg, "dab_plan"):
            plans[shape] = lg.dab_plan(M, K, N, Eg, R, bm=C)
        elif not grouped and hasattr(lf, "dab_plan"):
            plans[shape] = lf.dab_plan(M, K, N, R)
    return {"dab_ms_per_launch": out, "dab_rounding_and_sha256": rnd,
            "dab_plan": plans}


# the decode path: (K, N) -> launches a decode step, and its routing
DECODE_SHAPES = {"q_o": (896, 896), "k_v": (896, 128),
                 "gate_up": (896, 4864), "down": (4864, 896)}
DECODE_PER_STEP = {"q_o": 48, "k_v": 48, "gate_up": 48, "down": 24}


def _decode_cases(gen, dtype, method, K, N):
    """make() of the decode inputs: (x, codes..., a, b, gid, W0 in dtype),
    the dense ones as ``chip_smoke.check_grouped`` draws them, the
    quantized ones by ``chip_smoke._grouped_q_cases``."""
    if method != "dense":
        return cs._grouped_q_cases(torch, quant, gen, dtype, method, cs.M, K,
                                   N, cs.R, cs.RANK, cs.PATH_GID)
    gid = torch.tensor(cs.PATH_GID, dtype=torch.int32, device="cuda")

    def make():
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        w = (rn(K, N) * K ** -0.5).to(dtype)
        return (rn(cs.M, K).to(dtype), w,
                (rn(cs.R, K, cs.RANK) * cs.RANK ** -0.5).to(dtype),
                (rn(cs.R, cs.RANK, N) * 0.05).to(dtype), gid.clone(), w)
    return make


def _decode_calls(method):
    """(kernel, plain version, x @ W0) on a ``_decode_cases`` input set."""
    if method == "dense":
        return (lambda x, w, a, b, g, w2: lg.lora_grouped(x, w, a, b, g, 2.0,
                                                          bm=cs.BM),
                lambda x, w, a, b, g, w2: lg.lora_grouped_ref(
                    x, w, a, b, g, 2.0, bm=cs.BM),
                lambda x, w, a, b, g, w2: torch.matmul(x, w2))
    return cs._grouped_q_calls(torch, lg, method, cs.BM)


def decode_rounding(method, args):
    """The bf16 decode kernel and its plain version against f64 on one
    input set: share of outputs that differ, each one's mean |error|
    against (x @ w) [· S] + 2 · round(x @ A[g]) @ B[g] in f64 over the same
    operands (w the bf16 W0 or the codes as weights), and the SHA-256 of
    the kernel's output."""
    kern, plain, _ = _decode_calls(method)
    got, ref = kern(*args), plain(*args)
    x, a, b, gid = args[0], args[-4], args[-3], args[-2]
    if method == "dense":
        w, s = args[1].double(), None
    elif method == "int8":
        w, s = args[1].double(), args[2].double()
    else:
        w = lp4.unpack_weights(args[1], method, torch.bfloat16,
                               x.shape[1]).double()
        s = args[2].double()
    row = gid.long().repeat_interleave(cs.BM)
    h = torch.einsum("mk,mkr->mr", x.float(), a[row].float()).to(x.dtype)
    acc = x.double() @ w
    if s is not None:
        acc = acc * s
    exact = acc + 2.0 * torch.einsum("mr,mrn->mn", h.double(),
                                     b[row].double())
    torch.cuda.synchronize()
    return {"differ_share": float((got != ref).double().mean()),
            "kernel_mean_abs_err": float((got.double() - exact).abs().mean()),
            "plain_mean_abs_err": float((ref.double() - exact).abs().mean()),
            "sha256": hashlib.sha256(
                got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()}


def decode():
    """The decode forward's per-launch times, rounding and output hashes
    at the decode shapes in every format, and RMSNorm's beside
    ``F.rms_norm``."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    out, rnd, f32_bits, plans, per_step = {}, {}, {}, {}, {}
    used = len(set(cs.PATH_GID))
    for method in ("dense", "int8", "int4", "nf4"):
        kern, plain, mm = _decode_calls(method)
        step = {"ms": 0.0, "plain_ms": 0.0, "matmul_ms": 0.0, "bound_ms": 0.0}
        for i, (shape, (K, N)) in enumerate(DECODE_SHAPES.items()):
            gen = torch.Generator(device="cuda").manual_seed(30 + i)
            codes = {"dense": 2 * K * N, "int8": K * N}.get(
                method, (K + 1) // 2 * N)
            nbytes = codes + (0 if method == "dense" else 4 * N) \
                + 2 * cs.M * (K + N) + 2 * used * cs.RANK * (K + N) \
                + 4 * len(cs.PATH_GID)
            flops = 2 * cs.M * K * N + 2 * cs.M * cs.RANK * (K + N)
            bound, by = cs._bound_ms(nbytes, flops)
            sets = cs._cold_sets(_decode_cases(gen, torch.bfloat16, method,
                                               K, N), nbytes)
            key = f"{method}/{shape}"
            out[key] = {"ms": cs._time_ms(kern, sets, CALLS),
                        "plain_ms": cs._time_ms(plain, sets, CALLS // 4),
                        "matmul_ms": cs._time_ms(mm, sets, CALLS),
                        "bound_ms": bound, "bound_by": by}
            for k in step:
                step[k] += out[key][k] * DECODE_PER_STEP[shape]
            rnd[key] = decode_rounding(method, sets[0])
            del sets
            f32 = _decode_cases(torch.Generator(device="cuda").manual_seed(
                40 + i), torch.float32, method, K, N)()
            y = kern(*f32)
            torch.cuda.synchronize()
            f32_bits[key] = hashlib.sha256(
                y.cpu().numpy().tobytes()).hexdigest()
            del f32, y
            if hasattr(lg, "decode_plan"):
                plans[shape] = lg.decode_plan(cs.M, K, N, cs.RANK, bm=cs.BM)
        per_step[method] = step
    gen = torch.Generator(device="cuda").manual_seed(50)
    rms = {}
    for shape, (M, d) in cs.RMS_SHAPES.items():
        x = (torch.randn(M, d, generator=gen, device="cuda") * 3).bfloat16()
        w = torch.randn(d, generator=gen, device="cuda").bfloat16()
        sets = [(x, w)] * 256     # warm, as chip_smoke.py times it
        bound, by = cs._bound_ms(2 * (2 * M * d + d), 4 * M * d)
        rms[shape] = {
            "M": M, "d": d,
            "ms": cs._time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets),
            "library_ms": cs._time_ms(
                lambda x, w: F.rms_norm(x, (d,), w, 1e-6), sets),
            "plain_ms": cs._time_ms(lambda x, w: rn.rmsnorm_ref(x, w, 1e-6),
                                    sets),
            "bound_ms": bound, "bound_by": by}
    return {"decode_ms_per_launch": out, "decode_ms_per_step": per_step,
            "decode_rounding_and_sha256": rnd,
            "decode_f32_sha256": f32_bits, "decode_plan": plans,
            "rmsnorm_fwd_ms_per_launch": rms}


# plans of the bf16 decode body swept at each shape: (split, bn); and
# shapes that isolate its fixed cost (one slab, one column tile)
SWEEP_PLANS = [(split, bn) for bn in (64, 128) for split in range(1, 9)]


def decode_sweep():
    """The bf16 decode body over a bf16 base under other plans than
    ``decode_plan``'s, through its C entry: ms per launch, cold and warm
    (one input set again and again, W0 in L2), at the decode shapes and at
    two that isolate the fixed cost of a launch and of a cluster."""
    from repro_torch.kernels import _build
    fn = _build.function("lora_grouped_fwd", "lora_grouped_fwd",
                         lg._ARGTYPES)
    shapes = {**DECODE_SHAPES, "one_slab": (lg.DECODE_KD, 32),
              "eight_slabs": (8 * lg.DECODE_KD, 32)}
    out = {}
    for i, (shape, (K, N)) in enumerate(shapes.items()):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)
        nbytes = 2 * K * N + 2 * cs.M * (K + N)
        make = _decode_cases(gen, torch.bfloat16, "dense", K, N)
        sets = cs._cold_sets(make, nbytes)
        base = lg.decode_plan(cs.M, K, N, cs.RANK, bm=cs.BM)
        for split, bn in SWEEP_PLANS:
            if split > base["slabs"]:
                continue
            y = torch.empty(cs.M, N, dtype=torch.bfloat16, device="cuda")

            def call(x, w, a, b, g, w2, split=split, bn=bn, y=y):
                rc = fn(1, x.data_ptr(), w.data_ptr(), a.data_ptr(),
                        b.data_ptr(), g.data_ptr(), y.data_ptr(), cs.M, K, N,
                        cs.R, cs.RANK, cs.BM, 2.0, split, bn, base["part"],
                        base["h_cols"],
                        torch.cuda.current_stream().cuda_stream)
                _build.check("lora_grouped_fwd", rc, "sweep launch")
            out[f"{shape}/split{split}/bn{bn}"] = {
                "cold_ms": cs._time_ms(call, sets, CALLS),
                "warm_ms": cs._time_ms(call, [sets[0]] * 64, CALLS)}
        del sets
    return {"decode_sweep_ms_per_launch": out}


# the RMSNorm backward's shapes: the seq-48 and the paper path's, OLMoE's
RMS_BWD_SHAPES = {"train48": (192, 896), "train": (256, 896),
                  "olmoe": (256, 2048)}


def _rms_bwd_args(M, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn_ = lambda *s: torch.randn(s, generator=gen, device="cuda")
    return ((rn_(M, d) * 3).bfloat16(), rn_(d).bfloat16(),
            rn_(M, d).bfloat16())


def norm_rope():
    """The RMSNorm backward's and the standalone RoPE's per-launch times
    beside their plain versions, the library call (RMSNorm) and the bound,
    and the RMSNorm forward's output hashes."""
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope
    bwd = {}
    for i, (shape, (M, d)) in enumerate(RMS_BWD_SHAPES.items()):
        args = _rms_bwd_args(M, d, 80 + i)
        sets = [args] * 256      # warm: g was just written by the step
        op, lib_sets, lib = cs.rms_bwd_library(torch, *args)
        bound, by = cs._bound_ms(2 * (3 * M * d + d), 10 * M * d)
        kern = lambda x, w, g: rn.rmsnorm_bwd(x, w, g, 1e-6, need_dw=False)
        cold = cs._cold_sets(lambda: _rms_bwd_args(M, d, 85 + i),
                             2 * (3 * M * d + d))
        bwd[shape] = {
            "M": M, "d": d, "ms": cs._time_ms(kern, sets),
            "cold_ms": cs._time_ms(kern, cold),
            "library_ms": cs._time_ms(lib, lib_sets), "library_op": op,
            "plain_ms": cs._time_ms(
                lambda x, w, g: rn.rmsnorm_bwd_ref(x, w, g, 1e-6)[0], sets),
            "bound_ms": bound, "bound_by": by}
        del cold
    rot = {}
    for i, (case, (B, N, H, D)) in enumerate(cs.ROPE_CASES.items()):
        gen = torch.Generator(device="cuda").manual_seed(90 + i)
        cos, sin = rope.rope_tables(torch.arange(N, device="cuda"), 1e6, D)
        make = lambda: (torch.randn(B, N, H, D, generator=gen,
                                    device="cuda").bfloat16(), cos, sin)
        nbytes = 2 * 2 * B * N * H * D + 2 * 4 * N * (D // 2)
        bound, by = cs._bound_ms(nbytes, 6 * B * N * H * (D // 2))
        sets = cs._cold_sets(make, nbytes)
        rot[case] = {"B": B, "N": N, "H": H, "D": D,
                     "ms": cs._time_ms(rope.rope_fwd, sets),
                     "plain_ms": cs._time_ms(rope.rope_fwd_ref, sets),
                     "copy_ms": cs._time_ms(lambda x, c, s: x.clone(), sets),
                     "bound_ms": bound, "bound_by": by}
        del sets
    return {"rmsnorm_bwd_ms_per_launch": bwd, "rope_fwd_ms_per_launch": rot,
            "rmsnorm_fwd_sha256": cs.rmsnorm_fwd_sha256(torch, rn)}


# rows of the RMSNorm backward's sweep: from a few (one warp's chain) to
# more than the card's 132 SMs take at once in blocks of one to four rows
SWEEP_ROWS = (8, 64, 192, 256, 1024)


def rmsnorm_bwd_sweep():
    """The RMSNorm backward of the ``repro_torch`` on the path built as it
    is and, where its source takes ``RMS_BWD_WARPS``, with 1, 2 and 4 rows
    a block; each timed through its C entry, warm, at ``SWEEP_ROWS`` rows
    of 896 and 2048; and whether the builds give the same dx bits."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    src = _build.CSRC / "rmsnorm_bwd.cu"
    builds = {"as_built": []}
    if "RMS_BWD_WARPS" in src.read_text():
        builds.update({f"warps{w}": [f"-DRMS_BWD_WARPS={w}"]
                       for w in (1, 2, 4)})
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, flags in builds.items():
        lib = _build.BUILD_DIR / f"rmsnorm_bwd_sweep_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
             str(_build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc rmsnorm_bwd.cu {builds[name]}: {log}")
        fns[name] = ctypes.CDLL(str(lib)).rmsnorm_bwd
        fns[name].argtypes = rn._BWD_ARGTYPES
        fns[name].restype = _build.C_INT
    out, same = {}, {}
    for i, (M, d) in enumerate((M, d) for d in (896, 2048)
                               for M in SWEEP_ROWS):
        args = _rms_bwd_args(M, d, 100 + i)
        bits = []
        for name, fn in fns.items():
            dx = torch.empty_like(args[0])

            def call(x, w, g, fn=fn, dx=dx, M=M, d=d):
                rc = fn(1, x.data_ptr(), w.data_ptr(), g.data_ptr(),
                        dx.data_ptr(), None, M, d, 1e-6,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"rmsnorm_bwd sweep launch: {rc}")
            out[f"{M}x{d}/{name}"] = cs._time_ms(call, [args] * 256)
            bits.append(dx.clone())
        same[f"{M}x{d}"] = all(torch.equal(bits[0], b) for b in bits[1:])
    return {"rmsnorm_bwd_sweep_ms_per_launch": out,
            "rmsnorm_bwd_sweep_same_bits": same}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family",
                    choices=("grouped", "dense", "both", "dab", "decode",
                             "decode_sweep", "norm_rope",
                             "rmsnorm_bwd_sweep"),
                    default="both")
    ap.add_argument("--label", default="", help="a name for this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_grouped: no CUDA card is visible")
    res = {}
    if args.family in ("grouped", "both"):
        res.update(grouped())
    if args.family in ("dense", "both"):
        res.update(dense())
    if args.family == "dab":
        res.update(dab())
    if args.family == "decode":
        res.update(decode())
    if args.family == "decode_sweep":
        res.update(decode_sweep())
    if args.family == "norm_rope":
        res.update(norm_rope())
    if args.family == "rmsnorm_bwd_sweep":
        res.update(rmsnorm_bwd_sweep())
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({**res, "label": args.label,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
