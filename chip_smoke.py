#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds and serves on the GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card, in
   bf16, at the qwen2.5-0.5b decode shapes, and times the kernel, the plain
   version and (for RMSNorm) ``F.rms_norm`` as a library yardstick, beside
   the bound from bytes and operations.
3. Serves full-width qwen2.5-0.5b (24 layers, random weights from a seed)
   through ``repro_torch.launch.serve``: 8 slots in tiles of 2, 4 tenants,
   a store of 4, 8 requests of 8 prompt + 16 new tokens. The launch
   counters are zeroed just before and read just after; every decode step
   must launch the grouped kernel 7 x 24 = 168 times and the RMSNorm
   kernel 2 x 24 + 1 = 49 times.
4. Replays the first 4 steps (all prefill, so the inputs are fixed)
   through the kernels, through the plain functions, and through the plain
   functions in f32, and compares the logits.

Prints one ``{"kernels": [...]}`` line, one ``{"serve": ...}`` line, the
card's name and power limit, and last ``{"ok": true, "device": ...}``.
Any mismatch or exception exits non-zero. Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
L2_BYTES = 50 * 2**20

M, BM, R, RANK = 8, 2, 4, 8           # decode: 8 slots, tile 2, 4 adapters
D_MODEL, D_FF, KV = 896, 4864, 128
N_LAYERS = 24
# (K, N) -> grouped launches per decode step: q,o / k,v / gate,up / down
GROUPED_SHAPES = {(D_MODEL, D_MODEL): 2 * N_LAYERS, (D_MODEL, KV): 2 * N_LAYERS,
                  (D_MODEL, D_FF): 2 * N_LAYERS, (D_FF, D_MODEL): N_LAYERS}
RMS_PER_STEP = 2 * N_LAYERS + 1
GROUPED_PER_STEP = sum(GROUPED_SHAPES.values())
# bf16 against the plain version on the same inputs: both sum in f32 and
# round once to bf16, so they may differ by one bf16 step of the output
# (2^-8 relative, doubled for a flip of h's rounding) plus a small absolute
# floor for outputs near zero
KERNEL_TOL = dict(rtol=2.0 ** -6, atol=1e-2)
# logits after 24 bf16 layers, relative to the logits' largest magnitude:
# the plain functions and the kernels round at different points (bf16
# products, h and the delta rounded apart, vs f32 sums rounded once) and the
# differences grow through the layers (about 0.035 measured on an H100
# 80GB HBM3 at 700 W).
# Both are also held against the plain functions in f32: the kernels may be
# no further from those than twice the plain bf16 functions are.
LOGIT_TOL = 0.1


def _check_close(got, want, tol, what):
    import torch
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if not bool(torch.isfinite(got).all()) or bool((err > lim).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} over "
                             f"tolerance {tol}")
    return float(err.max())


def _cold_sets(make, nbytes):
    """Enough copies of one input set that cycling through them streams
    more than 3x the L2 cache, so every launch finds its inputs cold."""
    n = max(2, math.ceil(3 * L2_BYTES / nbytes))
    first = make()
    return [first] + [tuple(t.clone() for t in first) for _ in range(n - 1)]


def _time_ms(fn, sets):
    """Device time of one call: a CUDA graph of one call per input set,
    replayed, timed with CUDA events (host launch cost excluded)."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for args in sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for args in sets:
            fn(*args)
    g.replay()
    torch.cuda.synchronize()
    reps = max(1, 2000 // len(sets))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_grouped(torch, lg):
    gen = torch.Generator(device="cuda").manual_seed(1)
    gid = torch.tensor([3, 0, 3, 1], dtype=torch.int32, device="cuda")
    used = int(torch.unique(gid).numel())
    shapes = []
    for (K, N), per_step in GROUPED_SHAPES.items():
        def make():
            rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
            return (rn(M, K).bfloat16(), (rn(K, N) * K ** -0.5).bfloat16(),
                    (rn(R, K, RANK) * RANK ** -0.5).bfloat16(),
                    (rn(R, RANK, N) * 0.05).bfloat16(), gid.clone())
        args = make()
        got = lg.lora_grouped(*args, 2.0, bm=BM)
        torch.cuda.synchronize()
        want = lg.lora_grouped_ref(*args, 2.0, bm=BM)
        err = _check_close(got, want, KERNEL_TOL,
                           f"lora_grouped_fwd K={K} N={N}")
        nbytes = 2 * (M * K + K * N + used * (K * RANK + RANK * N) + M * N) \
            + 4 * gid.numel()
        flops = 2 * M * K * N + 2 * M * K * RANK + 2 * M * RANK * N
        bound, by = _bound_ms(nbytes, flops)
        sets = _cold_sets(make, nbytes)
        shapes.append({
            "K": K, "N": N, "M": M, "bm": BM, "R": R, "r": RANK,
            "launches_per_decode_step": per_step, "max_abs_err": err,
            "ms": _time_ms(lambda *a: lg.lora_grouped(*a, 2.0, bm=BM), sets),
            "plain_ms": _time_ms(
                lambda *a: lg.lora_grouped_ref(*a, 2.0, bm=BM), sets),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "flops": flops})
    return shapes


def check_rmsnorm(torch, rn):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)

    def make():
        return ((torch.randn(M, D_MODEL, generator=gen, device="cuda") * 3
                 ).bfloat16(),
                torch.randn(D_MODEL, generator=gen, device="cuda").bfloat16())
    args = make()
    got = rn.rmsnorm(*args, 1e-6)
    torch.cuda.synchronize()
    err = _check_close(got, rn.rmsnorm_ref(*args, 1e-6), KERNEL_TOL,
                       "rmsnorm_fwd")
    nbytes = 2 * (2 * M * D_MODEL + D_MODEL)
    bound, by = _bound_ms(nbytes, 4 * M * D_MODEL)
    # warm: at decode the norm's input was written by the step just before
    sets = [args] * 256
    return [{"M": M, "d": D_MODEL, "launches_per_decode_step": RMS_PER_STEP,
             "max_abs_err": err,
             "ms": _time_ms(lambda x, w: rn.rmsnorm(x, w, 1e-6), sets),
             "plain_ms": _time_ms(lambda x, w: rn.rmsnorm_ref(x, w, 1e-6),
                                  sets),
             "library_ms": _time_ms(
                 lambda x, w: F.rms_norm(x, (D_MODEL,), w, 1e-6), sets),
             "bound_ms": bound, "bound_by": by, "bytes": nbytes,
             "flops": 4 * M * D_MODEL}]


def kernel_entry(name, source, replaces, tpu_kernel, shapes, launches,
                 steps):
    """One kernel's line entry: figures per decode step (each shape's
    per-launch figure times its launches per step), shapes in full."""
    def per_step(key):
        vals = [s[key] for s in shapes]
        if any(v is None for v in vals):
            return None
        return sum(v * s["launches_per_decode_step"]
                   for v, s in zip(vals, shapes))
    t_bytes = sum(s["bytes"] * s["launches_per_decode_step"]
                  for s in shapes) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(s["flops"] * s["launches_per_decode_step"]
                for s in shapes) / BF16_FLOPS_PER_S * 1e3
    err = max(s["max_abs_err"] for s in shapes)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": launches,
            "launches_per_decode_step": launches / steps,
            "max_abs_err": err, "max_err": err, "tol": KERNEL_TOL,
            "unit": "ms per decode step: per-launch time x launches per "
                    "step, summed over shapes",
            "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
            "library_ms": per_step("library_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shapes": shapes}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def compare_logits(torch, cfg, params, steps=4):
    """The first ``steps`` steps (all prefill: fixed inputs) through the
    kernels, through the plain functions, and through the plain functions
    in f32 on the same (bf16-valued) params and adapters. Returns the
    worst relative differences {kernels vs plain, kernels vs f32, plain vs
    f32}, each over the f32 logits' largest magnitude."""
    import dataclasses
    from repro_torch.api.policy import ExecutionPolicy
    from repro_torch.launch.serve import request_trace
    from repro_torch.serve import (AdapterStore, ContinuousBatcher,
                                   synthetic_adapters)
    uids = [f"tenant{i}" for i in range(4)]
    adapters = {u: synthetic_adapters(params, i) for i, u in enumerate(uids)}
    runs = {"cuda": (cfg, params, adapters),
            "structured": (cfg, params, adapters),
            "f32": (dataclasses.replace(cfg, dtype="float32"), _f32(params),
                    {u: _f32(t) for u, t in adapters.items()})}
    logits = {}
    for name, (c, p, ads) in runs.items():
        backend = "cuda" if name == "cuda" else "structured"
        bat = ContinuousBatcher(
            c, AdapterStore(p, capacity=4), slots=M, tile=BM, max_len=32,
            page_size=16,
            policy=ExecutionPolicy(backend=backend, device="cuda"))
        for u in uids:
            bat.register_adapter(u, ads[u])
        for req in request_trace(8, uids, 8, 16):
            bat.submit(req)
        logits[name] = []
        for _ in range(steps):
            bat.step()
            got = bat.last_logits.float().clone()
            if got.shape != (M, 1, cfg.vocab) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name}: bad logits {tuple(got.shape)}")
            logits[name].append(got)
        del bat
    worst = {"kernels_vs_plain": 0.0, "kernels_vs_f32": 0.0,
             "plain_vs_f32": 0.0}
    for s in range(steps):
        ref = logits["f32"][s]
        scale = float(ref.abs().max())
        rel = lambda u, v: float((u - v).abs().max()) / scale
        step = {"kernels_vs_plain": rel(logits["cuda"][s],
                                        logits["structured"][s]),
                "kernels_vs_f32": rel(logits["cuda"][s], ref),
                "plain_vs_f32": rel(logits["structured"][s], ref)}
        if step["kernels_vs_plain"] > LOGIT_TOL:
            raise AssertionError(f"step {s}: kernels and plain functions "
                                 f"differ: {step} (tolerance {LOGIT_TOL})")
        if step["kernels_vs_f32"] > 2 * step["plain_vs_f32"] + 1e-3:
            raise AssertionError(f"step {s}: the kernels are further from "
                                 f"the f32 logits than the plain bf16 "
                                 f"functions: {step}")
        worst = {k: max(worst[k], v) for k, v in step.items()}
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import lora_grouped as lg
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import serve as serve_cli

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _build.build_all()
    build = {}
    for stem, info in _build.BUILD_INFO.items():
        log = Path(info["log"]).read_text() if info["log"] else ""
        build[stem] = {"seconds": info["seconds"],
                       "ptxas": [ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln]}
    print(json.dumps({"build": build}))

    grouped = check_grouped(torch, lg)
    rms = check_rmsnorm(torch, rn)

    # the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_cli.serve([
        "--arch", "qwen2.5-0.5b", "--engine", "mesp_cuda", "--device",
        "cuda", "--batch", str(M), "--tile", str(BM), "--adapters", "4",
        "--store-capacity", "4", "--requests", "8", "--prompt-len", "8",
        "--max-new", "16", "--max-len", "32", "--seed", "0"])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = out["steps"] + out["warmup_steps"]
    want = {"lora_grouped_fwd": GROUPED_PER_STEP * steps,
            "rmsnorm_fwd": RMS_PER_STEP * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want} for "
                             f"{steps} decode steps")
    if out["tokens"] != 8 * 16 or out["requests"] != 8:
        raise AssertionError(f"served {out['requests']} requests / "
                             f"{out['tokens']} tokens, expected 8 / 128")

    logit_err = compare_logits(torch, out["cfg"], out["params"])

    kernels = [
        kernel_entry("lora_grouped_fwd",
                     "src/repro_torch/csrc/lora_grouped_fwd.cu",
                     "src/repro/kernels/lora_grouped.py:183",
                     "src/repro/kernels/lora_grouped.py:lora_grouped "
                     "(_grouped_fwd_kernel :69)", grouped,
                     counts["lora_grouped_fwd"], steps),
        kernel_entry("rmsnorm_fwd", "src/repro_torch/csrc/rmsnorm_fwd.cu",
                     "src/repro/kernels/rmsnorm.py:26",
                     "src/repro/kernels/rmsnorm.py:rmsnorm "
                     "(_rmsnorm_kernel :19)", rms, counts["rmsnorm_fwd"],
                     steps),
    ]
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": {
        "arch": "qwen2.5-0.5b", "dtype": "bfloat16", "slots": M, "tile": BM,
        "tenants": 4, "requests": out["requests"], "tokens": out["tokens"],
        "steps": out["steps"], "warmup_steps": out["warmup_steps"],
        "seconds": out["seconds"], "tok_s": out["tokens"] / out["seconds"],
        "ms_per_step": 1e3 * out["seconds"] / out["steps"],
        "max_memory_allocated": peak, "launches": counts,
        "logits_max_rel_err": logit_err, "logits_tol": LOGIT_TOL,
        "device": name}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
