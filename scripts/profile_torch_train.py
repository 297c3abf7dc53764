"""Where a training step of the port spends its time, on the card.

Builds a full-width model (``--arch``, by default qwen2.5-0.5b; any arch
of the registry, e.g. olmoe-1b-7b, rwkv6-1.6b or recurrentgemma-2b; bf16,
random weights from seed 0), takes
batches of ``--batch`` x ``--seq`` tokens from the port's data pipeline (by
default 4 x 48, as ``chip_smoke.py`` first trains it; ``--batch 1 --seq
256`` is the paper's setting, where attention runs the flash kernels;
``--quantize int8|int4|nf4`` keeps the frozen base in that format), runs
two warm SGD steps, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON line: wall ms per step, device busy
ms per step (the union of kernel intervals on the card's timeline), the
device idle share, device kernels launched per step, the kernels that
took the most device time, and the flash-attention, grouped (MoE) and
dense LoRA forward and dx kernels', the LoRA factor gradients' (dense
and grouped dA/dB) and the RMSNorm kernels' time, with the RMSNorm
backward's share of the busy time. With ``--peak`` it then prints the peak
``torch.cuda.max_memory_allocated`` of one ``value_and_grad`` with remat
off, and above what was allocated before it (``chip_smoke.py``'s
``peak_memory`` reading, on the trained weights).

    PYTHONPATH=src python scripts/profile_torch_train.py [--engine mesp_cuda] \
        [--arch olmoe-1b-7b] [--batch 1 --seq 256] [--quantize nf4] [--peak]
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import torch
from profile_torch_serve import _busy_us
from torch.profiler import ProfilerActivity, profile

from repro_torch.api.engines import ENGINES
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import mesp, quant
from repro_torch.data import make_batch_iterator
from repro_torch.models import model as model_lib


def _durations(kernels, key):
    """{kernel name: [µs of each launch]} for the kernels whose name holds
    ``key``."""
    out = {}
    for e in kernels:
        if key in e.name:
            out.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--engine", default="mesp_cuda", choices=sorted(ENGINES))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--quantize", default="none", choices=quant.METHODS)
    ap.add_argument("--peak", action="store_true",
                    help="also the remat-off peak of one value_and_grad")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    device = torch.device("cuda")
    cfg = get_config(ns.arch)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        quantize=ns.quantize)
    policy = ExecutionPolicy(backend=ENGINES[ns.engine], device=device,
                             quantize=ns.quantize)
    data = make_batch_iterator(cfg.vocab, ns.seq, ns.batch, seed=0)

    def step(params):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in next(data).items()}
        return mesp.train_step(params, cfg, batch, 1e-4, policy=policy)[0]

    for _ in range(2):
        params = step(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(ns.steps):
            params = step(params)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / ns.steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us(kernels) / 1e3 / ns.steps
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"profile": {
        "arch": ns.arch, "engine": ns.engine, "batch": ns.batch,
        "seq": ns.seq, "quantize": ns.quantize,
        "steps": ns.steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / ns.steps,
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / ns.steps
                                    for k, v in top},
        "flash_ms_per_step": {k[:80]: v / 1e3 / ns.steps
                              for k, v in by_name.items() if "flash" in k},
        "grouped_ms_per_step": {k[:100]: v / 1e3 / ns.steps
                                for k, v in by_name.items()
                                if "grouped" in k},
        # the dense LoRA kernels: f32 forward and dx on CUDA cores
        # (lora_gemm_kernel / lora_gemm_q_kernel<T, DX, ...>), the bf16
        # forward and dx on tensor cores (dense_fwd_tc, dense_dx_tc)
        "dense_lora_ms_per_step": {
            k[:100]: v / 1e3 / ns.steps for k, v in by_name.items()
            if "lora_gemm" in k or "dense_fwd_tc" in k
            or "dense_dx_tc" in k},
        # dA/dB, dense and grouped: the f32 row blocks and reduce passes
        # (lora_dab_*, grouped_dab_*), the bf16 tensor-core body (dab_tc)
        "dab_ms_per_step": {k[:100]: v / 1e3 / ns.steps
                            for k, v in by_name.items() if "dab" in k},
        "rmsnorm_ms_per_step": {k[:100]: v / 1e3 / ns.steps
                                for k, v in by_name.items()
                                if "rmsnorm" in k},
        "rmsnorm_bwd_share_of_busy": sum(
            v for k, v in by_name.items() if "rmsnorm_bwd" in k)
        / 1e3 / ns.steps / busy_ms,
        # each RMSNorm launch's µs in the step: min, median, max
        "rmsnorm_us_per_launch": {
            k[:100]: [min(d), sorted(d)[len(d) // 2], max(d)]
            for k, d in _durations(kernels, "rmsnorm").items()},
        "device": torch.cuda.get_device_name(0)}}))
    if ns.peak:
        del prof, kernels
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in next(data).items()}
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        off = ExecutionPolicy(backend=ENGINES[ns.engine], device=device,
                              remat=False, quantize=ns.quantize)
        loss, grads = mesp.value_and_grad(params, cfg, batch, policy=off)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del loss, grads
        print(json.dumps({"peak_remat_off": {
            "arch": ns.arch, "engine": ns.engine, "quantize": ns.quantize,
            "peak_bytes": peak, "above_start_bytes": peak - start,
            "start_bytes": start}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
