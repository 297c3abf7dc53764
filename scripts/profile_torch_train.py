"""Where a training step of the port spends its time, on the card.

Builds a full-width model (``--arch``, by default qwen2.5-0.5b; also
olmoe-1b-7b or deepseek-moe-16b; bf16, random weights from seed 0), takes
batches of ``--batch`` x ``--seq`` tokens from the port's data pipeline (by
default 4 x 48, as ``chip_smoke.py`` first trains it; ``--batch 1 --seq
256`` is the paper's setting, where attention runs the flash kernels;
``--quantize int8|int4|nf4`` keeps the frozen base in that format), runs
two warm SGD steps, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON line: wall ms per step, device busy
ms per step (the union of kernel intervals on the card's timeline), the
device idle share, device kernels launched per step, the kernels that
took the most device time, and the flash-attention, grouped (MoE) and
dense LoRA forward and dx kernels' time.

    PYTHONPATH=src python scripts/profile_torch_train.py [--engine mesp_cuda] \
        [--arch olmoe-1b-7b] [--batch 1 --seq 256] [--quantize nf4]
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--engine", default="mesp_cuda", choices=sorted(ENGINES))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--quantize", default="none", choices=quant.METHODS)
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
        "device": torch.cuda.get_device_name(0)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
