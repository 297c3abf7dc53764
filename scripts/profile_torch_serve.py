"""Where a decode step of the port's serving path spends its time, on the card.

Builds full-width qwen2.5-0.5b (bf16, random weights from seed 0; with
``--quantize int8|int4|nf4`` the shared frozen base in that format) with 8
slots in tiles of 2 and 4 tenants, as ``chip_smoke.py`` serves it, runs a
few warm steps, then traces ``--steps`` decode steps with ``torch.profiler``
and prints one JSON line: wall ms per step, device busy ms per step (the
union of kernel intervals on the card's timeline), the device idle share,
and the kernels that took the most device time.

    PYTHONPATH=src python scripts/profile_torch_serve.py [--engine mesp_cuda] \
        [--quantize nf4]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.launch.serve import ENGINES, request_trace
from repro_torch.models import model as model_lib
from repro_torch.serve import (AdapterStore, ContinuousBatcher,
                               synthetic_adapters)


def _busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="mesp_cuda", choices=sorted(ENGINES))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--quantize", default="none", choices=quant.METHODS)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    device = torch.device("cuda")
    cfg = get_config("qwen2.5-0.5b")
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        quantize=ns.quantize)
    bat = ContinuousBatcher(
        cfg, AdapterStore(params, capacity=4), slots=8, tile=2, max_len=32,
        page_size=16,
        policy=ExecutionPolicy(backend=ENGINES[ns.engine], device=device,
                               quantize=ns.quantize))
    uids = [f"tenant{i}" for i in range(4)]
    for i, u in enumerate(uids):
        bat.register_adapter(u, synthetic_adapters(params, i))
    for r in request_trace(8, uids, 8, 16):
        bat.submit(r)
    for _ in range(3):
        bat.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(ns.steps):
            bat.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / ns.steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us(kernels) / 1e3 / ns.steps
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"profile": {
        "engine": ns.engine, "quantize": ns.quantize, "steps": ns.steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / ns.steps,
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / ns.steps
                                    for k, v in top},
        "device": torch.cuda.get_device_name(0)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
