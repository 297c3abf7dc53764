"""Wall time of the port's training steps on the card, without a profiler.

Builds a full-width model (``--arch``, by default qwen2.5-0.5b; bf16,
random weights from seed 0), takes batches of ``--batch`` x ``--seq``
tokens from the port's data pipeline (by default the paper's 1 x 256),
runs ``--warm`` SGD steps of ``--engine`` (by default mesp_cuda), then
times ``--steps`` more, each ending in a synchronise, by the host clock,
and prints one JSON line: each step's ms, their median and the card's
name. The steps at 1 x 256 are host-bound (the device idles most of the
step), so the median reads the host's dispatch cost.

It uses only the interface every version of the port has had since its
training CLI, so one copy of it times two checkouts alike: run it with
``PYTHONPATH`` set to each checkout's ``src`` in turn, alternating, in one
call on one card.

    PYTHONPATH=src python scripts/time_torch_steps.py [--arch ...] \
        [--batch 1 --seq 256] [--steps 20]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.api.engines import ENGINES
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import mesp
from repro_torch.data import make_batch_iterator
from repro_torch.models import model as model_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--engine", default="mesp_cuda", choices=sorted(ENGINES))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    device = torch.device("cuda")
    cfg = get_config(ns.arch)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0))
    policy = ExecutionPolicy(backend=ENGINES[ns.engine], device=device)
    data = make_batch_iterator(cfg.vocab, ns.seq, ns.batch, seed=0)

    def step(params):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in next(data).items()}
        return mesp.train_step(params, cfg, batch, 1e-4, policy=policy)[0]

    for _ in range(ns.warm):
        params = step(params)
    torch.cuda.synchronize()
    ms = []
    for _ in range(ns.steps):
        t0 = time.perf_counter()
        params = step(params)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"steps": {
        "arch": ns.arch, "engine": ns.engine, "batch": ns.batch,
        "seq": ns.seq, "ms": ms, "median_ms": statistics.median(ms),
        "device": torch.cuda.get_device_name(0)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
