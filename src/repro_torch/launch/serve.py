"""Serving launcher of the port: multi-tenant continuous batching of a dense
model over a store of LoRA adapters (``repro.launch.serve``'s continuous
mode).

Requests round-robin over ``--adapters`` synthetic tenant adapters; an
:class:`~repro_torch.serve.AdapterStore` holds ``--store-capacity`` of
them resident, and the :class:`~repro_torch.serve.ContinuousBatcher`
admits and recycles at step granularity with paged-KV accounting. Under
``--engine mesp_cuda`` (the default) every LoRA linear runs the grouped
LoRA kernel and every norm the RMSNorm kernel; ``--engine mesp`` runs the
plain PyTorch forwards. ``--quantize int8|int4|nf4`` keeps the shared
frozen base in that format: under ``mesp_cuda`` the grouped kernels over
int8 or packed codes run in place of the float one, and ``mesp``
dequantizes. ``--mem-budget-mb`` admits a request only while the modelled
resident set (``serve/residency.py``, the base in its format) stays within
it. The run happens on the card unless ``--device cpu`` is given; with no
card visible the default fails rather than falling back.

A warmup request is served, synchronised and discarded before the timed
trace, so the kernel build and first launches are not in tokens/s.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-0.5b \\
        --adapters 4 --batch 8 --tile 2 --requests 8 --prompt-len 8 \\
        --max-new 16 [--quantize nf4]
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.api.engines import ENGINES as _ALL_ENGINES
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import quant
from repro_torch.models import model as model_lib
from repro_torch.serve import (AdapterStore, ContinuousBatcher, Request,
                               synthetic_adapters)

log = logging.getLogger("repro_torch.serve")

#: engine -> ExecutionPolicy backend, for the engines that serve
ENGINES = {k: _ALL_ENGINES[k] for k in ("mesp", "mesp_cuda")}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family config")
    ap.add_argument("--engine", default="mesp_cuda", choices=sorted(ENGINES),
                    help="mesp_cuda: the hand-written CUDA kernels; "
                         "mesp: plain PyTorch forwards")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots")
    ap.add_argument("--steps", type=int, default=32,
                    help="default of --max-new")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-len", type=int, default=128,
                    help="decode cache capacity per slot")
    ap.add_argument("--adapters", type=int, default=1,
                    help="synthetic tenant adapters to serve")
    ap.add_argument("--store-capacity", type=int, default=None,
                    help="resident adapter slots (default: min(adapters, 4))")
    ap.add_argument("--tile", type=int, default=None,
                    help="decode rows per adapter tile "
                         "(default: batch // 2, min 1)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV tokens per allocator page")
    ap.add_argument("--requests", type=int, default=None,
                    help="request-trace length (default: 2 x adapters)")
    ap.add_argument("--prompt-len", type=int, default=4,
                    help="synthetic prompt tokens per request")
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens generated per request (default: --steps)")
    ap.add_argument("--quantize", default="none", choices=quant.METHODS,
                    help="format of the shared frozen base")
    ap.add_argument("--mem-budget-mb", type=float, default=None,
                    help="admission headroom: modelled resident MB the "
                         "batcher may not exceed (default: no check)")
    return ap


def request_trace(n: int, adapters: list, prompt_len: int,
                  max_new: int) -> list:
    return [Request(f"r{i}", adapters[i % len(adapters)],
                    tuple(1 + (i + j) % 97 for j in range(prompt_len)),
                    max_new)
            for i in range(n)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(argv=None) -> dict:
    """Parse ``argv``, build the model and store, serve a warmup request
    and then the request trace. Returns the run's figures and objects:
    ``requests``, ``tokens``, ``seconds``, ``steps``, ``warmup_steps``,
    ``weights_fmt`` (the base's format), ``base_bytes`` (bytes of the
    frozen ``w`` leaves, codes and scales included), ``params_bytes``,
    ``batcher``, ``params``, ``cfg``."""
    ap = build_arg_parser()
    ns = ap.parse_args(argv)
    if ns.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card and none is "
                           "visible; pass --device cpu to serve on the CPU")
    if ns.adapters < 1:
        ap.error("--adapters must be >= 1: the port serves the continuous "
                 "multi-tenant path only so far")
    device = torch.device(ns.device)
    cfg = get_config(ns.arch)
    if ns.reduced:
        cfg = cfg.reduced()
    policy = ExecutionPolicy(backend=ENGINES[ns.engine], device=device,
                             quantize=ns.quantize)
    store_capacity = (ns.store_capacity if ns.store_capacity is not None
                      else min(ns.adapters, 4))
    tile = ns.tile if ns.tile is not None else max(ns.batch // 2, 1)
    n_requests = ns.requests if ns.requests is not None else 2 * ns.adapters
    max_new = ns.max_new if ns.max_new is not None else ns.steps
    if ns.prompt_len + max_new > ns.max_len:
        ap.error(f"--prompt-len + --max-new ({ns.prompt_len}+{max_new}) "
                 f"exceeds --max-len {ns.max_len}")

    gen = torch.Generator(device=device).manual_seed(ns.seed)
    params = model_lib.init_params(cfg, generator=gen, quantize=ns.quantize)
    store = AdapterStore(params, capacity=store_capacity)
    bat = ContinuousBatcher(cfg, store, slots=ns.batch, tile=tile,
                            max_len=ns.max_len, page_size=ns.page_size,
                            policy=policy, mem_budget_mb=ns.mem_budget_mb)
    weights_fmt = bat.weights_fmt
    base_bytes = quant.tree_bytes(params, frozen_base=True)
    params_bytes = quant.tree_bytes(params)
    log.info("arch=%s engine=%s backend=%s device=%s batch=%d adapters=%d "
             "base=%s", cfg.name, ns.engine, policy.backend, device,
             ns.batch, ns.adapters, weights_fmt)
    log.info("frozen base: %.1f MB resident (%s), all params %.1f MB",
             base_bytes / 1e6, weights_fmt, params_bytes / 1e6)
    uids = [f"tenant{i}" for i in range(ns.adapters)]
    for i, uid in enumerate(uids):
        bat.register_adapter(uid, synthetic_adapters(params, ns.seed + i))

    bat.run([Request("warmup", uids[0], (1, 2, 3), 2)])
    _sync(device)
    warmup_steps = bat.counters["steps"]
    for c in (bat.counters, store.counters, bat.alloc.counters):
        c.update({k: 0 for k in c})
    bat.results.clear()

    reqs = request_trace(n_requests, uids, ns.prompt_len, max_new)
    t0 = time.monotonic()
    results = bat.run(reqs)
    _sync(device)
    dt = time.monotonic() - t0
    served = sum(len(v) for v in results.values())
    log.info("served %d requests / %d tokens across %d tenants in %.3fs "
             "(%.1f tok/s)", len(results), served, ns.adapters, dt,
             served / dt)
    log.info("batcher: %s", dict(bat.counters))
    log.info("store:   %s (resident %d/%d, %.2f MB/slot)",
             dict(store.counters), store.resident, store.capacity,
             store.slot_bytes / 2**20)
    log.info("pages:   %s (%d/%d used)", dict(bat.alloc.counters),
             bat.alloc.used_pages, bat.alloc.n_pages)
    return {"requests": len(results), "tokens": served, "seconds": dt,
            "steps": bat.counters["steps"], "warmup_steps": warmup_steps,
            "weights_fmt": weights_fmt, "base_bytes": base_bytes,
            "params_bytes": params_bytes, "batcher": bat, "params": params,
            "cfg": cfg}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    serve(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
