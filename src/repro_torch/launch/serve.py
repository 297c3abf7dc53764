"""Serving launcher of the port (``repro.launch.serve``), in two modes
picked by the model family, as the reference picks them.

* **Continuous batching** (dense and vlm, ``--adapters`` >= 1): requests
  round-robin over ``--adapters`` synthetic tenant adapters; an
  :class:`~repro_torch.serve.AdapterStore` holds ``--store-capacity`` of
  them resident, and the :class:`~repro_torch.serve.ContinuousBatcher`
  admits and recycles at step granularity with paged-KV accounting. Under
  ``--engine mesp_cuda`` (the default) every LoRA linear runs the grouped
  LoRA kernel and every norm the RMSNorm kernel. ``--mem-budget-mb``
  admits a request only while the modelled resident set
  (``serve/residency.py``, the base in its format) stays within it.
* **Single-stream decode** (:class:`DecodeServer`: MoE, ``ssm``,
  ``hybrid``, ``audio``, and dense or vlm with ``--adapters 0``): one
  batch of ``--batch`` sequences at one shared position, greedy, for
  ``--steps`` steps, over the model's own LoRA factors. Under
  ``mesp_cuda`` every LoRA linear runs the dense LoRA kernels at M =
  batch (an ``audio`` model's cross-attention k/v at M = batch x its
  encoder's frames, against a zero encoder output, as the reference
  serves it), the MoE experts the grouped ones, and every norm the RMSNorm
  kernel. ``--adapters`` above 1 needs a dense or vlm arch.

``--engine mesp`` runs the plain PyTorch forwards. ``--quantize
int8|int4|nf4`` keeps the frozen base in that format: under
``mesp_cuda`` the kernels over int8 or packed codes run in place of the
float ones, and ``mesp`` dequantizes. The run happens on the card unless
``--device cpu`` is given; with no card visible the default fails rather
than falling back.

A warmup (a request, or one decode step) is served, synchronised and
discarded before the timed part, so the kernel build and first launches
are not in tokens/s.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-0.5b \\
        --adapters 4 --batch 8 --tile 2 --requests 8 --prompt-len 8 \\
        --max-new 16 [--quantize nf4]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --batch 4 --steps 32
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
                    help="decode slots (single-stream: sequences)")
    ap.add_argument("--steps", type=int, default=32,
                    help="default of --max-new; single-stream: decode "
                         "steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-len", type=int, default=128,
                    help="decode cache capacity per slot")
    ap.add_argument("--adapters", type=int, default=1,
                    help="synthetic tenant adapters to serve (0: a dense "
                         "arch decodes single-stream)")
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


class DecodeServer:
    """Single-stream batched decode: ``batch`` sequences at one shared
    position over the model's own LoRA factors (families without per-slot
    caches, and dense models served without tenants). The cache lives on
    ``policy.device``; an ``audio`` model's ``cache["enc_out"]`` is zeros
    (as in the reference) until the caller sets it."""

    def __init__(self, cfg, params, batch: int, max_len: int,
                 policy: ExecutionPolicy):
        found = quant.tree_method(params)
        if found != policy.quantize:
            raise ValueError(f"the frozen base is {found!r} but "
                             f"policy.quantize is {policy.quantize!r}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.policy = policy
        self.cache = model_lib.init_cache(cfg, batch, max_len,
                                          device=policy.device,
                                          per_slot=False)
        #: logits [batch, 1, V] of the latest step
        self.last_logits = None

    def step(self, tokens):
        """tokens [B, 1] -> the greedy next tokens [B, 1]."""
        logits, self.cache = model_lib.decode_step(
            self.params, self.cfg, self.cache, tokens, policy=self.policy)
        self.last_logits = logits
        return logits.argmax(-1)


def _single_stream(cfg, params, ns, policy, figures) -> dict:
    device = policy.device
    server = DecodeServer(cfg, params, ns.batch, ns.max_len, policy)
    tok = torch.ones((ns.batch, 1), dtype=torch.long, device=device)
    # warmup: the kernel build and first launches, synced and discarded
    tok = server.step(tok)
    _sync(device)
    t0 = time.monotonic()
    outs = []
    for _ in range(ns.steps):
        tok = server.step(tok)
        outs.append(tok[:, 0])
    samples = torch.stack(outs, 1).cpu() if outs else None
    _sync(device)
    dt = time.monotonic() - t0
    tokens = ns.steps * ns.batch
    log.info("decoded %d steps x %d seqs in %.3fs (%.1f tok/s, %.2f ms a "
             "step)", ns.steps, ns.batch, dt, tokens / dt,
             1e3 * dt / max(ns.steps, 1))
    return {**figures, "mode": "single_stream", "tokens": tokens,
            "seconds": dt, "steps": ns.steps, "warmup_steps": 1,
            "tok_s": tokens / dt, "ms_per_step": 1e3 * dt / max(ns.steps, 1),
            "samples": samples, "server": server}


def serve(argv=None) -> dict:
    """Parse ``argv``, build the model, serve a warmup and then the timed
    part: the request trace through the batcher, or single-stream decode
    steps. Returns the run's figures and objects: ``mode``
    ("continuous" or "single_stream"), ``requests``, ``tokens``,
    ``seconds``, ``steps``, ``warmup_steps``, ``tok_s``, ``ms_per_step``,
    ``weights_fmt`` (the base's format), ``base_bytes`` (bytes of the
    frozen ``w`` leaves, codes and scales included), ``params_bytes``,
    ``params``, ``cfg``, and ``batcher`` (continuous) or ``server`` and
    ``samples`` (single-stream: the greedy tokens [batch, steps] on the
    CPU)."""
    ap = build_arg_parser()
    ns = ap.parse_args(argv)
    if ns.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card and none is "
                           "visible; pass --device cpu to serve on the CPU")
    device = torch.device(ns.device)
    cfg = get_config(ns.arch)
    if ns.reduced:
        cfg = cfg.reduced()
    continuous = cfg.family in ("dense", "vlm") and ns.adapters >= 1
    if not continuous and ns.adapters > 1:
        ap.error(f"--adapters > 1 needs a dense/vlm arch (got family "
                 f"{cfg.family!r})")
    policy = ExecutionPolicy(backend=ENGINES[ns.engine], device=device,
                             quantize=ns.quantize)
    gen = torch.Generator(device=device).manual_seed(ns.seed)
    if not continuous:
        if cfg.family != "ssm" and ns.steps + 1 > ns.max_len:
            ap.error(f"--steps + 1 warmup step ({ns.steps}+1) exceeds "
                     f"--max-len {ns.max_len}")
        params = model_lib.init_params(cfg, generator=gen,
                                       quantize=ns.quantize)
        log.info("arch=%s engine=%s backend=%s device=%s batch=%d "
                 "single-stream base=%s", cfg.name, ns.engine,
                 policy.backend, device, ns.batch,
                 quant.weights_format(ns.quantize))
        return _single_stream(cfg, params, ns, policy, {
            "requests": 0,
            "weights_fmt": quant.weights_format(ns.quantize),
            "base_bytes": quant.tree_bytes(params, frozen_base=True),
            "params_bytes": quant.tree_bytes(params), "params": params,
            "cfg": cfg})
    store_capacity = (ns.store_capacity if ns.store_capacity is not None
                      else min(ns.adapters, 4))
    tile = ns.tile if ns.tile is not None else max(ns.batch // 2, 1)
    n_requests = ns.requests if ns.requests is not None else 2 * ns.adapters
    max_new = ns.max_new if ns.max_new is not None else ns.steps
    if ns.prompt_len + max_new > ns.max_len:
        ap.error(f"--prompt-len + --max-new ({ns.prompt_len}+{max_new}) "
                 f"exceeds --max-len {ns.max_len}")

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
    steps = bat.counters["steps"]
    return {"mode": "continuous", "requests": len(results), "tokens": served,
            "seconds": dt, "steps": steps, "warmup_steps": warmup_steps,
            "tok_s": served / dt, "ms_per_step": 1e3 * dt / max(steps, 1),
            "weights_fmt": weights_fmt, "base_bytes": base_bytes,
            "params_bytes": params_bytes, "batcher": bat, "params": params,
            "cfg": cfg}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    serve(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
