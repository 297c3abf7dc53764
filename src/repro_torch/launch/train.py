"""Training launcher of the port: LoRA fine-tuning of a dense or MoE model
(``repro.launch.train``, for the subset of its flags that the port
supports). Every step runs through the engine registry's ``build_step``
(``repro_torch.api.registry``).

``--engine`` picks the engine (``repro_torch.api.engines``): ``mesp_cuda``
runs every LoRA linear through the LoRA kernels (forward, dx, dA/dB),
every norm through the RMSNorm kernels and, from 64 tokens on, attention
through the flash-attention kernels (forward, dq, dk/dv); ``mesp`` the
hand-derived structured backward in plain PyTorch (attention through the
chunked flash Function from ``--flash-min-seq`` tokens, in chunks of
``--flash-chunk``), ``mebp`` autograd of the plain forwards, ``store_h``
the Table 5 ablation; ``mesp_seq`` the paper's §4.3 loop (structured
backend, SGD applied per block at once: dense models and ``--optimizer
sgd`` only); ``mezo``, ``mezo_sparse``, ``mezo_lowrank``, ``mezo_block``
and ``mezo_avg4`` the zeroth-order estimates from forwards only (plain
backend, probes seeded from ``--seed`` and the step).
``--optimizer`` is ``sgd`` (the paper's), ``sgd_momentum`` or ``adamw``,
at the constant ``--lr``. The defaults are the paper's batch 1 x seq 256.
``--fuse-rope`` rotates q and k inside the flash kernels (``mesp_cuda``
only, as the reference applies it only to its kernel backend).
``--quantize int8|int4|nf4`` keeps every frozen linear's W0 in that format
(``core/quant.py``); under ``mesp_cuda`` the quantized kernels read it as
stored, the other engines dequantize it first. ``--arch olmoe-1b-7b`` or
``deepseek-moe-16b`` trains an MoE model: under ``mesp_cuda`` every expert
linear runs the grouped kernels (forward, dx, dA/dB over the [E, ·, ·]
stacks), over a ``--quantize``d base those of its format, which read the
expert codes as stored. The run happens on the card unless ``--device
cpu`` is given; with no card visible the default fails rather than
falling back.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \\
        --engine mesp_cuda --steps 4 [--fuse-rope] [--quantize nf4]
    PYTHONPATH=src python -m repro_torch.launch.train --engine mesp_seq
    PYTHONPATH=src python -m repro_torch.launch.train --engine mezo_avg4 \\
        --optimizer adamw
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --engine mesp_cuda --steps 3 [--quantize nf4]

The reference's Trainer facade (checkpoints, the step guard, the
degradation ladder, telemetry) and its schedule flags are not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.api.engines import ENGINES
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.api.registry import engine_names, get_engine
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import quant
from repro_torch.data import make_batch_iterator
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizers, schedules

log = logging.getLogger("repro_torch.train")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family config")
    ap.add_argument("--engine", default="mesp", choices=engine_names())
    ap.add_argument("--optimizer", default="sgd",
                    choices=optimizers.OPTIMIZERS)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fuse-rope", action="store_true",
                    help="mesp_cuda: apply RoPE inside the flash kernels "
                         "(q and k rotated on load, never stored rotated)")
    ap.add_argument("--quantize", default="none", choices=quant.METHODS,
                    help="format of the frozen base weights")
    ap.add_argument("--flash-min-seq", type=int, default=1024,
                    help="structured backend: sequence length from which "
                         "attention takes the chunked flash path")
    ap.add_argument("--flash-chunk", type=int, default=1024)
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(argv=None) -> dict:
    """Parse ``argv``, make the model from ``--seed``, and run ``--steps``
    optimizer steps on batches of the port's data pipeline. Returns
    ``losses`` and ``seconds`` (one per step; a step's time ends in a
    synchronise), ``params`` (the trained ones), ``cfg`` and ``policy``."""
    ap = build_arg_parser()
    ns = ap.parse_args(argv)
    if ns.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card and none is "
                           "visible; pass --device cpu to train on the CPU")
    device = torch.device(ns.device)
    cfg = get_config(ns.arch)
    if ns.reduced:
        cfg = cfg.reduced()
    policy = ExecutionPolicy(backend=ENGINES[ns.engine], device=device,
                             fuse_rope=ns.fuse_rope, quantize=ns.quantize,
                             flash_min_seq=ns.flash_min_seq,
                             flash_chunk=ns.flash_chunk)
    opt = optimizers.make_optimizer(ns.optimizer, schedules.constant(ns.lr))
    step_fn = get_engine(ns.engine).build_step(ns, cfg, opt, policy)

    gen = torch.Generator(device=device).manual_seed(ns.seed)
    params = model_lib.init_params(cfg, generator=gen, quantize=ns.quantize)
    state = opt.init(params)
    data = make_batch_iterator(cfg.vocab, ns.seq, ns.batch, seed=ns.seed)
    log.info("arch=%s layers=%d d_model=%d engine=%s backend=%s device=%s "
             "batch=%d seq=%d optimizer=%s fuse_rope=%s quantize=%s",
             cfg.name, cfg.n_layers, cfg.d_model, ns.engine, policy.backend,
             device, ns.batch, ns.seq, ns.optimizer, ns.fuse_rope,
             ns.quantize)

    losses, seconds = [], []
    for step in range(ns.steps):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in next(data).items()}
        t0 = time.monotonic()
        params, state, loss = step_fn(params, state, batch)
        _sync(device)
        seconds.append(time.monotonic() - t0)
        losses.append(float(loss))
        log.info("step %d loss %.6f (%.1f ms)", step, losses[-1],
                 1e3 * seconds[-1])
    return {"losses": losses, "seconds": seconds, "params": params,
            "cfg": cfg, "policy": policy}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
