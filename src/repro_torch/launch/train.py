"""Training launcher of the port (``repro.launch.train``): LoRA
fine-tuning of a dense or MoE model, with two entry points.

* :func:`main` is the launcher: ``TrainSpec.from_cli_args(argv)`` →
  ``Trainer.from_spec(spec).fit()`` (``repro_torch.api.trainer``) →
  ``telemetry.log_run_summary``, as the reference's is (:func:`run` is
  the same and returns the ``TrainResult``). It takes the
  reference's flags (less ``--pallas-interpret``, plus ``--device``):
  checkpoints go to ``--ckpt-dir`` every ``--ckpt-interval`` steps and at
  the end, atomically, and a run resumes from the newest one there (pass a
  directory of its own to start afresh); ``--inject-faults`` plays a chaos
  plan; an OOM, or with ``--mem-budget-mb`` a measured residency above 90%
  of the budget, walks the degradation ladder (``--degrade``); the step
  guard (``--guard``) skips and rewinds NaN or spiking steps; the straggler
  watchdog restarts from the checkpoint; ``--telemetry on`` writes typed
  JSONL events, spans and memory watermarks under ``--telemetry-dir``
  (``--profile on`` adds a ``torch.profiler`` Chrome trace).
* :func:`train` is the bare loop: it parses the same flags into a
  TrainSpec, builds the engine's step through the registry and runs
  ``--steps`` of it on the data pipeline's batches; it reads the flags of
  the run itself (those below) and no checkpoint, guard, ladder or
  telemetry flag. The kernel phases of ``chip_smoke.py`` and the CPU
  parity tests call it.

Every step runs through the engine registry's ``build_step``
(``repro_torch.api.registry``). ``--engine`` picks the engine
(``repro_torch.api.engines``): ``mesp_cuda``
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
        --engine mesp_cuda --steps 4 --ckpt-dir /path/to/run1
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 6 --ckpt-dir /path/to/run2 \\
        --inject-faults 'oom@2,crash@4,nan@5'

Data- and tensor-parallel (``torchrun``): with ``WORLD_SIZE`` above 1 in
the environment, :func:`run` joins a process group first (``gloo`` for
``--device cpu``, ``nccl`` for the card, one card a rank by
``LOCAL_RANK``; ``--device cuda`` without ``nccl``, or with more ranks on
a host than visible cards, raises: it never falls back to ``gloo`` or the
CPU), and the Trainer trains over a (data, model) mesh of every rank,
``--model-parallel`` of them on the model axis (Megatron tensor and
sequence parallelism, dense family): ``--batch`` is the global batch,
each rank reads its data index's rows, the partial LoRA gradients are
summed over the model axis and the LoRA gradients all-reduced over the
data axis in each step.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced \
        --device cpu --batch 4 --steps 3 --ckpt-dir /path/to/run3
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
        --device cpu --batch 4 --steps 3 --model-parallel 2 \
        --ckpt-dir /path/to/run4

The reference's schedule flags are not ported yet.
"""
from __future__ import annotations

import logging
import os
import time

import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.api.registry import get_engine
# re-exported: the launcher's parser, generated from the registry
from repro_torch.api.spec import TrainSpec, build_arg_parser  # noqa: F401
from repro_torch.api.trainer import Trainer
from repro_torch.configs import get_config
from repro_torch.data import make_batch_iterator
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizers, schedules

log = logging.getLogger("repro_torch.train")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(argv=None) -> dict:
    """Parse ``argv``, make the model from ``--seed``, and run ``--steps``
    optimizer steps on batches of the port's data pipeline. Returns
    ``losses`` and ``seconds`` (one per step; a step's time ends in a
    synchronise), ``params`` (the trained ones), ``cfg`` and ``policy``."""
    spec = TrainSpec.from_cli_args(argv)
    if spec.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card and none is "
                           "visible; pass --device cpu to train on the CPU")
    if spec.model_parallel > 1:
        raise ValueError("the bare loop runs one process; --model-parallel "
                         "runs through the launcher (main, under torchrun)")
    device = torch.device(spec.device)
    cfg = get_config(spec.arch)
    if spec.reduced:
        cfg = cfg.reduced()
    policy = spec.policy()
    opt = optimizers.make_optimizer(spec.optimizer,
                                    schedules.constant(spec.lr))
    step_fn = get_engine(spec.engine).build_step(spec, cfg, opt, policy)

    gen = torch.Generator(device=device).manual_seed(spec.seed)
    params = model_lib.init_params(cfg, generator=gen,
                                   quantize=spec.quantize)
    state = opt.init(params)
    data = make_batch_iterator(cfg.vocab, spec.seq, spec.batch,
                               seed=spec.seed)
    log.info("arch=%s layers=%d d_model=%d engine=%s backend=%s device=%s "
             "batch=%d seq=%d optimizer=%s fuse_rope=%s quantize=%s",
             cfg.name, cfg.n_layers, cfg.d_model, spec.engine, policy.backend,
             device, spec.batch, spec.seq, spec.optimizer, spec.fuse_rope,
             spec.quantize)

    losses, seconds = [], []
    for step in range(spec.steps):
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


def join_process_group(device: str) -> bool:
    """Join ``torchrun``'s process group when ``WORLD_SIZE`` > 1 (its
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``): ``gloo`` on the CPU,
    ``nccl`` on the card with this rank's card (``LOCAL_RANK``) made
    current, one card a rank. Returns whether it joined one (False at
    world size 1 or when a group exists already). ``cuda`` without
    ``nccl``, or with more ranks on this host (``LOCAL_WORLD_SIZE``) than
    visible cards, raises."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if device == "cuda":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("--device cuda over several ranks needs CUDA "
                               "cards and nccl; pass --device cpu to train "
                               "over gloo on the CPU")
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        if local > torch.cuda.device_count():
            raise RuntimeError(
                f"--device cuda runs one card a rank: {local} ranks on this "
                f"host, {torch.cuda.device_count()} visible cards")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def run(argv=None):
    """The launcher's run: ``argv`` as a TrainSpec, through the Trainer,
    with the end-of-run summary logged. Returns the TrainResult. Under
    ``torchrun`` (``WORLD_SIZE`` > 1) the run is data-parallel over the
    process group it joins (:func:`join_process_group`)."""
    spec = TrainSpec.from_cli_args(argv).validate()

    logging.basicConfig(
        level=logging.WARNING if spec.quiet else logging.INFO)
    joined = join_process_group(spec.device)
    try:
        return _run(spec)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(spec):
    trainer = Trainer.from_spec(spec)
    cfg = trainer.cfg
    log.info("arch=%s layers=%d d_model=%d engine=%s quantize=%s device=%s",
             cfg.name, cfg.n_layers, cfg.d_model, spec.engine, spec.quantize,
             spec.device)

    result = trainer.fit()
    # end-of-run reporting goes through the structured choke point
    # (repro_torch.telemetry): per-step lines already did during fit
    telemetry.log_run_summary(result, quiet=spec.quiet)
    if result.degradations:
        fs = result.final_spec
        log.info("final spec after degradation: engine=%s batch=%d "
                 "seq=%d quantize=%s", fs.engine, fs.batch, fs.seq,
                 fs.quantize)
    if spec.telemetry == "on":
        log.info("telemetry: %s", result.metrics.get("telemetry_dir"))
    return result


def main(argv=None) -> int:
    """The launcher (``python -m repro_torch.launch.train``)."""
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
