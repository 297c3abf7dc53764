"""TrainSpec: one frozen, declarative description of a training run
(``repro.api.spec``).

A TrainSpec carries everything the launcher threads through a run:
architecture, engine, quantize method, optimizer/lr, seq/batch, seed,
device, checkpoint cadence, the resilience and telemetry settings and the
kernel overrides. It round-trips through the CLI (``to_cli_args`` /
``from_cli_args``), so a spec is also a reproducible command line.

The launcher's argument parser is *generated* here: ``--engine`` choices
come from the port's engine registry and ``--quantize`` choices from
``repro_torch.core.quant.METHODS``. Its flags are the reference's, less
``--pallas-interpret`` (the port has no interpreter: a CPU tensor takes each
kernel's plain version) and plus ``--device`` (``cuda``, the default, or
``cpu``). The reference's ``act_spec`` (an activation sharding) has no
field here: the Trainer derives sequence parallelism from its mesh on
every switch (``policy.sp``). ``--model-parallel`` above 1 runs the model
axis (Megatron tensor and sequence parallelism, ``models/parallel.py``)
for the dense family under the engines of :data:`MODEL_AXIS_ENGINES`,
where it divides the heads, the KV heads, d_ff and the vocabulary
(:func:`check_model_axis`); the other families, ``mesp_seq`` and the ZO
engines are refused there (``ROADMAP.md`` §1, item 3).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.api.policy import ExecutionPolicy
from repro_torch.api.registry import get_engine, list_engines

OPTIMIZERS = ("sgd", "sgd_momentum", "adamw")
DEVICES = ("cuda", "cpu")
#: the engines that run under a model axis above 1
MODEL_AXIS_ENGINES = ("mesp", "mesp_cuda", "mebp", "store_h")


def check_model_axis(cfg, model_parallel: int, engine: str = "mesp",
                     quantize: str = "none") -> None:
    """Raise ValueError unless ``cfg`` trains under ``engine`` on a model
    axis of ``model_parallel``: the dense family, an engine of
    :data:`MODEL_AXIS_ENGINES`, and an axis that divides the heads, the KV
    heads, d_ff and the vocabulary (a packed 4-bit base also needs the
    row-parallel linears' input shards even: two rows share a byte). The
    reference's placement rules would replicate a leaf the axis does not
    divide, and its partitioner split a head; the port's kernels cannot,
    so it refuses (``ROADMAP.md`` §3)."""
    mp = model_parallel
    if mp == 1:
        return
    if cfg.family != "dense":
        raise ValueError(
            f"--model-parallel {mp}: the {cfg.family} family "
            f"({cfg.name}) has no model axis in the port yet (ROADMAP.md "
            "§1, item 3: expert-parallel MoE, ssm, hybrid, vlm and audio "
            "tensor parallelism)")
    if engine not in MODEL_AXIS_ENGINES:
        raise ValueError(
            f"--model-parallel {mp}: engine {engine!r} does not run under a "
            f"model axis yet (ROADMAP.md §1, item 3: mesp_seq and the ZO "
            f"engines at mp > 1); it runs {MODEL_AXIS_ENGINES}")
    for name in ("n_heads", "n_kv_heads", "d_ff", "vocab"):
        dim = getattr(cfg, name)
        if dim % mp:
            raise ValueError(
                f"--model-parallel {mp} does not divide {name} = {dim} of "
                f"{cfg.name}: the port does not split a head, a column of "
                "d_ff or a row of the vocabulary (ROADMAP.md §3)")
    if quantize in ("int4", "nf4"):
        for name, k in (("q_size", cfg.q_size), ("d_ff", cfg.d_ff)):
            if (k // mp) % 2:
                raise ValueError(
                    f"--model-parallel {mp} --quantize {quantize}: a "
                    f"row-parallel shard of {name} = {k} has {k // mp} "
                    "rows, odd, and packed rows pair them (no padding)")


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    arch: str = "qwen2.5-0.5b"
    reduced: bool = False
    engine: str = "mesp"
    quantize: str = "none"
    optimizer: str = "sgd"
    lr: float = 1e-4
    steps: int = 100
    batch: int = 1          # paper: batch 1
    seq: int = 256          # paper: seq 256
    seed: int = 0
    device: str = "cuda"    # cuda | cpu (no fallback from one to the other)
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_interval: int = 50
    log_interval: int = 10
    # --- kernel / execution overrides (ExecutionPolicy fields) -------------
    flash_min_seq: int = 1024
    flash_chunk: int = 1024
    fuse_rope: bool = False   # mesp_cuda: RoPE inside the flash kernels
    # --- resilience: chaos injection, degradation ladder, step guard -------
    inject_faults: str = ""        # FaultPlan string ("" = no injection)
    degrade: str = "on"            # memory-pressure ladder on OOM (on/off)
    guard: str = "on"              # NaN/spike step guard (on/off)
    guard_budget: int = 8          # anomalous steps rejected before aborting
    max_retries: int = 3           # consecutive step failures before raising
    straggler_factor: float = 10.0  # watchdog: slow = factor x EWMA step time
    straggler_limit: int = 3       # consecutive slow steps before restart
    # --- telemetry: structured metrics / events / spans --------------------
    telemetry: str = "off"         # typed JSONL events + metrics + spans
    telemetry_dir: str = ""        # output dir ("" = <ckpt_dir>/telemetry)
    profile: str = "off"           # torch.profiler capture around the run
    mem_budget_mb: float = 0.0     # watermark-pressure degrade limit (0=off)
    quiet: bool = False            # console: warnings only
    # --- sharding: the model axis's size (the data axis takes the rest) ---
    model_parallel: int = 1

    # ------------------------------------------------------------------ API
    def validate(self) -> "TrainSpec":
        """Check engine/quantize/optimizer coherence against the registry.
        Returns self so it chains; raises UnknownEngineError/ValueError."""
        eng = get_engine(self.engine)
        if self.quantize not in eng.quantize:
            raise ValueError(
                f"engine {self.engine!r} does not support "
                f"--quantize {self.quantize!r} (supported: {eng.quantize})")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             f"expected one of {OPTIMIZERS}")
        if self.device not in DEVICES:
            raise ValueError(f"--device must be one of {DEVICES}, "
                             f"got {self.device!r}")
        for name in ("degrade", "guard", "telemetry", "profile"):
            if getattr(self, name) not in ("on", "off"):
                raise ValueError(f"--{name} must be 'on' or 'off', "
                                 f"got {getattr(self, name)!r}")
        if self.mem_budget_mb < 0:
            raise ValueError(f"--mem-budget-mb must be >= 0, "
                             f"got {self.mem_budget_mb}")
        if self.model_parallel < 1:
            raise ValueError(f"--model-parallel must be >= 1, "
                             f"got {self.model_parallel}")
        if self.model_parallel > 1:
            from repro_torch.configs import get_config
            cfg = get_config(self.arch)
            check_model_axis(cfg.reduced() if self.reduced else cfg,
                             self.model_parallel, self.engine, self.quantize)
        if self.inject_faults:
            from repro_torch.runtime.faults import FaultPlan
            # parse errors (unknown kind, bad syntax) surface before compute
            FaultPlan.from_string(self.inject_faults,
                                  total_steps=self.steps, seed=self.seed)
        return self

    def policy(self) -> ExecutionPolicy:
        """The ExecutionPolicy this spec's engine threads through the model
        stack (engines with a custom regime, e.g. mezo, get ``plain``)."""
        eng = get_engine(self.engine)
        return ExecutionPolicy(
            backend=eng.backend or "plain", quantize=self.quantize,
            device=self.device, flash_min_seq=self.flash_min_seq,
            flash_chunk=self.flash_chunk, fuse_rope=self.fuse_rope)

    # ------------------------------------------------------- CLI round trip
    def to_cli_args(self) -> list:
        """Minimal argv reproducing this spec (non-default fields only)."""
        argv = []
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if val == f.default:
                continue
            flag = "--" + f.name.replace("_", "-")
            if f.name in ("reduced", "fuse_rope", "quiet"):
                argv.append(flag)
            else:
                argv += [flag, repr(val) if isinstance(val, float) else
                         str(val)]
        return argv

    @classmethod
    def from_cli_args(cls, argv=None) -> "TrainSpec":
        return cls.from_namespace(build_arg_parser().parse_args(argv))

    @classmethod
    def from_namespace(cls, ns) -> "TrainSpec":
        """Spec from a parsed :func:`build_arg_parser` namespace. Extra
        attributes are ignored, so a launcher with flags of its own still
        gets a spec from the shared fields."""
        return cls(**{f.name: getattr(ns, f.name)
                      for f in dataclasses.fields(cls)})


def build_arg_parser(prog: str = "repro_torch.launch.train"
                     ) -> argparse.ArgumentParser:
    """The training launcher's CLI, generated from the registry."""
    from repro_torch.configs import REGISTRY
    from repro_torch.core.quant import METHODS as QUANT_METHODS

    d = TrainSpec()
    engines = list_engines()
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--arch", default=d.arch, choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family config (CPU-runnable)")
    ap.add_argument("--engine", default=d.engine,
                    choices=[e.name for e in engines],
                    help="gradient engine (registry-generated): " +
                         "; ".join(f"{e.name} = {e.description}"
                                   for e in engines))
    ap.add_argument("--quantize", default=d.quantize,
                    choices=list(QUANT_METHODS),
                    help="frozen-base-weight format; per-engine support is "
                         "declared in the registry and validated up front")
    ap.add_argument("--optimizer", default=d.optimizer,
                    choices=list(OPTIMIZERS))
    ap.add_argument("--lr", type=float, default=d.lr)
    ap.add_argument("--steps", type=int, default=d.steps)
    ap.add_argument("--batch", type=int, default=d.batch)
    ap.add_argument("--seq", type=int, default=d.seq)
    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--device", default=d.device, choices=list(DEVICES),
                    help="where the run happens; cuda (the default) fails "
                         "without a card rather than falling back")
    ap.add_argument("--ckpt-dir", default=d.ckpt_dir)
    ap.add_argument("--ckpt-interval", type=int, default=d.ckpt_interval)
    ap.add_argument("--log-interval", type=int, default=d.log_interval)
    ap.add_argument("--flash-min-seq", type=int, default=d.flash_min_seq,
                    help="structured backend: sequence length from which "
                         "attention takes the chunked flash path")
    ap.add_argument("--flash-chunk", type=int, default=d.flash_chunk)
    ap.add_argument("--fuse-rope", action="store_true",
                    help="mesp_cuda: apply RoPE inside the flash kernels "
                         "(q and k rotated on load, never stored rotated)")
    ap.add_argument("--inject-faults", default=d.inject_faults,
                    help="chaos run: deterministic fault plan, e.g. "
                         "'oom@4,corrupt@9,crash@9,nan@14,stall@18:1.5' or "
                         "'random:5' (seeded from --seed)")
    ap.add_argument("--degrade", default=d.degrade, choices=["on", "off"],
                    help="on OOM, walk the memory-pressure degradation "
                         "ladder (halve batch -> leaner engine, never out "
                         "of mesp_cuda on the card -> int8 W0 -> packed "
                         "int4 W0 -> truncate seq) instead of retrying the "
                         "same program")
    ap.add_argument("--guard", default=d.guard, choices=["on", "off"],
                    help="reject (skip-and-rewind) steps with NaN/Inf loss "
                         "or update-norm spikes")
    ap.add_argument("--guard-budget", type=int, default=d.guard_budget,
                    help="anomalous steps the guard may reject before the "
                         "run aborts")
    ap.add_argument("--max-retries", type=int, default=d.max_retries,
                    help="consecutive step failures tolerated (budget "
                         "resets after every successful step)")
    ap.add_argument("--straggler-factor", type=float,
                    default=d.straggler_factor,
                    help="watchdog: a step slower than factor x the EWMA "
                         "step time is flagged slow")
    ap.add_argument("--straggler-limit", type=int, default=d.straggler_limit,
                    help="consecutive slow steps before a supervised "
                         "restart from checkpoint")
    ap.add_argument("--telemetry", default=d.telemetry,
                    choices=["on", "off"],
                    help="structured observability: typed JSONL events, "
                         "metric registry, trace spans and memory "
                         "watermarks (zero-cost when off)")
    ap.add_argument("--telemetry-dir", default=d.telemetry_dir,
                    help="where JSONL event shards and the Chrome trace "
                         "land (default: <ckpt-dir>/telemetry)")
    ap.add_argument("--profile", default=d.profile, choices=["on", "off"],
                    help="capture a torch.profiler trace of the run (CPU "
                         "and CUDA activity) as a Chrome trace under "
                         "<telemetry-dir>/profile (requires --telemetry on)")
    ap.add_argument("--mem-budget-mb", type=float, default=d.mem_budget_mb,
                    help="device memory budget in MB of 2**20 bytes: when "
                         "the measured residency stays above 90%% of this, "
                         "the degradation ladder walks proactively instead "
                         "of waiting for an OOM (0 = exception-triggered "
                         "only)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-step and summary console logging "
                         "(structured telemetry sinks are unaffected)")
    ap.add_argument("--model-parallel", type=int, default=d.model_parallel,
                    help="model-axis size (Megatron tensor and sequence "
                         "parallelism): the dense family under mesp, "
                         "mesp_cuda, mebp or store_h, where it divides the "
                         "heads, KV heads, d_ff and vocab; the ranks of a "
                         "torchrun world take (data, model) = (world / "
                         "model, model)")
    return ap
