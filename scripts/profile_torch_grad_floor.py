"""Readings behind ``chip_smoke.MOE_COS_FLOOR``: the per-leaf cosine of the
full-depth MoE gradient check (LoRA gradients through the kernels against
the plain bf16 backend, routing and MoE block inputs pinned to the kernel
run's; ``chip_smoke.grads_moe``), on the model ``chip_smoke.py`` checks
(full-width OLMoE-1B-7B, 16 layers, random weights from seed 0, batch 1 x
seq 256), over a bf16 and an nf4 frozen base. Once with the kernels as
they are, then with one fault planted in the result of the bf16 grouped
forward over expert stacks (``lora_grouped_gemm``, ``_gemm_q``,
``_gemm_q4``), f32 calls left alone, so only the bf16 check can see it:

- ``k_tail``: x @ W0 without the last 16 of K, as a K loop one m16n8k16
  step short would give;
- ``swap_expert``: expert 0's tiles computed with expert 1's W0, A and B,
  as a misread group id would give;
- ``code_off``: expert 0's W0 one code off, every bf16 value one ulp up
  in magnitude or, over nf4, every code one up (15 wraps to 0).

Each fault wraps the kernel's Python wrapper and leaves the source alone.

    PYTHONPATH=src:. python scripts/profile_torch_grad_floor.py

Prints one JSON line per base and fault, as each is read: the least
cosine over the 14 LoRA leaves (``kernels_vs_plain``) and the worst
relative L2, beside the f32 kernels' worst relative L2 against plain f32;
then one with the floor and the card.
"""
from __future__ import annotations

import functools
import json
import subprocess

import torch

import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import _build
from repro_torch.kernels import lora_grouped as lg
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib

WRAPPERS = ("lora_grouped_gemm", "lora_grouped_gemm_q", "lora_grouped_gemm_q4")
TAIL = 16


def _replace(args, i, v):
    return args[:i] + (v,) + args[i + 1:]


def k_tail(fn, x, *args, **kw):
    """The result less round(x[:, -TAIL:] @ W0[-TAIL:]) (times the scale),
    which the kernel itself gives for x zero but its last TAIL columns and
    B zero (positional args end with a, b, gid, scale)."""
    xt = torch.zeros_like(x)
    xt[:, -TAIL:] = x[:, -TAIL:]
    tail = fn(xt, *_replace(args, len(args) - 3, torch.zeros_like(args[-3])),
              **kw)
    return (fn(x, *args, **kw).float() - tail.float()).to(x.dtype)


def swap_expert(fn, x, *args, **kw):
    gid = args[-2]
    return fn(x, *_replace(args, len(args) - 2, torch.where(gid == 0, 1, gid)),
              **kw)


def code_off(fn, x, *args, **kw):
    w = args[0].clone()
    if w.dtype == torch.bfloat16:
        w[0] = (w[0].view(torch.int16) + 1).view(torch.bfloat16)
    else:  # packed nf4 codes
        lo, hi = (w[0] + 1) & 15, ((w[0] >> 4) + 1) & 15
        w[0] = lo | (hi << 4)
    return fn(x, w, *args[1:], **kw)


FAULTS = {"k_tail": k_tail, "swap_expert": swap_expert, "code_off": code_off}


def planted(fault):
    """Patch every bf16 grouped forward wrapper of ``lg`` with ``fault``;
    returns the function that restores them."""
    saved = {n: getattr(lg, n) for n in WRAPPERS}

    def wrap(fn):
        @functools.wraps(fn)  # the wrapper counts launches on its name
        def faulty(x, *args, **kw):
            if x.dtype != torch.bfloat16:
                return fn(x, *args, **kw)
            return fault(fn, x, *args, **kw)
        return faulty
    for n, fn in saved.items():
        setattr(lg, n, wrap(fn))
    return lambda: [setattr(lg, n, fn) for n, fn in saved.items()]


def reading(cfg, batch, quantize, fault):
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cs._with_b(torch, model_lib.init_params(
        cfg, generator=gen, quantize=None if quantize == "none"
        else quantize), gen)
    restore = planted(FAULTS[fault]) if fault else (lambda: None)
    try:
        d = cs.grads_moe(torch, moe_lib, cfg, params, batch,
                         quantize=quantize)
    finally:
        restore()
    del params
    cs._release(torch)
    cos = [e["cos"]["kernels_vs_plain"] for e in d["leaves"].values()]
    return {"min_cos": min(cos), "max_cos": max(cos),
            "worst_rel": d["worst"]["kernels_vs_plain"],
            "f32_kernels_worst_rel": d["worst"]["kernels_f32_vs_f32"],
            "leaves": len(cos), "loss": d["loss"],
            "cos_per_leaf": {p: e["cos"]["kernels_vs_plain"]
                             for p, e in d["leaves"].items()}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_grad_floor: no CUDA card is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cfg = get_config(cs.MOE_ARCH)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in next(
        make_batch_iterator(cfg.vocab, cs.PAPER_SEQ, cs.PAPER_BATCH,
                            seed=0)).items()}
    for base in ("none", "nf4"):
        for fault in [None, *FAULTS]:
            print(json.dumps({"base": base, "fault": fault or "none",
                              **reading(cfg, batch, base, fault)}),
                  flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"floor": cs.MOE_COS_FLOOR,
                      "layers": cfg.n_layers,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
