"""Per-launch device time of the port's bf16 grouped LoRA forward over
expert stacks (``lora_grouped_gemm``, ``_gemm_q`` over int8, ``_gemm_q4``
over int4 and nf4) at the OLMoE-1B-7B training path's shapes, on the card.

E 64 experts, capacity C = bm = 40 (M 2,560 rows, every expert one tile),
r 8, (K, N) of gate/up (2048 x 1024) and down (1024 x 2048); random inputs
made from a seed, timed cold with ``chip_smoke.py``'s timer and input sets
(``_time_ms`` over ``_cold_sets``: enough copies that every launch finds
its inputs out of L2). It uses the ``chip_smoke`` and ``repro_torch`` found
on the path, so one call can time two checkouts in turns:

    PYTHONPATH=src:. python scripts/profile_torch_grouped.py [--label L]

Prints one JSON line: ms per launch by format and shape, the bound (bytes
at 3.35 TB/s or FLOPs at 989 TFLOP/s), the card and its power limit; and,
for the bf16 forward over a bf16 stack at each shape, the share of outputs
that round otherwise than the plain version's and the mean |error| of each
against an f64 product over the same inputs (h rounded to bf16 as both
round it).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

import chip_smoke as cs
from repro_torch.core import quant
from repro_torch.kernels import lora_grouped as lg

E, C, R = 64, 40, 8
SHAPES = {"gate_up": (2048, 1024), "down": (1024, 2048)}
CALLS = 400


def _call(method):
    """The bf16 forward of ``method`` ("dense", "int8", "int4", "nf4") on
    the inputs of ``chip_smoke._moe_cases`` / ``_moe_q_cases``."""
    if method == "dense":
        return lambda x, w, a, b, g, gid: lg.lora_grouped_gemm(
            x, w, a, b, gid, 2.0, bm=C)
    if method == "int8":
        return lambda x, q, s, a, b, g, gid, w: lg.lora_grouped_gemm_q(
            x, q, s, a, b, gid, 2.0, bm=C)
    return lambda x, q, s, a, b, g, gid, w: lg.lora_grouped_gemm_q4(
        x, q, s, a, b, gid, 2.0, bm=C, method=method)


def rounding(x, w, a, b, gid):
    """The bf16 forward and its plain version against f64 on one input
    set: share of outputs that differ, and each one's mean |error|."""
    y = lg.lora_grouped_gemm(x, w, a, b, gid, 2.0, bm=C)
    ref = lg.lora_grouped_gemm_ref(x, w, a, b, gid, 2.0, bm=C)
    xt = x.view(E, C, -1)
    h = (xt.float() @ a.float()).to(torch.bfloat16).double()
    exact = (xt.double() @ w.double() + 2.0 * (h @ b.double())).view(y.shape)
    return {"differ_share": float((y != ref).double().mean()),
            "kernel_mean_abs_err": float((y.double() - exact).abs().mean()),
            "plain_mean_abs_err": float((ref.double() - exact).abs().mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name for this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_grouped: no CUDA card is visible")
    gen = torch.Generator(device="cuda").manual_seed(20)
    gid = list(range(E))
    M = E * C
    out, rnd = {}, {}
    for method in ("dense", "int8", "int4", "nf4"):
        for shape, (K, N) in SHAPES.items():
            if method == "dense":
                make = cs._moe_cases(torch, gen, torch.bfloat16, M, K, N, E,
                                     R, gid)
                w_bytes = 2 * E * K * N
            else:
                make = cs._moe_q_cases(torch, quant, gen, torch.bfloat16,
                                       method, M, K, N, E, R, gid)
                w_bytes = E * (K * N if method == "int8"
                               else (K + 1) // 2 * N) + 4 * E * N
            nbytes = w_bytes + 2 * (M * (K + N) + E * R * (K + N)) + 4 * E
            flops = 2 * M * K * N + 2 * M * R * (K + N)
            bound, by = cs._bound_ms(nbytes, flops)
            sets = cs._cold_sets(make, nbytes)
            out[f"{method}/{shape}"] = {
                "ms": cs._time_ms(_call(method), sets, CALLS),
                "bound_ms": bound, "bound_by": by}
            if method == "dense":
                rnd[shape] = rounding(*sets[0][:4], sets[0][5])
            del sets
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"grouped_fwd_ms_per_launch": out,
                      "bf16_rounding_vs_plain": rnd, "label": args.label,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
