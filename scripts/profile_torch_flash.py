"""Per-launch device time of the port's flash-attention kernels at shapes
that take their cost apart, on the card.

Each shape runs ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` in bf16
on random inputs made from a seed: the dense training path's (B·H 14, G 7,
N 256, D 64) non-causal (every block walks all four k tiles) and at N 64
(one tile), the same at G 1 (no group sum in dk/dv), and OLMoE's (B·H 16,
G 1, D 128) non-causal. The causal path shapes are timed by
``chip_smoke.py``, with the same timer (``chip_smoke._time_ms``: a CUDA
graph of 64 launches on the same inputs, replayed about 2,000 times, timed
with CUDA events). Prints one JSON line: microseconds per launch by shape
and kernel, and the card.

    PYTHONPATH=src:. python scripts/profile_torch_flash.py
"""
from __future__ import annotations

import json

import torch

from chip_smoke import _time_ms
from repro_torch.kernels import flash_attention as fa

# name: (B·Hkv, G, N, D, causal)
SHAPES = {"full": (2, 7, 256, 64, False), "n64": (2, 7, 64, 64, True),
          "g1": (14, 1, 256, 64, True), "olmoe_full": (16, 1, 256, 128, False)}


def launch_us(fn):
    """Device microseconds of one ``fn()``."""
    return _time_ms(fn, [()] * 64) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_flash: no CUDA card is visible")
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, (BHkv, G, N, D, causal) in SHAPES.items():
        rn = lambda *s: (torch.randn(s, generator=gen, device="cuda")
                         * 0.7).to(torch.bfloat16)
        q, k, v, g = rn(BHkv * G, N, D), rn(BHkv, N, D), rn(BHkv, N, D), \
            rn(BHkv * G, N, D)
        kw = dict(causal=causal, q_per_kv=G)
        o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        delta = fa.bwd_delta(g, o)
        out[name] = {
            "flash_fwd": launch_us(lambda: fa.flash_attention_fwd(
                q, k, v, return_lse=True, **kw)),
            "flash_bwd_dq": launch_us(lambda: fa.flash_bwd_dq(
                q, k, v, g, lse, delta, **kw)),
            "flash_bwd_dkv": launch_us(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, delta, **kw))}
    print(json.dumps({"flash_us_per_launch": out,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
