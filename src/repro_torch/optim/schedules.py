"""Learning-rate schedules (``repro.optim.schedules``): step -> lr, as plain
functions of an int step (the reference's are jit-safe ``jnp``; here the
step is a Python int and the lr a float)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total``, held there after it."""
    def f(step):
        s = float(step)
        if s < warmup:
            return peak * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * prog))

    return f


def inverse_sqrt(peak: float, warmup: int):
    """Linear warm-up to ``peak``, then ``peak · sqrt(warmup / step)``."""
    def f(step):
        s = max(float(step), 1.0)
        return peak * min(s / max(warmup, 1), math.sqrt(warmup / s))

    return f
