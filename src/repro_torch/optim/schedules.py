"""Learning-rate schedules (``repro.optim.schedules``): step -> lr. The
port has the constant schedule, the training default."""
from __future__ import annotations


def constant(lr: float):
    return lambda step: lr
