"""Anomaly-guarded steps: NaN/Inf-loss and update-norm-spike rejection
(``repro.runtime.guard``).

On-device runs hit numerical blowups (a bad batch, a race with the
platform's power management downclocking mid-reduction) that a server fleet
would catch in aggregate dashboards. Here the defence is local: every step's
loss (and optionally the parameter-update norm, which for SGD is
``lr·‖grad‖``) is checked *before* the update is committed. An anomalous
step is rewound — the freshly computed params/opt-state are discarded, the
batch is skipped — and the run continues on the next batch. That rewind is
sound because every engine's step is functional: it returns new trees and
never writes into the one it was given.

The budget is bounded: more than ``budget`` rejected steps per run raises
:class:`GuardExhausted`, because a model that keeps producing NaNs is
diverged, not unlucky, and silently skipping forever would burn the
device's energy budget on garbage.

Observability: every rejection is categorized into one of :data:`REASONS`
and counted in ``by_reason``; :meth:`StepGuard.state` exposes the EWMAs and
counts, and with a telemetry object attached each rejection emits a typed
``guard`` event and updates ``guard.*`` gauges on the metric registry.
"""
from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from repro_torch.tree import tree_leaves

log = logging.getLogger("repro_torch.guard")

#: rejection categories, in check order
REASONS = ("nonfinite_loss", "nonfinite_norm", "loss_spike", "norm_spike")


class GuardExhausted(RuntimeError):
    """Raised when a run rejects more steps than its guard budget allows."""


def update_norm(old_params, new_params) -> float:
    """Global L2 norm of the parameter update over float leaves, each
    leaf's squared difference summed in f32 as the reference computes it
    and the leaves' sums added in f64, read once at the end. A leaf that is
    the same tensor in both trees adds exactly 0 and is skipped: every
    frozen W0 is such a leaf (and so are integer codes, which are never
    differentiated)."""
    total = None
    for a, b in zip(tree_leaves(old_params, keep_none=True),
                    tree_leaves(new_params, keep_none=True)):
        if a is b or not isinstance(a, torch.Tensor) \
                or not a.is_floating_point():
            continue
        d = b.float() - a.float()
        s = torch.sum(d * d).double()
        total = s if total is None else total + s
    return 0.0 if total is None else math.sqrt(float(total))


class StepGuard:
    """Accept/reject verdicts over a run's step stream.

    * non-finite loss → reject, always;
    * loss > ``spike_factor`` × EWMA(loss) after ``warmup`` accepted
      steps → reject;
    * update_norm > ``spike_factor`` × EWMA(norm) after ``warmup``
      accepted steps → reject (the grad-norm-spike guard; the loop passes
      the norm only when ``track_update_norm`` is set).

    Rejections consume a bounded ``budget``; exceeding it raises
    :class:`GuardExhausted`. EWMAs update on accepted steps only, so an
    anomaly never poisons its own baseline.
    """

    def __init__(self, budget: int = 8, spike_factor: float = 25.0,
                 alpha: float = 0.2, warmup: int = 8,
                 track_update_norm: bool = True, telemetry=None):
        self.budget = budget
        self.spike_factor = spike_factor
        self.alpha = alpha
        self.warmup = warmup
        self.track_update_norm = track_update_norm
        self.rejected = 0
        self.by_reason = {r: 0 for r in REASONS}
        self._accepted = 0
        self._loss_ewma: Optional[float] = None
        self._norm_ewma: Optional[float] = None
        self.telemetry = telemetry

    def state(self) -> dict:
        """EWMA state + per-reason counts (TrainResult.metrics["guard"])."""
        return {"accepted": self._accepted, "rejected": self.rejected,
                "budget": self.budget,
                "loss_ewma": self._loss_ewma, "norm_ewma": self._norm_ewma,
                "by_reason": dict(self.by_reason)}

    def _reject(self, reason: str, detail: str, step: Optional[int]) -> str:
        self.rejected += 1
        self.by_reason[reason] += 1
        log.warning("step guard: rejecting step (%s), %d/%d budget used",
                    detail, self.rejected, self.budget)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            from repro_torch.telemetry import GuardEvent
            tel.emit(GuardEvent(
                step=step if step is not None else -1, reason=reason,
                detail=detail, loss_ewma=self._loss_ewma,
                norm_ewma=self._norm_ewma, rejected=self.rejected,
                budget=self.budget))
            tel.registry.counter(f"guard.reject.{reason}").inc()
            tel.registry.gauge("guard.rejected").set(self.rejected)
        if self.rejected > self.budget:
            raise GuardExhausted(
                f"step guard budget exhausted: {self.rejected} anomalous "
                f"steps rejected (budget {self.budget}); last: {detail}")
        return "reject"

    def observe(self, loss: float, update_norm: Optional[float] = None,
                step: Optional[int] = None) -> str:
        """Returns ``"accept"`` or ``"reject"``; raises on exhausted budget."""
        if not math.isfinite(loss):
            return self._reject("nonfinite_loss",
                                f"non-finite loss {loss}", step)
        if update_norm is not None and not math.isfinite(update_norm):
            return self._reject("nonfinite_norm",
                                f"non-finite update norm {update_norm}", step)
        warmed = self._accepted >= self.warmup
        if (warmed and self._loss_ewma is not None
                and loss > self.spike_factor * self._loss_ewma):
            return self._reject(
                "loss_spike",
                f"loss spike {loss:.4g} > {self.spike_factor:g}x EWMA "
                f"{self._loss_ewma:.4g}", step)
        if (warmed and update_norm is not None
                and self._norm_ewma is not None and self._norm_ewma > 0
                and update_norm > self.spike_factor * self._norm_ewma):
            return self._reject(
                "norm_spike",
                f"update-norm spike {update_norm:.4g} > "
                f"{self.spike_factor:g}x EWMA {self._norm_ewma:.4g}", step)
        # accepted: fold into the baselines
        self._accepted += 1
        a = self.alpha
        self._loss_ewma = (loss if self._loss_ewma is None
                           else (1 - a) * self._loss_ewma + a * loss)
        if update_norm is not None:
            self._norm_ewma = (update_norm if self._norm_ewma is None
                               else (1 - a) * self._norm_ewma
                               + a * update_norm)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.registry.gauge("guard.loss_ewma").set(self._loss_ewma)
            if self._norm_ewma is not None:
                tel.registry.gauge("guard.norm_ewma").set(self._norm_ewma)
        return "accept"
