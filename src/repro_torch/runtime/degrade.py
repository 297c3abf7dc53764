"""Memory-pressure degradation ladder: keep training when the device shrinks
(``repro.runtime.degrade``).

On a phone the memory budget is not a constant — the OS reclaims pages as
other apps wake, and the correct response to an OOM mid-run is usually not
"retry the identical program" (it will OOM again) but "retry a cheaper
program". This module walks the :class:`~repro_torch.api.spec.TrainSpec`
space the engine registry already defines, rung by rung, most-reversible
first, in the reference's order:

1. **halve the batch** (repeats until ``min_batch``) — linear activation
   savings, zero effect on the per-example gradient;
2. **engine step-down** — ``mesp_cuda → mesp → mesp_seq`` (the paper's
   §4.3 sequential loop: per-block immediate updates, the leanest retained
   set; requires the dense family + SGD, validated before the switch). On
   a CUDA device ``mesp_cuda`` has no step-down: ``mesp`` and ``mesp_seq``
   run the plain structured backend, which would take the hand-written
   kernels off the card and frees nothing there (over a quantized base it
   dequantizes W0 in the step and raises the peak), so the card goes from
   the batch rung straight to the quantize rungs;
3. **quantize the frozen base to int8** — halves resident W0, LoRA factors
   and therefore gradients are untouched;
4. **re-quantize int8 → packed int4** — halves resident W0 again; only
   offered once the int8 rung is already in effect, so quantization error is
   added one notch at a time;
5. **halve the sequence length** (repeats until ``min_seq``) — last resort,
   it changes the token windows the run sees.

Every candidate rung is validated against the registry
(``TrainSpec.validate`` — the engine must support the resulting quantize
combo) before it is offered. The reference also skips a rung that its
analytical memory model (``benchmarks/memsim.py``) says does not reduce the
predicted peak; the port has no such model yet (it comes with the port's
benchmark), so every registry-valid rung is offered, as the reference does
when memsim is absent. The Trainer applies the first rung that also
*builds* (e.g. ``mesp_seq`` refuses non-SGD optimizers at build time).

Under a model axis the quantize rungs quantize each rank's shards in
place (``quant.quantize_frozen_`` with the Trainer's ``absmax_reducer``):
a row-parallel shard's per-column absmax covers only its rows, so it is
all-reduced (MAX) over the model axis first, and the codes and scales
are the single process's, sliced. A packed rung whose row-parallel shard
would hold an odd number of rows is refused by ``TrainSpec.validate``
(two rows share a byte; nothing is padded), so the ladder skips it.

Optimizer state carries across compatible transitions: batch/seq/engine
rungs leave the param tree untouched, so the state carries verbatim; the
quantize rungs rewrite frozen ``w`` leaves into format dicts, and
:func:`carry_opt_state` re-maps the state tree by parameter path so the
trained LoRA moments survive while frozen-slot entries stay ``None``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, Tuple

from repro_torch.tree import leaves_with_paths, path_str, tree_map_with_path

log = logging.getLogger("repro_torch.degrade")

#: engine step-downs, leanest-retained-set direction
ENGINE_LADDER = {"mesp_cuda": "mesp", "mesp": "mesp_seq"}
#: engines that keep their place on a CUDA device: the step-down would
#: trade the hand-written kernels for the plain path
KERNEL_ENGINES = ("mesp_cuda",)


class LadderExhausted(RuntimeError):
    """No rung left: the spec is already at the floor of the ladder."""


def _flatten_paths(tree) -> dict:
    """{path: leaf} over nested dicts/lists, ``None`` leaves included."""
    return {path_str(p): x
            for p, x in leaves_with_paths(tree, keep_none=True)}


def _map_paths(tree, fn):
    return tree_map_with_path(lambda p, _: fn(path_str(p)), tree)


def carry_opt_state(opt_state, old_params, new_params):
    """Re-map an optimizer state dict onto a transformed param tree.

    Scalars (``step``) copy through; tree-valued entries (momentum ``m``,
    Adam ``m``/``v``) are rebuilt on ``new_params``'s structure with each
    leaf taken from the same parameter path in the old tree, or ``None``
    where the path is new (e.g. the ``{"q","scale"}`` leaves the int8 rung
    introduces — frozen slots carry no state anyway)."""
    if not isinstance(opt_state, dict):
        return opt_state
    out = {}
    for key, val in opt_state.items():
        if not isinstance(val, (dict, list, tuple)):
            out[key] = val
            continue
        old = _flatten_paths(val)
        out[key] = _map_paths(new_params, old.get)
    return out


class WatermarkTrigger:
    """Proactive memory-pressure signal from measured watermarks.

    The OOM-exception path reacts *after* the allocator fails; with telemetry
    on, the resilient loop also samples the live watermark
    (``telemetry.memwatch``) after each step and feeds it here.  Once the
    measured residency stays above ``threshold × budget_mb`` for
    ``consecutive`` samples, :meth:`observe` returns True and the loop walks
    the same ladder *before* the device actually OOMs.  ``consecutive`` is
    the hysteresis: one transient spike (a checkpoint buffer, a first
    step's workspaces) must not cost a rung.
    """

    def __init__(self, budget_mb: float, *, threshold: float = 0.9,
                 consecutive: int = 2):
        if budget_mb <= 0:
            raise ValueError(f"budget_mb must be > 0, got {budget_mb}")
        self.budget_mb = budget_mb
        self.threshold = threshold
        self.consecutive = consecutive
        self.trips = 0
        self._over_streak = 0

    @property
    def limit_mb(self) -> float:
        return self.threshold * self.budget_mb

    def observe(self, measured_mb: float) -> bool:
        """Feed one watermark sample; True = degrade now."""
        if measured_mb >= self.limit_mb:
            self._over_streak += 1
        else:
            self._over_streak = 0
        if self._over_streak >= self.consecutive:
            self.trips += 1
            self._over_streak = 0   # re-arm after the rung lands
            return True
        return False

    def reset(self) -> None:
        self._over_streak = 0


class DegradationLadder:
    """Yields validated degraded specs for a spec under memory pressure."""

    def __init__(self, *, min_batch: int = 1, min_seq: int = 32):
        self.min_batch = min_batch
        self.min_seq = min_seq
        self.applied: list = []     # rung names, in application order

    # ------------------------------------------------------------ raw rungs
    def _raw_candidates(self, spec) -> Iterator[Tuple[object, str]]:
        if spec.batch > self.min_batch:
            yield (dataclasses.replace(spec, batch=spec.batch // 2),
                   "halve_batch")
        nxt = ENGINE_LADDER.get(spec.engine)
        if nxt is not None and not (spec.device == "cuda"
                                    and spec.engine in KERNEL_ENGINES):
            yield dataclasses.replace(spec, engine=nxt), f"engine_{nxt}"
        if spec.quantize == "none":
            yield (dataclasses.replace(spec, quantize="int8"),
                   "quantize_int8")
        if spec.quantize == "int8":
            # one notch at a time: the packed rung halves resident W0 again
            yield (dataclasses.replace(spec, quantize="int4"),
                   "quantize_int4")
        if spec.seq > self.min_seq:
            yield (dataclasses.replace(spec, seq=max(self.min_seq,
                                                     spec.seq // 2)),
                   "truncate_seq")

    # ------------------------------------------------------------ validated
    def candidates(self, spec) -> Iterator[Tuple[object, str]]:
        """Registry-validated rungs, in ladder order. The caller (Trainer)
        applies the first one whose step also builds."""
        any_yielded = False
        for cand, rung in self._raw_candidates(spec):
            try:
                cand.validate()
            except Exception as e:
                log.debug("rung %s rejected by registry: %s", rung, e)
                continue
            any_yielded = True
            yield cand, rung
        if not any_yielded:
            raise LadderExhausted(
                f"degradation ladder exhausted at engine={spec.engine!r} "
                f"batch={spec.batch} seq={spec.seq} "
                f"quantize={spec.quantize!r}")

    def record(self, rung: str) -> None:
        self.applied.append(rung)
