"""Gradient-engine registry (``repro.api.registry``).

An *engine* is one way of producing (loss, LoRA grads), or directly a
parameter update, over the shared model stack: MeSP's structured backward,
its CUDA-kernel form, the paper's §4.3 sequential loop, the MeBP autograd
baseline, the store-h ablation, MeZO's zeroth-order estimates.

Each registration declares what the rest of the port needs to offer it:

* ``build_step``: ``(spec, cfg, opt, policy) -> step(params, opt_state,
  batch) -> (params, opt_state, loss)``, used by the Trainer
  (``api/trainer.py``) and the bare loop of ``launch/train.py``; ``spec``
  is a ``TrainSpec`` (``api/spec.py``), of which ``build_step`` reads
  ``optimizer``, ``lr`` and ``seed``. The step never writes into the
  trees it is given: the step guard's rewind keeps them;
* ``value_and_grad``: ``(params, cfg, batch, *, policy, seed=None) ->
  (loss, grads over the LoRA leaves)``, used by the gradient-quality
  probe (``zo/gradquality.py``); ``seed`` draws a ZO engine's probes;
* ``quantize``: the frozen-base formats it takes.

The reference's ``memsim`` and ``benchmark`` fields belong to its
benchmark harness and are left out. The CLI's ``--engine`` choices come
from this registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Tuple


class UnknownEngineError(KeyError):
    """Raised by :func:`get_engine` for a name with no registration."""


@dataclasses.dataclass(frozen=True)
class Engine:
    """One registered gradient engine (see the module docstring)."""
    name: str
    description: str
    #: ExecutionPolicy backend for engines that differentiate through the
    #: model; None for a custom regime (ZO: forwards only)
    backend: Optional[str]
    #: supported frozen-W0 formats (a subset of core.quant.METHODS)
    quantize: Tuple[str, ...]
    build_step: Callable
    value_and_grad: Optional[Callable] = None
    #: paper section the engine reproduces
    paper: str = ""


_REGISTRY: dict = {}
_BUILTINS_LOADED = False


def _ensure_builtins():
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        importlib.import_module("repro_torch.api.engines")  # self-registers
        # only after a successful import: a failed one must surface its
        # error on every call, not leave an empty registry behind
        _BUILTINS_LOADED = True


def register_engine(name: str, *, description: str, backend: Optional[str],
                    quantize: Tuple[str, ...] = ("none", "int8", "int4",
                                                 "nf4"),
                    value_and_grad=None, paper: str = ""):
    """Decorator over the engine's step-builder; returns it unchanged."""
    def deco(build_step):
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} is already registered")
        _REGISTRY[name] = Engine(
            name=name, description=description, backend=backend,
            quantize=tuple(quantize), build_step=build_step,
            value_and_grad=value_and_grad, paper=paper)
        return build_step

    return deco


def get_engine(name: str) -> Engine:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownEngineError(
            f"unknown engine {name!r}; registered engines: "
            f"{sorted(_REGISTRY)}") from None


def list_engines() -> Tuple[Engine, ...]:
    """All registrations, in registration order."""
    _ensure_builtins()
    return tuple(_REGISTRY.values())


def engine_names() -> Tuple[str, ...]:
    return tuple(e.name for e in list_engines())
