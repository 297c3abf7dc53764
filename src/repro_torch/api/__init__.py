"""repro_torch.api: ExecutionPolicy, the engine registry, TrainSpec and the
Trainer facade (``repro.api``). ``TrainSpec``, ``build_arg_parser``,
``Trainer`` and ``TrainResult`` resolve lazily (PEP 562), so low-level
modules can import the policy without pulling in the trainer stack."""
from .engines import ENGINES
from .policy import BACKENDS, PLAIN, STRUCTURED, ExecutionPolicy

_LAZY = {"TrainSpec": "spec", "build_arg_parser": "spec", "OPTIMIZERS": "spec",
         "Trainer": "trainer", "TrainResult": "trainer"}

__all__ = ["BACKENDS", "ENGINES", "PLAIN", "STRUCTURED", "ExecutionPolicy",
           *_LAZY]


def __getattr__(name):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.api' has no attribute {name!r}") from None
    import importlib
    return getattr(importlib.import_module(f"repro_torch.api.{module}"), name)
