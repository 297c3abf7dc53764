from .engines import ENGINES
from .policy import BACKENDS, PLAIN, STRUCTURED, ExecutionPolicy

__all__ = ["BACKENDS", "ENGINES", "PLAIN", "STRUCTURED", "ExecutionPolicy"]
