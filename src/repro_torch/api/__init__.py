from .policy import BACKENDS, STRUCTURED, ExecutionPolicy

__all__ = ["BACKENDS", "STRUCTURED", "ExecutionPolicy"]
