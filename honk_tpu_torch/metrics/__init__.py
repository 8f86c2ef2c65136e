from .logging import MetricsLogger
from .profiling import annotate, trace_to

__all__ = ["MetricsLogger", "annotate", "trace_to"]
