"""Continual-learning metrics for the ``cil_metrics`` and ``final`` records,
and the epoch records' stall clock."""

from .cil_metrics import (  # noqa: F401
    AccuracyMatrix,
    average_incremental_accuracy,
    backward_transfer,
    per_task_forgetting,
)
from .counters import StallClock  # noqa: F401
