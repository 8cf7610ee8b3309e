"""Class-incremental metrics from the task x task accuracy matrix.

Counterpart of the JAX package's ``telemetry/cil_metrics.py``: row ``t`` is
the per-slice top-1 after task ``t``.  Average incremental accuracy is the
mean cumulative top-1 over tasks; forgetting of slice ``j`` is its best
earlier accuracy minus its final one; BWT is the mean of final minus
diagonal accuracy over ``j < T-1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def average_incremental_accuracy(acc1s: Sequence[float]) -> float:
    return float(sum(acc1s) / len(acc1s)) if acc1s else 0.0


def per_task_forgetting(matrix: Sequence[Sequence[float]]) -> Optional[List[float]]:
    T = len(matrix)
    if T < 2 or any(len(matrix[t]) != t + 1 for t in range(T)):
        return None
    final = matrix[T - 1]
    return [
        round(max(matrix[t][j] for t in range(j, T - 1)) - final[j], 5)
        for j in range(T - 1)
    ]


def backward_transfer(matrix: Sequence[Sequence[float]]) -> Optional[float]:
    T = len(matrix)
    if T < 2 or any(len(matrix[t]) != t + 1 for t in range(T)):
        return None
    final = matrix[T - 1]
    return round(
        sum(final[j] - matrix[j][j] for j in range(T - 1)) / (T - 1), 5
    )


class AccuracyMatrix:
    """Lower-triangular task x task accuracy matrix, built row by row."""

    def __init__(self):
        self.rows: Dict[int, List[float]] = {}

    def add_row(self, task_id: int, acc_per_task: Sequence[float]) -> None:
        if len(acc_per_task) != task_id + 1:
            raise ValueError(
                f"row for task {task_id} must have {task_id + 1} slice "
                f"accuracies, got {len(acc_per_task)}"
            )
        self.rows[task_id] = [float(a) for a in acc_per_task]

    @property
    def complete(self) -> bool:
        return bool(self.rows) and sorted(self.rows) == list(
            range(max(self.rows) + 1)
        )

    def as_list(self) -> List[List[float]]:
        return [self.rows[t] for t in sorted(self.rows)]

    def summary(self) -> dict:
        if not self.complete:
            return {"partial": True, "tasks": sorted(self.rows)}
        m = self.as_list()
        return {
            "nb_tasks": len(m),
            "forgetting": per_task_forgetting(m),
            "bwt": backward_transfer(m),
        }
