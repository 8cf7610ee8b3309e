"""Class-incremental scenario: task splitting with class-order label remapping.

numpy only; the same splits as the JAX package's ``data/scenario.py``.  Labels
are remapped to each class's position in ``class_order``, so a task's classes
occupy a contiguous label range above every earlier task's: the invariant the
masked head, the KD slice ``[:known]`` and weight alignment rely on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import compute_increments


@dataclass
class TaskSet:
    """One task's data: ``(x uint8 [N,H,W,C], y int64 remapped, t int64)``."""

    x: np.ndarray
    y: np.ndarray
    t: np.ndarray

    def __len__(self) -> int:
        return len(self.y)

    def add_samples(self, x: np.ndarray, y: np.ndarray, t: Optional[np.ndarray]) -> None:
        """Rehearsal injection: append exemplars in place."""
        self.x = np.concatenate([self.x, x])
        self.y = np.concatenate([self.y, np.asarray(y, self.y.dtype)])
        if t is None:
            t = np.full(len(y), -1, self.t.dtype)
        self.t = np.concatenate([self.t, np.asarray(t, self.t.dtype)])

    def get_raw_samples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.x, self.y, self.t

    @property
    def nb_classes(self) -> int:
        return len(np.unique(self.y))


class ClassIncremental:
    """Task-partitioned view of a labeled dataset; ``scenario[t]`` is task
    ``t`` and ``scenario[:t+1]`` the union of the first ``t+1`` tasks."""

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        initial_increment: int,
        increment: int,
        class_order: Optional[Sequence[int]] = None,
    ):
        y = np.asarray(y, np.int64)
        self.nb_classes = int(y.max()) + 1
        if class_order is None:
            class_order = list(range(self.nb_classes))
        order = np.asarray(class_order, np.int64)
        if sorted(order.tolist()) != list(range(self.nb_classes)):
            raise ValueError("class_order must be a permutation of the class labels")
        self.class_order = order

        remap = np.empty(self.nb_classes, np.int64)
        remap[order] = np.arange(self.nb_classes)
        self._x = x
        self._y_remapped = remap[y]

        self._increments: List[int] = list(
            compute_increments(self.nb_classes, initial_increment, increment)
        )

    def increments(self) -> List[int]:
        return list(self._increments)

    def __len__(self) -> int:
        return len(self._increments)

    def _task_bounds(self, task_id: int) -> Tuple[int, int]:
        lo = sum(self._increments[:task_id])
        return lo, lo + self._increments[task_id]

    def _slice(self, lo_class: int, hi_class: int) -> TaskSet:
        sel = (self._y_remapped >= lo_class) & (self._y_remapped < hi_class)
        y = self._y_remapped[sel]
        bounds = np.cumsum([0] + self._increments)
        t = np.searchsorted(bounds, y, side="right") - 1
        return TaskSet(self._x[sel].copy(), y.copy(), t.astype(np.int64))

    def __getitem__(self, index):
        if isinstance(index, slice):
            tasks = range(*index.indices(len(self)))
            if len(tasks) == 0:
                raise IndexError("empty task slice")
            lo, _ = self._task_bounds(tasks[0])
            _, hi = self._task_bounds(tasks[-1])
            return self._slice(lo, hi)
        lo, hi = self._task_bounds(index)
        return self._slice(lo, hi)

    def __iter__(self):
        for t in range(len(self)):
            yield self[t]
