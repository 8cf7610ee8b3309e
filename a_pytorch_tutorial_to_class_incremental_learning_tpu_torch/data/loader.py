"""Host-side batching: deterministic shuffles and fixed-shape batches.

The same index streams as the JAX package's ``data/loader.py``: train epochs
wrap-pad a seeded permutation to whole batches, eval pads the tail batch with
zero-weight rows, and the herding pass is an unshuffled wrap-padded sweep.
Batches are uint8; augmentation runs on the device (``data/augment.py``).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .scenario import TaskSet


def _epoch_perm(seed: int, n: int) -> np.ndarray:
    return np.random.RandomState(seed & 0x7FFFFFFF).permutation(n)


def _per_process(batch_size: int, process_count: int) -> int:
    per_proc, rem = divmod(batch_size, process_count)
    if rem:
        raise ValueError(
            f"global batch_size {batch_size} is not divisible by "
            f"process_count {process_count}"
        )
    return per_proc


def train_batches(
    task: TaskSet,
    batch_size: int,
    seed: int,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled ``(x uint8, y)`` batches for one epoch; this process's
    ``batch_size // process_count`` stripe of each global batch."""
    n = len(task)
    perm = _epoch_perm(seed, n)
    nb_batches = max(1, -(-n // batch_size))
    padded = np.resize(perm, nb_batches * batch_size)
    per_proc = _per_process(batch_size, process_count)
    for b in range(nb_batches):
        idx = padded[b * batch_size : (b + 1) * batch_size]
        idx = idx[process_index * per_proc : (process_index + 1) * per_proc]
        yield task.x[idx], task.y[idx]


def eval_batches(
    task: TaskSet,
    batch_size: int,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Sequential ``(x, y, weight)`` batches; padding rows carry weight 0."""
    n = len(task)
    per_proc = _per_process(batch_size, process_count)
    nb_batches = -(-n // batch_size)
    for b in range(nb_batches):
        idx = np.arange(b * batch_size, (b + 1) * batch_size)
        w = (idx < n).astype(np.float32)
        idx = np.minimum(idx, n - 1)
        sl = slice(process_index * per_proc, (process_index + 1) * per_proc)
        yield task.x[idx[sl]], task.y[idx[sl]], w[sl]


def sequential_batches(
    task: TaskSet, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Unshuffled full pass for herding; the tail batch is wrap-padded and
    callers cut the result to ``len(task)``."""
    n = len(task)
    nb_batches = -(-n // batch_size)
    idx_all = np.resize(np.arange(n), nb_batches * batch_size)
    for b in range(nb_batches):
        idx = idx_all[b * batch_size : (b + 1) * batch_size]
        yield task.x[idx], task.y[idx]
