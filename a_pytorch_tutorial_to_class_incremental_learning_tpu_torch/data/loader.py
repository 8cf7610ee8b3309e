"""Host-side batching: deterministic shuffles and fixed-shape batches.

The same index streams as the JAX package's ``data/loader.py``: train epochs
wrap-pad a seeded permutation to whole batches, eval pads the tail batch with
zero-weight rows, and the herding pass is an unshuffled wrap-padded sweep.
Pixel batches are uint8, assembled by the native row gather where it
applies (``utils/native.py`` ``gather_rows``, bitwise numpy's
``src[idx]``); a lazy dataset's batches are its paths (numpy indexing),
which the trainer decodes (``datasets.maybe_decode``); augmentation runs
on the device (``data/augment.py``).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..utils.native import gather_rows
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


def index_table(perm: np.ndarray, batch_size: int) -> np.ndarray:
    """A permutation as rows of global batches, ``[nb_steps, batch_size]``,
    wrap-padded to whole batches (``np.resize``, the sampler's
    equalization rule; JAX's fused epoch lays its permutation out alike
    with ``jnp.resize``)."""
    nb_steps = max(1, -(-len(perm) // batch_size))
    return np.resize(perm, (nb_steps, batch_size))


def epoch_index_table(n: int, batch_size: int, seed: int) -> np.ndarray:
    """The epoch's index table: the seeded permutation of ``n`` samples
    as :func:`index_table` rows.  The per-step loader and the fused epoch
    read the same table."""
    return index_table(_epoch_perm(seed, n), batch_size)


def train_batches(
    task: TaskSet,
    batch_size: int,
    seed: int,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled ``(x uint8, y)`` batches for one epoch; this process's
    ``batch_size // process_count`` stripe of each global batch."""
    per_proc = _per_process(batch_size, process_count)
    stripe = slice(process_index * per_proc, (process_index + 1) * per_proc)
    for idx in epoch_index_table(len(task), batch_size, seed):
        idx = idx[stripe]
        yield gather_rows(task.x, idx), task.y[idx]


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
        yield gather_rows(task.x, idx[sl]), task.y[idx[sl]], w[sl]


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
        yield gather_rows(task.x, idx), task.y[idx]
