"""``DevicePrefetcher`` on the CPU, held to the JAX package's contract (its
``data/prefetch.py``): the same stream at every depth, a source error
re-raised in the consumer, a placement failure degraded to the synchronous
path with the stream unchanged, and a ``close()`` that joins the producer,
also after an early exit.  The trainer's use of it is in
``tests/test_torch_fused_runs.py``.
"""

import threading

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.prefetch import (
    DevicePrefetcher,
    to_device,
)
from test_torch_checkpoint import deadline
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

TEST_LIMIT_S = 120
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _limit():
    with deadline(TEST_LIMIT_S):
        yield


def _source(n=7):
    rng = np.random.RandomState(0)
    for i in range(n):
        yield rng.randint(0, 256, (4, 2, 2, 3)).astype(np.uint8), np.full(4, i)


def _place(batch):
    return to_device(CPU, *batch, pinned=True)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_stream_is_identical_at_every_depth(depth):
    want = list(_source())
    with DevicePrefetcher(_source(), _place, depth) as pf:
        got = list(pf)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert torch.equal(gx, torch.from_numpy(wx)) and torch.equal(gy, torch.from_numpy(wy))
    assert not pf.alive and pf.stats()["prefetch_depth"] == depth


def test_source_error_is_reraised_in_the_consumer():
    def broken():
        yield from _source(2)
        raise ValueError("source broke")

    got = []
    with pytest.raises(ValueError, match="source broke"):
        with DevicePrefetcher(broken(), _place, 2) as pf:
            for batch in pf:
                got.append(batch)
    assert len(got) == 2 and not pf.alive


def test_placement_failure_degrades_and_keeps_the_stream():
    calls, seen = {"n": 0}, []

    def flaky(batch):
        calls["n"] += 1
        if calls["n"] == 3 and threading.current_thread() is not threading.main_thread():
            raise RuntimeError("producer died")
        return _place(batch)

    with DevicePrefetcher(_source(), flaky, 2, on_degrade=seen.append) as pf:
        got = [y for _, y in pf]
    assert [int(y[0]) for y in got] == list(range(7))
    assert len(seen) == 1 and "producer died" in repr(seen[0])
    assert pf.stats()["prefetch_degraded"] == 1 and not pf.alive


def test_close_joins_the_thread_after_an_early_exit():
    def endless():
        i = 0
        while True:
            yield np.zeros(3), np.full(1, i)
            i += 1

    with DevicePrefetcher(endless(), _place, 3) as pf:
        first = next(pf)
        assert pf.alive
    assert int(first[1][0]) == 0 and not pf.alive
    pf.close()  # idempotent
    with pytest.raises(StopIteration):
        next(pf)
