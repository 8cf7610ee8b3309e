"""Whole runs on the CPU: the fused epoch against the per-step loop, the
prefetcher on the per-step path, and the next-task warm ring.

One 3-task ``synthetic10`` recipe (resnet20, batch 16, one epoch a task, so
task 1's and task 2's last batches wrap), five runs:

* fused (the default) and ``--no_fused_epochs`` end bitwise equal: every
  ``state_dict`` tensor, acc1s, γ, the matrix and every epoch metric;
* the per-step path at ``--prefetch_depth 2``, with a ``producer_die`` on
  its producer thread, ends bitwise equal to depth 0 and logs one
  ``prefetch_degraded``;
* the fused path at ``--prefetch_depth 1`` warms each next task's dataset:
  two ``prefetch_warm`` hits, and bitwise the unwarmed run;
* a ring armed with another memory misses (``content_mismatch``), copies
  synchronously and still ends bitwise equal to the unwarmed run.
"""

import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from test_torch_checkpoint import _records, deadline
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

TEST_LIMIT_S = 120
CLI = ["--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "4", "--increment",
       "3", "--backbone", "resnet20", "--batch_size", "16", "--num_epochs", "1",
       "--memory_size", "20", "--aa", "none", "--color_jitter", "0", "--eval_every_epoch",
       "100", "--seed", "4"]


@pytest.fixture(autouse=True)
def _limit():
    with deadline(TEST_LIMIT_S):
        yield


def _run(tmp_path, name, *flags, patch=None):
    log = str(tmp_path / f"{name}.jsonl")
    trainer = build_trainer([*CLI, *flags, "--log_file", log])
    if patch is not None:
        patch(trainer)
    result = trainer.fit()
    assert trainer._task_warm is None
    return {"result": result, "log": _records(log), "global_step": trainer.global_step,
            "state": {k: v.clone() for k, v in trainer.state.model.state_dict().items()},
            "momentum": [m.clone() for m in trainer.state.momentum],
            "captures": trainer.epoch_fn.captures}


def _of(run, kind):
    return [r for r in run["log"] if r["type"] == kind]


def _assert_same_run(a, b):
    assert a["global_step"] == b["global_step"] > 0
    assert a["result"]["acc1s"] == b["result"]["acc1s"]
    assert a["result"]["acc_matrix"] == b["result"]["acc_matrix"]
    assert [r["gamma"] for r in _of(a, "task")] == [r["gamma"] for r in _of(b, "task")]
    for key in ("steps", "loss", "ce", "kd", "acc1", "acc5"):
        assert [r[key] for r in _of(a, "epoch")] == [r[key] for r in _of(b, "epoch")], key
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))


@pytest.fixture(scope="module")
def unwarmed(tmp_path_factory):
    with deadline(TEST_LIMIT_S):  # one intra-op thread, as the tests' runs
        return _run(tmp_path_factory.mktemp("unwarmed"), "fused")


@pytest.fixture(scope="module")
def per_step(tmp_path_factory):
    with deadline(TEST_LIMIT_S):
        return _run(tmp_path_factory.mktemp("per_step"), "steps0", "--no_fused_epochs")


def test_fused_equals_per_step_bitwise(unwarmed, per_step):
    _assert_same_run(unwarmed, per_step)
    assert all(r["fused"] and not r["graphed"] for r in _of(unwarmed, "epoch"))
    assert not any(r["fused"] or r["graphed"] for r in _of(per_step, "epoch"))
    assert unwarmed["captures"] == 0  # the CPU runs the fused epoch eagerly
    assert [r["gamma"] for r in _of(unwarmed, "task")][1] > 0


def test_per_step_path_at_depth_2_equals_depth_0(per_step, tmp_path):
    depth2 = _run(tmp_path, "steps2", "--no_fused_epochs", "--prefetch_depth", "2",
                  "--fault_spec", "producer_die@task1.epoch1.step3")
    _assert_same_run(depth2, per_step)
    degraded = _of(depth2, "prefetch_degraded")
    assert [(r["where"], r["task_id"], r["epoch"]) for r in degraded] == [("train", 1, 1)]
    assert "FaultInjected" in degraded[0]["error"]
    epochs = _of(depth2, "epoch")
    assert all(r["prefetch_depth"] == 2 and 0 <= r["prefetch_depth_occupancy"] <= 1
               and not r["fused"] for r in epochs)
    assert not any("prefetch_depth" in r for r in _of(per_step, "epoch"))


def test_warm_ring_hits_each_next_task(unwarmed, tmp_path):
    warmed = _run(tmp_path, "warm", "--prefetch_depth", "1")
    _assert_same_run(warmed, unwarmed)
    warm = _of(warmed, "prefetch_warm")
    assert [(r["task_id"], r["hit"]) for r in warm] == [(1, True), (2, True)]
    assert all(r["bytes"] > 0 and r["warm_s"] >= r["wait_s"] >= 0 for r in warm)
    assert not _of(unwarmed, "prefetch_warm")


def test_warm_ring_miss_on_a_changed_memory(unwarmed, tmp_path):
    def arm_with_another_memory(trainer):
        """Arm task 1's ring while the memory reads one exemplar short."""
        warm, get = trainer._warm_next_task, trainer.memory.get

        def changed():
            x, y, t = get()
            return x[1:], y[1:], t[1:]

        def arm(task_id):
            trainer.memory.get = changed if task_id == 0 else get
            try:
                warm(task_id)
            finally:
                trainer.memory.get = get

        trainer._warm_next_task = arm

    missed = _run(tmp_path, "miss", "--prefetch_depth", "1", patch=arm_with_another_memory)
    _assert_same_run(missed, unwarmed)
    warm = _of(missed, "prefetch_warm")
    assert [(r["task_id"], r["hit"], r.get("reason")) for r in warm] == [
        (1, False, "content_mismatch"), (2, True, None)]
