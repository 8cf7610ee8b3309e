"""Each driver runs a second on the CPU (the kernels' plain versions) and
comes out correct; with the timed path broken underneath, the same run
comes out not correct.  The faults: a step that leaves the state
unchanged, a step over half the batch (the mean over the rest), an
augmentation altered where it is made, and at the task boundaries a
herding, an alignment, an evaluation or a feature pass gone wrong."""

import pytest
import torch

from cilbench.tests.small import run_small

PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SECONDS = {}


@pytest.mark.parametrize("cell", ["c100-epochs", "c100-protocol"])
def test_cell_runs_and_is_correct(cell):
    res = run_small(cell, seconds=SECONDS.get(cell, 1.0))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert list(res)[-2:] == ["checks", "_log"] or list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["c100-epochs", "c100-protocol"])
def test_trace_run_reads_counters(cell):
    res = run_small(cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    if cell == "c100-protocol":
        assert res["metrics"]["eval_s_per_task"]["value"] > 0
        assert res["metrics"]["herd_s_per_task"]["value"] > 0
    # a CPU run has no device activity: no device metric is written
    assert not any(k.startswith(("idle_share", "ce_roofline")) for k in res["metrics"])


def test_window_holds_whole_loop_turns(monkeypatch):
    """The epochs window is the trainer's own loop: it opens after the
    capture epoch, and each epoch in it runs the loop's tail (the epoch
    record, the checkpoint hook) before the next one starts."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import loop

    hooks = []
    orig = loop.CilTrainer._save_epoch_checkpoint
    monkeypatch.setattr(loop.CilTrainer, "_save_epoch_checkpoint",
                        lambda self, *a: hooks.append(a) or orig(self, *a))
    res = run_small("c100-epochs", seconds=0.0)
    assert res["correct"], res["checks"]
    assert res["_log"]["epochs"] == 1 and res["attempted"] > 0
    assert [a[1] for a in hooks] == [2, 3]  # the capture epoch's, then the window's


def _half_batch(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train

    orig = train.train_step_on_batch

    def half(state, teacher, x, labels, *a, **k):
        h = x.shape[0] // 2
        return orig(state, teacher, x[:h], labels[:h], *a, **k)

    monkeypatch.setattr(train, "train_step_on_batch", half)


def _state_unchanged(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train

    monkeypatch.setattr(train, "sgd_update", lambda *a, **k: None)


def _altered_augmentation(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment

    orig = augment.rand_augment

    def brighter(img, *a, **k):
        return augment.round_u8(orig(img, *a, **k) + 1.0)  # one level brighter

    monkeypatch.setattr(augment, "rand_augment", brighter)


@pytest.mark.parametrize("cell", ["c100-epochs", "c100-protocol"])
@pytest.mark.parametrize("fault", [_half_batch, _state_unchanged, _altered_augmentation],
                         ids=["half_batch", "unchanged", "augmentation"])
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(cell, seconds=SECONDS.get(cell, 1.0))
    assert not res["correct"], res["checks"]


def _random_herding(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import memory

    monkeypatch.setitem(memory._METHODS, "barycenter",
                        lambda f, nb: memory.herd_random(f, nb, seed=1))


def _no_alignment(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import loop

    monkeypatch.setattr(loop, "align", lambda model, known, nb_new: 1.0)


def _eval_off_by_one(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import loop

    orig = loop.CilTrainer._eval_totals_device

    def shifted(self, dataset_val):
        out = orig(self, dataset_val).clone()
        out[1] += 1.0  # one more image counted right than was
        return out

    monkeypatch.setattr(loop.CilTrainer, "_eval_totals_device", shifted)


def _unaugmented_features(monkeypatch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import loop

    orig = loop.make_feature_step
    monkeypatch.setattr(loop, "make_feature_step", lambda cfg, augmented: orig(cfg, False))


@pytest.mark.parametrize("fault", [_random_herding, _no_alignment, _eval_off_by_one,
                                   _unaugmented_features],
                         ids=["random_herding", "no_alignment", "eval_off_by_one",
                              "unaugmented_features"])
def test_protocol_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_small("c100-protocol")
    assert not res["correct"], res["checks"]
