"""The herding feature pass over the task's dataset held on the device
(``engine/train.py`` ``FeatureStep.resident_pass``, ``engine/loop.py``
``_resident_features``), on the CPU, where no CUDA graph is captured:

* its features are bitwise the host-batched eager pass's (one host batch
  at a time, ``data/loader.py`` ``sequential_batches``), cut to the task,
  on a task whose last batch is wrap-padded, augmented and not; so are
  they with a stand-in for the graph that replays the captured region on
  the static buffers, which is how the card runs it;
* a graph is captured again only when the pass's batch shape, mode or
  backbone storage differ from the capture's;
* the trainer's resident copy and a one-off copy of the task give the same
  features;
* one ``augment.draw_params`` call a batch, in batch order, each call's
  tensors after the pass equal to a redraw from the task's herding
  generator (what ``cilbench`` records and checks);
* the trainer's herding reads the held resident copy, eagerly on the CPU,
  and its counters read no capture and no replay.
"""

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import sequential_batches
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.prefetch import to_device
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.scenario import TaskSet
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import CilTrainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import loop
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import create_model, grow
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
    make_generator,
)
from test_torch_checkpoint import _cfg, deadline
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

N, B = 20, 8  # three batches, the last wrap-padded to 24 rows
CPU = torch.device("cpu")
# Crop, flip, RandAugment and erasing: every kind of draw the pass makes.
AUG = taug.AugmentConfig(reprob=0.25)


class _StandInGraph:
    """A captured region on the CPU: each replay runs it again on the
    static buffers it was captured on, as a CUDA graph's replay does."""

    def __init__(self, step, model):
        self.step, self.model = step, model

    def replay(self):
        self.step._out = self.step._features(self.model, self.step._draws)


def _use_stand_in_graph(monkeypatch):
    def capture(self, model):
        self._graph = _StandInGraph(self, model)
        self.captures += 1

    monkeypatch.setattr(tt.FeatureStep, "_capture", capture)


def _model(seed=3):
    model = create_model("resnet20", 10, seed=seed)
    grow(model, jax_random.key(1), 0, 6)
    return model.eval()


def _task(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return TaskSet(rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
                   rng.randint(0, 6, n).astype(np.int64), np.zeros(n, np.int64))


def _host_batched(step, model, task, gen):
    """The pass as the loop ran it before the resident pass: a host batch
    at a time, copied to the device, the eager feature step, the
    features cut to the task."""
    feats = [step(model, torch.from_numpy(xb), gen) for xb, _ in sequential_batches(task, B)]
    return torch.cat(feats)[: len(task)]


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "stand_in_graph"])
@pytest.mark.parametrize("augmented", [True, False], ids=["augmented", "plain"])
def test_resident_pass_is_bitwise_the_host_batched_pass(augmented, graphed, monkeypatch):
    if graphed:
        _use_stand_in_graph(monkeypatch)
    model, task = _model(), _task()
    want = _host_batched(tt.make_feature_step(AUG, augmented), model, task,
                         torch.Generator().manual_seed(7))
    step = tt.make_feature_step(AUG, augmented)
    data_x = torch.from_numpy(task.x)
    for rep in range(2):  # with a graph, the second pass replays every batch
        got = step.resident_pass(model, data_x, N, B, torch.Generator().manual_seed(7), graphed)
        assert got.shape == (N, 64) and torch.equal(got, want), rep
    assert (step.captures, step.replays) == ((1, 5) if graphed else (0, 0))


def test_a_graph_is_captured_again_only_when_the_pass_inputs_differ(monkeypatch):
    _use_stand_in_graph(monkeypatch)
    model, step = _model(), tt.make_feature_step(AUG, True)
    gen = torch.Generator().manual_seed(0)

    def captures(model, n=N, batch=B):
        before = step.captures
        step.resident_pass(model, torch.from_numpy(_task(n).x), n, batch, gen, True)
        return step.captures - before

    assert captures(model) == 1
    assert captures(model) == 0
    assert captures(model, n=N + 5) == 0  # another task's size, the same batch
    with torch.no_grad():  # in place, as SGD and head growth write
        next(model.backbone.parameters()).mul_(0.5)
        next(model.backbone.buffers()).add_(1.0)
    assert captures(model) == 0
    assert captures(model, batch=4) == 1  # another batch shape
    assert captures(model, batch=4) == 0
    p = next(model.backbone.parameters())
    p.data = p.data.clone()  # a restore that rebinds a tensor
    assert captures(model, batch=4) == 1
    assert captures(_model(seed=4), batch=4) == 1  # another backbone


@pytest.fixture(scope="module")
def trainer():
    with deadline(120):
        return CilTrainer(_cfg(batch_size=B, aa="rand-m9-mstd0.5-inc1"), device="cpu")


def _counting_copies(monkeypatch):
    copies = []
    orig = loop.to_device

    def counting(device, *arrays, **kw):
        copies.append(len(arrays))
        return orig(device, *arrays, **kw)

    monkeypatch.setattr(loop, "to_device", counting)
    return copies


def test_resident_copy_and_one_off_copy_give_the_same_features(trainer, monkeypatch):
    task = _task()
    gen = lambda: make_generator(CPU, trainer.config.seed, loop._HERD_STREAM, 0)  # noqa: E731
    resident = to_device(CPU, task.x, task.y)
    copies = _counting_copies(monkeypatch)
    held = trainer._resident_features(0, task, (task, resident), gen())
    assert copies == []  # the resident copy is read, not made again
    copied = trainer._resident_features(0, task, None, gen())
    assert copies == [1]  # one copy of the pixels, not one a batch
    other = _task()  # equal arrays, another task object: not its resident copy
    assert torch.equal(trainer._resident_features(0, task, (other, resident), gen()), held)
    assert copies == [1, 1]
    assert torch.equal(held, copied)
    assert torch.equal(held, trainer._batched_features(0, task, gen()))


def test_update_memory_on_uint8_pixels_reads_the_held_resident_copy(trainer, monkeypatch):
    """The trainer's herding on the CPU takes the resident pass for uint8
    pixels, eagerly: it reads the dataset ``_fit_task`` held, drops it,
    copies nothing, captures and replays no graph, and hands the host
    greedy the host-batched pass's features."""
    task = _task()
    want = trainer._batched_features(
        0, task, make_generator(CPU, trainer.config.seed, loop._HERD_STREAM, 0)).numpy()
    added = []
    monkeypatch.setattr(trainer.memory, "add", lambda *a: added.append(a))
    monkeypatch.setattr(trainer, "_batched_features", None)  # never called
    copies = _counting_copies(monkeypatch)
    trainer._herd_resident = (task, to_device(CPU, task.x, task.y))
    trainer._update_memory(0, task)
    assert copies == [] and trainer._herd_resident is None
    assert len(added) == 1 and np.array_equal(added[0][-1], want)
    assert trainer.feature_step.captures == trainer.feature_step.replays == 0
    counters = trainer.telemetry.metrics.snapshot()["counters"]
    assert counters["herd_graph_captures_total"] == counters["herd_graph_replays_total"] == 0


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "stand_in_graph"])
def test_one_draw_params_call_a_batch_left_as_drawn(graphed, monkeypatch):
    """The benchmark's contract (``cilbench/drivers/protocol.py``
    ``_feature_gaps``): ``ceil(n / B)`` calls in batch order, each call's
    tensors after the whole pass equal to a redraw from the task's
    herding generator; a later batch never writes into an earlier one's."""
    if graphed:
        _use_stand_in_graph(monkeypatch)
    orig, drawn = taug.draw_params, []

    def recording(*a, **k):
        d = orig(*a, **k)
        drawn.append({f: t for f, t in vars(d).items() if t is not None})
        return d

    monkeypatch.setattr(taug, "draw_params", recording)
    model, task = _model(), _task()
    step = tt.make_feature_step(AUG, True)
    seed = 2**31 + 12345
    for rep in range(2):
        drawn.clear()
        step.resident_pass(model, torch.from_numpy(task.x), N, B,
                           make_generator(CPU, seed, loop._HERD_STREAM, 3), graphed)
        assert len(drawn) == -(-N // B) == 3
        redraw = make_generator(CPU, seed, loop._HERD_STREAM, 3)
        for d in drawn:
            want = orig(B, AUG, redraw, (32, 32, 3))
            assert d.keys() == {f for f, t in vars(want).items() if t is not None}
            assert all(torch.equal(t, getattr(want, f)) for f, t in d.items())
