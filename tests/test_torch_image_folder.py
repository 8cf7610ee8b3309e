"""The image-folder dataset (``--data_set imagenet1000``) through the port,
against the JAX package on the same trees.

* ``load_image_folder`` and ``decode_image_batch`` (train at seeds 0-3, and
  eval; at 40 and 224 px) are bitwise the JAX package's, whose pixels come
  from Pillow; ``maybe_decode`` passes pixels through.
* A 2-task run of the CLI's trainer on a JAX-style PNG/JPEG tree at
  ``--input_size 40`` with resnet20 (JAX's ``test_image_folder_end_to_end``):
  every epoch is per-step, the memory holds paths, the train batch at
  (task 0, epoch 0, step 0) is JAX's ``maybe_decode`` with JAX's seed, a
  resume from the task-0 checkpoint ends bitwise equal to the run, the
  memory of paths round-trips through both checkpoint backends, and the
  exported artifacts' skew check reads the val paths.
* The same run at ``--prefetch_depth 2`` decodes on the producer threads
  and is bitwise the depth-0 run; the epochs' ``host_s`` holds only the
  wait the producer does not hide.
* Two gloo ranks under ``--check_lockstep`` on the tree raise no
  ``fingerprint_mismatch``: a path batch's digest is over its paths.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import datasets as jds
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import datasets as tds
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.loop import CilTrainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import checkpoint as ckpt
from test_torch_dist import one_intra_op_thread, spawn_ranks  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "images")
SEED = 3


def _write_tree(root, per_train=8, per_val=3, classes=4):
    """JAX's end-to-end tree: 48x40 images of distinct mean colours, here
    PNG and JPEG alternating."""
    rng = np.random.RandomState(0)
    for split, per in (("train", per_train), ("val", per_val)):
        for c in range(classes):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            base = np.zeros((48, 40, 3), np.float32)
            base[..., c % 3] = 200.0
            for i in range(per):
                arr = np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)
                if i % 2:
                    Image.fromarray(arr).save(d / f"{i}.png")
                else:
                    Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("tree"))


def _argv(data_path, *extra):
    return ["--platform", "cpu", "--data_set", "imagenet1000", "--data_path", str(data_path),
            "--input_size", "40", "--num_bases", "0", "--increment", "2",
            "--backbone", "resnet20", "--batch_size", "4", "--num_epochs", "2",
            "--eval_every_epoch", "100", "--memory_size", "8", "--aa", "none",
            "--color_jitter", "0", "--seed", str(SEED), *extra]


def _records(path, kind=None):
    recs = [json.loads(ln) for ln in open(path)]
    return [r for r in recs if kind is None or r["type"] == kind]


@pytest.fixture(scope="module")
def twin(tree, tmp_path_factory):
    """The run: task checkpoints, per-task artifacts with the skew check;
    the loop's decodes are recorded."""
    d = tmp_path_factory.mktemp("twin")
    calls = []
    decode = CilTrainer._decode

    def recording(self, x, train, seed):
        out = decode(self, x, train, seed)
        calls.append({"x": np.array(x), "train": train, "seed": seed, "out": out,
                      "thread": threading.current_thread().name})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CilTrainer, "_decode", recording)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            trainer = build_trainer(_argv(
                tree, "--ckpt_dir", str(d / "ckpt"), "--log_file", str(d / "run.jsonl"),
                "--export_dir", str(d / "export"), "--serve_skew_check",
                "--serve_buckets", "8"))
            result = trainer.fit()
        finally:
            torch.set_num_threads(threads)
    return {"trainer": trainer, "result": result, "dir": d, "calls": calls,
            "log": str(d / "run.jsonl")}


def test_load_image_folder_matches_jax(tree):
    for train in (True, False):
        px, py = tds.load_image_folder(str(tree), train)
        jx, jy = jds.load_image_folder(str(tree), train)
        assert px.dtype == object and py.dtype == np.int64
        assert px.tolist() == jx.tolist() and np.array_equal(py, jy)
    (x, y), n = tds.build_raw_dataset("imagenet1000", str(tree), True)
    assert n == 4 and len(x) == 32 and y.tolist() == sorted(y.tolist())
    with pytest.raises(FileNotFoundError, match="split not found"):
        tds.load_image_folder(str(tree / "nowhere"), True)


FIXTURE_PATHS = np.asarray(sorted(
    os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)
    if f.lower().endswith((".jpg", ".jpeg", ".png"))), object)


@pytest.mark.parametrize("size", [40, 224])
@pytest.mark.parametrize("train,seed", [(True, 0), (True, 1), (True, 2), (True, 3), (False, 0)],
                         ids=["train0", "train1", "train2", "train3", "eval"])
def test_decode_image_batch_matches_jax(train, seed, size):
    """Every fixture (ImageNet sizes, each sampling, progressive, gray,
    CMYK, PNGs) in one batch: bitwise JAX's PIL pipeline."""
    want = jds.decode_image_batch(FIXTURE_PATHS, size, train, seed)
    got = tds.decode_image_batch(FIXTURE_PATHS, size, train, seed)
    assert got.shape == (len(FIXTURE_PATHS), size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_maybe_decode_passes_pixels_and_decodes_paths():
    pix = np.zeros((2, 8, 8, 3), np.uint8)
    assert tds.maybe_decode(pix, 8, True) is pix
    paths = FIXTURE_PATHS[:3]
    np.testing.assert_array_equal(tds.maybe_decode(paths, 32, False),
                                  jds.maybe_decode(paths, 32, False))


def test_run_is_per_step_and_memory_holds_paths(twin):
    result, trainer = twin["result"], twin["trainer"]
    assert result["nb_tasks"] == 2 and len(result["acc1s"]) == 2
    epochs = _records(twin["log"], "epoch")
    assert len(epochs) == 4
    assert all(r["fused"] is False and r["graphed"] is False and r["steps"] > 0 for r in epochs)
    assert all(np.isfinite(r["loss"]) for r in epochs)
    mx, my, _mt = trainer.memory.get()
    assert mx.dtype == object and len(mx) == 8
    assert all(os.path.isfile(p) for p in mx)
    assert {os.path.basename(os.path.dirname(p)) for p in mx} == {f"class{c}" for c in range(4)}
    # The three decode sites, with JAX's seeds: train at the shuffle seed
    # plus the step, eval at 0, herding (augmented) at the batch index.
    calls = twin["calls"]
    assert all(c["x"].dtype == object for c in calls)
    assert {c["seed"] for c in calls if not c["train"]} == {0}
    herd = [c["seed"] for c in calls if c["train"] and c["seed"] < 1000]
    assert herd == [0, 1, 2, 3] + [0, 1, 2, 3, 4, 5]  # 16 samples, then 16 + 8 exemplars
    train = [c["seed"] for c in calls if c["train"] and c["seed"] >= 1000]
    assert len(train) == sum(r["steps"] for r in epochs)


def test_first_train_batch_is_jax_decode(twin):
    """The batch the loop decoded at (task 0, epoch 0, step 0) is JAX's
    ``maybe_decode`` of the same paths with JAX's seed
    (``hash((seed, task, epoch)) & 0x7FFFFFFF`` plus the step)."""
    first = next(c for c in twin["calls"] if c["train"] and len(c["x"]) == 4)
    jax_seed = (hash((SEED, 0, 0)) & 0x7FFFFFFF) + 0
    assert first["seed"] == jax_seed
    np.testing.assert_array_equal(first["out"], jds.maybe_decode(first["x"], 40, True, jax_seed))
    assert first["out"].shape == (4, 40, 40, 3)


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()}


def test_task_checkpoint_resume_is_bitwise(twin, tree, tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    for name in ("task_000.ckpt", "task_000.ckpt.sha256"):
        (d / name).write_bytes((twin["dir"] / "ckpt" / name).read_bytes())
    trainer = build_trainer(_argv(tree, "--ckpt_dir", str(d), "--resume",
                                  "--log_file", str(tmp_path / "run.jsonl")))
    assert trainer.start_task == 1
    mx = trainer.memory.get()[0]
    assert mx.dtype == object
    result = trainer.fit()
    assert result["acc1s"] == twin["result"]["acc1s"]
    want = _state(twin["trainer"])
    got = _state(trainer)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    np.testing.assert_array_equal(trainer.memory.get()[0], twin["trainer"].memory.get()[0])


# Each train decode of the depth-2 run sleeps this long more: a decode the
# producer overlaps with the steps must not be charged to the epoch's host_s.
SLOW_DECODE_S = 0.03


def test_prefetch_depth_two_is_the_depth_zero_twin(twin, tree, tmp_path):
    """At ``--prefetch_depth 2`` every decode (train, eval, herding) runs on
    a producer thread while the steps run, and the run is bitwise the
    depth-0 twin's: the same decodes in the same order, acc1s, final state
    and memory of paths.  ``StallClock`` charges only the wait the producer
    does not hide: with each train decode slowed by ``SLOW_DECODE_S``, an
    epoch's host_s stays under what running those decodes inline costs."""
    calls = []
    decode = CilTrainer._decode

    def recording(self, x, train, seed):
        out = decode(self, x, train, seed)
        if train and seed >= 1000:  # a train step's batch, not herding's
            time.sleep(SLOW_DECODE_S)
        calls.append({"x": np.array(x), "train": train, "seed": seed, "out": out,
                      "thread": threading.current_thread().name})
        return out

    log = tmp_path / "run.jsonl"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CilTrainer, "_decode", recording)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            trainer = build_trainer(_argv(tree, "--prefetch_depth", "2", "--log_file", str(log)))
            result = trainer.fit()
        finally:
            torch.set_num_threads(threads)
    assert {c["thread"] for c in twin["calls"]} == {"MainThread"}
    assert {c["thread"] for c in calls} == {"prefetch-train", "prefetch-eval", "prefetch-herd"}
    assert len(calls) == len(twin["calls"])
    for got, want in zip(calls, twin["calls"]):
        assert (got["train"], got["seed"]) == (want["train"], want["seed"])
        assert got["x"].tolist() == want["x"].tolist()
        np.testing.assert_array_equal(got["out"], want["out"])
    assert result["acc1s"] == twin["result"]["acc1s"]
    want = _state(twin["trainer"])
    got = _state(trainer)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    np.testing.assert_array_equal(trainer.memory.get()[0], twin["trainer"].memory.get()[0])
    epochs = _records(log, "epoch")
    assert [r["steps"] for r in epochs] == [r["steps"] for r in _records(twin["log"], "epoch")]
    for r in epochs:
        assert r["prefetch_depth"] == 2
        assert r["host_s"] < r["steps"] * SLOW_DECODE_S, r


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_memory_of_paths_round_trips_both_backends(twin, tree, tmp_path, backend):
    trainer = twin["trainer"]
    saved = trainer.config
    trainer.config = saved.replace(ckpt_dir=str(tmp_path), ckpt_backend=backend)
    try:
        path = ckpt.save_task_checkpoint(trainer, 1)
    finally:
        trainer.config = saved
    assert os.path.exists(path)
    fresh = build_trainer(_argv(tree, "--ckpt_dir", str(tmp_path), "--ckpt_backend", backend,
                                "--resume"))
    assert fresh.start_task == 2
    assert sorted(fresh.memory._store) == sorted(trainer.memory._store)
    for c, (x, y, t) in trainer.memory._store.items():
        fx, fy, ft = fresh.memory._store[c]
        assert fx.dtype == object and fx.tolist() == x.tolist()
        np.testing.assert_array_equal(fy, y)
        np.testing.assert_array_equal(ft, t)


def test_skew_check_reads_the_val_paths(twin):
    """Each task's artifact re-scores every seen val slice of paths, decoded
    at the artifact's input_size."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        load_artifact,
        measure_skew,
    )

    skews = _records(twin["log"], "serve_skew")
    assert [r["task_id"] for r in skews] == [0, 1]
    assert [len(r["served_acc_per_task"]) for r in skews] == [1, 2]
    assert [r["n"] for r in skews] == [6, 12]
    for r in skews:
        assert r["skew_abs_max"] is not None and r["skew_abs_max"] <= 100.0 / 6 + 1e-9
    art_dir = twin["dir"] / "export" / "task_001"
    meta = json.loads((art_dir / "meta.json").read_text())
    assert meta["input_size"] == 40
    artifact = load_artifact(str(art_dir), device="cpu")
    again = measure_skew(artifact, twin["trainer"].scenario_val)
    assert again["served_acc_per_task"] == skews[1]["served_acc_per_task"]


_LOCKSTEP_RANK = r"""
import json, os, sys
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

argv = sys.argv[1:] + ["--dist_url", os.environ["DIST_URL"]]
rank = int(os.environ["RANK"])
trainer = build_trainer(argv)
result = trainer.fit()
json.dump({"acc1s": result["acc1s"], "violations": trainer.lockstep.violations,
           "checks": trainer.lockstep._seq}, open(f"lockstep{rank}.json", "w"))
dist.destroy_process_group()
"""


def test_lockstep_on_paths_finds_no_mismatch(tree, tmp_path):
    argv = _argv(tree, "--mesh_data", "2", "--check_lockstep", "--num_epochs", "1",
                 "--telemetry_dir", str(tmp_path / "tel"))
    argv[argv.index("--batch_size") + 1] = "2"  # global 4
    spawn_ranks(tmp_path, _LOCKSTEP_RANK, timeout=240, argv=argv)
    out = [json.loads((tmp_path / f"lockstep{r}.json").read_text()) for r in range(2)]
    assert out[0]["violations"] == out[1]["violations"] == []
    assert out[0]["checks"] == out[1]["checks"] > 0
    assert out[0]["acc1s"] == out[1]["acc1s"]
    for name in ("run.jsonl", "run_p1.jsonl"):
        recs = _records(tmp_path / "tel" / name)
        fps = [r for r in recs if r["type"] == "lockstep_fingerprint"]
        units = {r["unit"] for r in fps}
        assert {"train_step", "eval_step", "feature_step"} <= units
        assert not [r for r in recs if r["type"] == "lockstep_violation"]
