"""The port's checkpoint/resume (``…_tpu_torch/utils/checkpoint.py``) on the
CPU, at the size of ``tests/test_checkpoint.py``'s ``_cfg``.

* Parity with the JAX module on one directory of valid, truncated,
  bit-flipped, stale, orphan and legacy files: the same candidates, the same
  reader verdicts, the same newest valid file; each package's payload
  verifies under the other's reader.
* Resume is exact: one uninterrupted twin (module fixture, with task and
  epoch checkpoints) is trained once; a run resumed from its task-0
  checkpoint dies at ``raise@task1.epoch1``, and the relaunch with the same
  spec resumes at the epoch boundary and ends bitwise equal to the twin.
* The seed-mismatch refusal, a fresh start without a checkpoint, the
  transient ``save_ioerror`` at a task and at an epoch boundary, and the
  no-alias check of ``--check_donation``.
* The ``orbax`` backend (``torch.distributed.checkpoint`` at one rank): the
  layout (a directory, its ``.meta`` and the ``.meta``'s ``.sha256``), the
  JAX scan's refusal of a directory without its ``.meta``, the damage of
  ``corrupt_ckpt``/``truncate_ckpt`` (to the ``.meta``, as JAX), a run
  killed after an epoch checkpoint whose relaunch ends bitwise equal to the
  pickle twin, and JAX's ``test_kill_and_resume_reproduces[orbax]`` case:
  with ``task_001.orbax`` and its ``.meta`` deleted, a resume from task 0.
"""

import contextlib
import json
import os
import pickle
import shutil
import signal

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu.utils import checkpoint as jck
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.config import CilConfig
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import CilTrainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import checkpoint as tck
from faults import FaultInjected, injector_from
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

SPEC = "raise@task1.epoch1"
TEST_LIMIT_S = 120  # per test; the module's training runs once, in fixtures


@contextlib.contextmanager
def deadline(seconds):
    """Fail with TimeoutError once ``seconds`` pass, and run torch on one
    intra-op thread meanwhile (beside other test workers its default pool
    oversubscribes the cores)."""
    def expire(_signum, _frame):
        raise TimeoutError(f"over the {seconds} s limit")

    threads = torch.get_num_threads()
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _limit():
    with deadline(TEST_LIMIT_S):
        yield


def _cfg(**kw):
    defaults = dict(
        data_set="synthetic10", num_bases=0, increment=5, backbone="resnet20",
        batch_size=8, num_epochs=2, eval_every_epoch=100, memory_size=40, lr=0.05,
        aa=None, color_jitter=0.0, seed=11,
    )
    defaults.update(kw)
    return CilConfig(**defaults)


def _records(path):
    return [json.loads(ln) for ln in open(path)]


def _copy_ckpt(src_dir, dst_dir, *names):
    os.makedirs(dst_dir, exist_ok=True)
    for name in names:
        for suffix in ("", ".sha256"):
            shutil.copy(os.path.join(src_dir, name + suffix), os.path.join(dst_dir, name + suffix))


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The uninterrupted run.  It writes task and epoch checkpoints, and its
    epoch-2 save of task 1 fails by ``save_ioerror`` (transient: the run
    goes on); saving reads the state and changes nothing of the training."""
    d = tmp_path_factory.mktemp("twin")
    cfg = _cfg(ckpt_dir=str(d / "ckpt"), epoch_ckpt_every=1,
               fault_spec="save_ioerror@task1.epoch2", log_file=str(d / "run.jsonl"))
    with deadline(TEST_LIMIT_S):
        trainer = CilTrainer(cfg, device="cpu")
        result = trainer.fit()
    return {"trainer": trainer, "result": result, "ckpt": cfg.ckpt_dir,
            "log": _records(cfg.log_file)}


@pytest.fixture(scope="module")
def chain(twin, tmp_path_factory):
    """Resume from the twin's task-0 checkpoint, die at ``raise@task1.epoch1``
    (after that epoch's checkpoint), relaunch with the same spec (and
    ``--check_donation``): the relaunch resumes mid-task."""
    d = tmp_path_factory.mktemp("chain")
    ckpt, log = str(d / "ckpt"), str(d / "run.jsonl")
    _copy_ckpt(twin["ckpt"], ckpt, "task_000.ckpt")
    cfg = _cfg(ckpt_dir=ckpt, epoch_ckpt_every=1, fault_spec=SPEC, resume=True, log_file=log)
    with deadline(TEST_LIMIT_S):
        first = CilTrainer(cfg, device="cpu")
        first_view = {"start_task": first.start_task, "start_epoch": first.start_epoch,
                      "resumed_from": first.resumed_from, "known": first.known,
                      "memory_classes": first.memory.nb_classes,
                      "teacher": first.teacher is not None}
        with pytest.raises(FaultInjected):
            first.fit()
        after_crash = sorted(os.listdir(ckpt))
        second = CilTrainer(cfg.replace(check_donation=True), device="cpu")
        result = second.fit()
    return {"first": first_view, "after_crash": after_crash, "second": second,
            "result": result, "ckpt": ckpt, "log": _records(log)}


# --------------------------------------------------------------------------- #
# Parity with the JAX module on the same files
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def parity_dir(twin, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parity"))
    _copy_ckpt(twin["ckpt"], d, "task_000.ckpt")                    # port, valid task
    tck._write_pickle_atomic(os.path.join(d, "task_000_epoch_001.ckpt"),
                             {"task_id": 0, "epoch": 1})            # port, valid epoch
    jck._write_pickle_atomic(os.path.join(d, "task_001_epoch_002.ckpt"),
                             {"task_id": 1, "epoch": 2, "w": np.arange(6.0)})  # JAX, valid
    trunc = os.path.join(d, "task_001_epoch_001.ckpt")
    tck._write_pickle_atomic(trunc, {"task_id": 1, "epoch": 1, "w": np.ones(64)})
    with open(trunc, "r+b") as f:
        f.truncate(os.path.getsize(trunc) // 2)
    flip = os.path.join(d, "task_001.ckpt")
    tck._write_pickle_atomic(flip, {"task_id": 1, "w": np.zeros(64)})
    blob = bytearray(open(flip, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(flip, "wb").write(bytes(blob))
    with open(os.path.join(d, "task_002.ckpt.tmp"), "w") as f:    # stale temp file
        f.write("partial")
    with open(os.path.join(d, "task_003.ckpt.sha256"), "w") as f:  # orphan sidecar
        f.write("0" * 64 + "\n")
    with open(os.path.join(d, "task_000_epoch_002.ckpt"), "wb") as f:  # legacy: no sidecar
        pickle.dump({"task_id": 0, "epoch": 2}, f)
    return d


def _verdicts(mod, d):
    names = sorted(os.listdir(d)) + ["task_003.ckpt"]  # the orphan sidecar's payload
    out = {}
    for name in names:
        payload, why = mod._read_payload(os.path.join(d, name))
        out[name] = (why, None if payload is None else pickle.dumps(payload))
    return out


@pytest.mark.parametrize("case", ["candidates", "verdicts", "latest",
                                  "port_payload_under_jax_reader",
                                  "jax_payload_under_port_reader"])
def test_scan_and_reader_match_the_jax_module(parity_dir, tmp_path, case):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(parity_dir, port_dir)
    shutil.copytree(parity_dir, jax_dir)
    if case == "candidates":
        got = [(t, e, os.path.basename(p)) for t, e, p in tck.checkpoint_candidates(port_dir)]
        want = [(t, e, os.path.basename(p)) for t, e, p in jck.checkpoint_candidates(jax_dir)]
        assert got == want == [
            (1, None, "task_001.ckpt"), (1, 2, "task_001_epoch_002.ckpt"),
            (1, 1, "task_001_epoch_001.ckpt"), (0, None, "task_000.ckpt"),
            (0, 2, "task_000_epoch_002.ckpt"), (0, 1, "task_000_epoch_001.ckpt"),
        ]
        # Both scans deleted the stale temp file, and only it.
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
        assert "task_002.ckpt.tmp" not in os.listdir(port_dir)
    elif case == "verdicts":
        got, want = _verdicts(tck, port_dir), _verdicts(jck, jax_dir)
        assert got == want
        bad = {n for n, (why, _p) in got.items() if why is not None}
        assert {"task_001.ckpt", "task_001_epoch_001.ckpt", "task_003.ckpt"} <= bad
        assert got["task_000_epoch_002.ckpt"][0] is None  # legacy, no sidecar
        assert got["task_001.ckpt"][0].startswith("checksum mismatch")
    elif case == "latest":
        got = tck.latest_task_checkpoint(port_dir)
        assert os.path.basename(got) == os.path.basename(jck.latest_task_checkpoint(jax_dir))
        assert os.path.basename(got) == "task_001_epoch_002.ckpt"
    elif case == "port_payload_under_jax_reader":
        path = os.path.join(jax_dir, "task_000.ckpt")
        payload, why = jck._read_payload(path)
        ours, _ = tck._read_payload(path)
        assert why is None and payload["task_id"] == 0 and payload["known"] == 5
        assert payload.keys() == ours.keys() >= {"params", "batch_stats", "memory_store"}
        for name, arr in ours["params"].items():
            np.testing.assert_array_equal(payload["params"][name], arr)
    else:
        path = os.path.join(port_dir, "task_001_epoch_002.ckpt")
        payload, why = tck._read_payload(path)
        assert why is None and payload["epoch"] == 2
        np.testing.assert_array_equal(payload["w"], np.arange(6.0))
        assert open(path + ".sha256").read().strip() == tck._sha256_file(path)


# --------------------------------------------------------------------------- #
# Resume
# --------------------------------------------------------------------------- #


def test_task_boundary_resume_restores_the_post_task_state(chain):
    first = chain["first"]
    assert (first["start_task"], first["start_epoch"]) == (1, 0)
    assert first["resumed_from"]["kind"] == "task"
    assert first["resumed_from"]["path"].endswith("task_000.ckpt")
    assert first["known"] == 5 and first["memory_classes"] == 5 and first["teacher"]
    # The kill came after task 1 epoch 1's checkpoint landed.
    assert {"task_001_epoch_001.ckpt", "task_001_epoch_001.ckpt.sha256",
            "fault_ledger.jsonl"} <= set(chain["after_crash"])


def test_epoch_resume_finishes_bitwise_equal_to_the_twin(twin, chain):
    second = chain["second"]
    assert second.faults.armed == ()
    assert (second.start_task, second.start_epoch) == (1, 1)
    assert second.resumed_from["kind"] == "epoch"
    assert second.resumed_from["path"].endswith("task_001_epoch_001.ckpt")
    ref, out = twin["result"], chain["result"]
    assert out["acc1s"] == ref["acc1s"]
    assert out["acc_matrix"] == ref["acc_matrix"]
    ref_t = twin["trainer"]
    for name, want in ref_t.state.model.state_dict().items():
        assert torch.equal(second.state.model.state_dict()[name], want), name
    for want, got in zip(ref_t.state.momentum, second.state.momentum):
        assert torch.equal(got, want)
    for name, want in ref_t.teacher.model.state_dict().items():
        assert torch.equal(second.teacher.model.state_dict()[name], want), name
    # The step count restarts at a task-boundary resume (a task payload has
    # none, as in JAX) and is restored at an epoch boundary.
    assert second.global_step == sum(
        r["steps"] for r in twin["log"] if r["type"] == "epoch" and r["task_id"] == 1)
    # Task 1's task checkpoint superseded its epoch files.
    names = os.listdir(chain["ckpt"])
    assert "task_001.ckpt" in names
    assert not any("epoch" in n for n in names)


def test_resumed_log_is_the_twins_from_the_resume_point(twin, chain):
    def core(records):
        return [r for r in records if r["type"] in ("epoch", "task", "cil_metrics", "final")]

    types = [r["type"] for r in chain["log"]]
    assert types == ["run", "resume", "compile_event", "epoch", "fault_injected", "run",
                     "resume", "compile_event", "epoch", "task", "cil_metrics", "final"]
    resumes = [r for r in chain["log"] if r["type"] == "resume"]
    assert (resumes[0]["kind"], resumes[0]["start_task"], resumes[0]["start_epoch"]) == \
        ("task", 1, 0)
    assert (resumes[1]["kind"], resumes[1]["start_task"], resumes[1]["start_epoch"]) == \
        ("epoch", 1, 1)
    fault = next(r for r in chain["log"] if r["type"] == "fault_injected")
    assert (fault["site"], fault["action"], fault["task"], fault["epoch"]) == \
        ("engine.epoch", "raise", 1, 1)
    # Task 1's records carry the twin's numbers.
    ref = [r for r in core(twin["log"]) if r.get("task_id", 1) >= 1 or r["type"] == "final"]
    ref = ref[ref.index(next(r for r in ref if r["type"] == "epoch")):]
    got = core(chain["log"])
    assert [r["type"] for r in got] == [r["type"] for r in ref]
    drop = ("ts", "epoch_s", "host_s", "device_s", "stall_frac", "seconds", "host_id")
    for a, b in zip(got, ref):
        assert {k: v for k, v in a.items() if k not in drop} == \
            {k: v for k, v in b.items() if k not in drop}


def test_resume_refuses_seed_mismatch(twin):
    with pytest.raises(ValueError, match="seed"):
        CilTrainer(_cfg(ckpt_dir=twin["ckpt"], resume=True, seed=99), device="cpu")


def test_resume_without_checkpoint_is_fresh(tmp_path):
    log = str(tmp_path / "run.jsonl")
    t = CilTrainer(_cfg(ckpt_dir=str(tmp_path / "none"), resume=True, log_file=log),
                   device="cpu")
    assert (t.start_task, t.start_epoch, t.known, t.resumed_from) == (0, 0, 0, None)
    resume = _records(log)[-1]
    assert resume["type"] == "resume" and resume["start_task"] == 0 and "path" not in resume


@pytest.mark.parametrize("boundary", ["task", "epoch"])
def test_save_ioerror_is_transient_not_fatal(twin, tmp_path, boundary):
    if boundary == "epoch":
        # The twin's own run: its task 1 epoch 2 save failed, and it finished.
        errors = [r for r in twin["log"] if r["type"] == "ckpt_save_error"]
        assert [(r["task_id"], r["epoch"]) for r in errors] == [(1, 2)]
        assert "OSError" in errors[0]["error"]
        assert len(twin["result"]["acc1s"]) == 2
        assert "task_001.ckpt" in os.listdir(twin["ckpt"])
        return
    # The loop's task-boundary hook on the trained twin, into a new directory:
    # the injected failure is logged, and the next save lands.
    trainer = twin["trainer"]
    saved = trainer.config, trainer.faults, trainer.jsonl
    sink = _Sink()
    ckpt = str(tmp_path / "ckpt")
    trainer.config = trainer.config.replace(ckpt_dir=ckpt)
    trainer.jsonl = sink
    trainer.faults = injector_from("save_ioerror@task1", sink=sink)
    try:
        trainer._save_checkpoint(1)
        assert not os.path.exists(os.path.join(ckpt, "task_001.ckpt"))
        trainer._save_checkpoint(1)
    finally:
        trainer.config, trainer.faults, trainer.jsonl = saved
    assert [r["type"] for r in sink.records] == ["fault_injected", "ckpt_save_error"]
    assert sink.records[1]["task_id"] == 1 and "epoch" not in sink.records[1]
    assert tck.latest_task_checkpoint(ckpt).endswith("task_001.ckpt")


class _Sink:
    def __init__(self):
        self.records = []

    def log(self, rtype, **fields):
        self.records.append({"type": rtype, **fields})


@pytest.mark.parametrize("restore", ["copy", "rebind"])
def test_check_donation_proves_no_alias_then_poisons(twin, monkeypatch, restore):
    payloads = []
    read = tck._read_payload

    def capture(path):
        payload, why = read(path)
        payloads.append(payload)
        return payload, why

    monkeypatch.setattr(tck, "_read_payload", capture)
    cfg = _cfg(ckpt_dir=twin["ckpt"], resume=True, check_donation=True)
    if restore == "copy":
        t = CilTrainer(cfg, device="cpu")
        assert t.resumed_from["kind"] == "task" and t.start_task == 2
        params = payloads[-1]["params"]
        assert all(np.isnan(a).all() for a in params.values())  # poisoned
        for name, p in t.state.model.named_parameters():
            assert torch.equal(p, twin["trainer"].state.model.state_dict()[name]), name
        return
    # A restore that rebinds a parameter to the payload's array (as
    # ``torch.from_numpy`` does) instead of copying into it: caught.
    copy_into = tck._copy_into

    def rebinding(model, named, arrays, what):
        named = list(named)
        copy_into(model, named, arrays, what)
        if what == "params":
            name, p = named[0]
            p.data = torch.from_numpy(arrays[name])

    monkeypatch.setattr(tck, "_copy_into", rebinding)
    with pytest.raises(tck.CheckpointAliasError, match="share memory"):
        CilTrainer(cfg, device="cpu")


# --------------------------------------------------------------------------- #
# The orbax backend
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def orbax_chain(twin, tmp_path_factory):
    """The twin's recipe on ``--ckpt_backend orbax``: resumed from the
    twin's task-0 payload, which it saves again as ``task_000.orbax`` (the
    save the loop makes after task 0) in place of the pickle; killed by
    ``raise@task1.epoch1`` right after that epoch's checkpoint; relaunched
    with ``--resume``."""
    d = tmp_path_factory.mktemp("orbax")
    ckpt = str(d / "ckpt")
    _copy_ckpt(twin["ckpt"], ckpt, "task_000.ckpt")
    cfg = _cfg(ckpt_dir=ckpt, ckpt_backend="orbax", epoch_ckpt_every=1, fault_spec=SPEC,
               resume=True, log_file=str(d / "run.jsonl"))
    with deadline(TEST_LIMIT_S):
        first = CilTrainer(cfg, device="cpu")
        tck.save_task_checkpoint(first, 0)
        for name in ("task_000.ckpt", "task_000.ckpt.sha256"):
            os.remove(os.path.join(ckpt, name))
        with pytest.raises(FaultInjected):
            first.fit()
        after_crash = sorted(os.listdir(ckpt))
        epoch_dir = sorted(os.listdir(os.path.join(ckpt, "task_001_epoch_001.orbax")))
        second = CilTrainer(cfg.replace(check_donation=True), device="cpu")
        result = second.fit()
    return {"after_crash": after_crash, "epoch_dir": epoch_dir, "second": second,
            "result": result, "ckpt": ckpt}


def test_orbax_layout_at_one_rank(orbax_chain):
    names = orbax_chain["after_crash"]
    for stem in ("task_000.orbax", "task_001_epoch_001.orbax"):
        assert {stem, stem + ".meta", stem + ".meta.sha256"} <= set(names)
    assert not any(n.endswith((".tmp", ".ckpt")) for n in names)
    assert orbax_chain["epoch_dir"] == [".metadata", "__0_0.distcp"]
    meta, why = tck._read_payload(os.path.join(orbax_chain["ckpt"], "task_001.orbax"))
    assert why is None and meta["task_id"] == 1 and "params" not in meta


def test_orbax_epoch_resume_equals_the_twin(twin, orbax_chain):
    second = orbax_chain["second"]
    assert (second.start_task, second.start_epoch) == (1, 1)
    assert second.resumed_from["path"].endswith("task_001_epoch_001.orbax")
    assert orbax_chain["result"]["acc1s"] == twin["result"]["acc1s"]
    ref_t = twin["trainer"]
    for name, want in ref_t.state.model.state_dict().items():
        assert torch.equal(second.state.model.state_dict()[name], want), name
    for want, got in zip(ref_t.state.momentum, second.state.momentum):
        assert torch.equal(got, want)
    for name, want in ref_t.teacher.model.state_dict().items():
        assert torch.equal(second.teacher.model.state_dict()[name], want), name
    names = os.listdir(orbax_chain["ckpt"])
    assert "task_001.orbax" in names and not any("epoch" in n for n in names)


def test_orbax_resume_from_task_0_as_jax(twin, orbax_chain, tmp_path):
    """JAX ``tests/test_checkpoint.py:39-80`` (orbax): delete
    ``task_001.orbax`` and its ``.meta``; the resume starts at task 1 from
    task 0's checkpoint, whose state is the twin's after task 0."""
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(orbax_chain["ckpt"], ckpt)
    shutil.rmtree(os.path.join(ckpt, "task_001.orbax"))
    os.remove(os.path.join(ckpt, "task_001.orbax.meta"))
    want = [(0, None, "task_000.orbax")]
    for mod in (tck, jck):
        got = [(t, e, os.path.basename(p)) for t, e, p in mod.checkpoint_candidates(ckpt)]
        assert got == want
    resumed = CilTrainer(_cfg(ckpt_dir=ckpt, ckpt_backend="orbax", resume=True),
                         device="cpu")
    assert (resumed.start_task, resumed.known, resumed.memory.nb_classes) == (1, 5, 5)
    assert resumed.teacher is not None
    payload, _ = tck._read_payload(os.path.join(twin["ckpt"], "task_000.ckpt"))
    for name, p in resumed.state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), payload["params"][name])
    for name, b in resumed.state.model.named_buffers():
        np.testing.assert_array_equal(b.numpy(), payload["batch_stats"][name])


def test_orbax_directory_without_meta_is_skipped_as_jax(orbax_chain, tmp_path):
    dirs = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        shutil.copytree(orbax_chain["ckpt"], d)
        os.remove(d / "task_001.orbax.meta")  # the directory alone
        (d / "task_002.orbax.tmp").mkdir()     # a save cut short
        dirs[name] = str(d)
    got = [(t, e, os.path.basename(p)) for t, e, p in tck.checkpoint_candidates(dirs["port"])]
    want = [(t, e, os.path.basename(p)) for t, e, p in jck.checkpoint_candidates(dirs["jax"])]
    assert got == want == [(0, None, "task_000.orbax")]
    assert "task_002.orbax.tmp" not in os.listdir(dirs["port"])


@pytest.mark.parametrize("action", ["corrupt_ckpt", "truncate_ckpt"])
def test_orbax_payload_faults_damage_the_meta_as_jax(orbax_chain, tmp_path, action):
    copies = {}
    for name, mod in (("port", tck), ("jax", jck)):
        d = tmp_path / name
        shutil.copytree(orbax_chain["ckpt"], d)
        path = str(d / "task_000.orbax")
        mod._apply_payload_faults((action,), path)
        copies[name] = path
    port, jax_ = copies["port"], copies["jax"]
    assert open(port + ".meta", "rb").read() == open(jax_ + ".meta", "rb").read()
    assert tck._read_payload(port)[1] == jck._read_payload(jax_)[1] is not None
    assert sorted(os.listdir(port)) == [".metadata", "__0_0.distcp"]  # untouched
