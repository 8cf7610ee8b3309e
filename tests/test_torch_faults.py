"""The port's training-side fault sites and their supervision, on the CPU.

* ``scripts/supervise.py`` (unchanged) runs the port's CLI with
  ``--fault_spec kill@task1.epoch1``: the child dies by SIGKILL right after
  task 1 epoch 1's checkpoint lands, the supervisor relaunches it with
  ``--resume`` appended, and the relaunch resumes at that epoch boundary and
  finishes (the module fixture; one supervised run for the whole file).
* The ``engine.step`` and ``data.produce`` sites fire where the JAX loop's
  do, from the supervised run's task-0 checkpoint.
* The ``resume``, ``ckpt_fallback``, ``ckpt_save_error`` and
  ``fault_injected`` records (and every other record of the port's log)
  pass the JAX package's ``telemetry/schema.py``.
* Two ``gloo`` ranks (``--mesh_data 2``) agree on the resume point and
  restore it; ranks that see different checkpoints raise.

Bitwise equality of a resumed run with its twin is in
``tests/test_torch_checkpoint.py``.
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from a_pytorch_tutorial_to_class_incremental_learning_tpu.telemetry.schema import check_record
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import CilTrainer
from faults import FaultInjected
from test_torch_checkpoint import _cfg, _copy_ckpt, _records, deadline
from test_torch_dist import PORT, REPO, spawn_ranks

TEST_LIMIT_S = 120
CLI_ARGV = [
    "--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "0",
    "--increment", "5", "--backbone", "resnet20", "--batch_size", "8",
    "--num_epochs", "2", "--eval_every_epoch", "100", "--memory_size", "40",
    "--lr", "0.05", "--aa", "none", "--color_jitter", "0", "--seed", "11",
]


@pytest.fixture(autouse=True)
def _limit():
    with deadline(TEST_LIMIT_S):
        yield


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    d = tmp_path_factory.mktemp("supervised")
    ckpt, log, sup_log = str(d / "ckpt"), str(d / "run.jsonl"), str(d / "supervisor.jsonl")
    child = [sys.executable, "-m", PORT, *CLI_ARGV, "--ckpt_dir", ckpt,
             "--epoch_ckpt_every", "1", "--fault_spec", "kill@task1.epoch1",
             "--log_file", log]
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    with deadline(2 * TEST_LIMIT_S), pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        rc = _load_script("supervise").main([
            "--backoff_base", "0.01", "--backoff_max", "0.05", "--max_failures", "2",
            "--log", sup_log, "--", *child,
        ])
    return {"rc": rc, "ckpt": ckpt, "log": _records(log), "events": _records(sup_log)}


def test_supervisor_relaunches_the_killed_cli_with_resume(supervised):
    assert supervised["rc"] == 0
    events = supervised["events"]
    assert [e["event"] for e in events] == ["launch", "exit", "relaunch", "launch", "exit",
                                            "done"]
    launches = [e["cmd"] for e in events if e["event"] == "launch"]
    assert "--resume" not in launches[0] and launches[1].count("--resume") == 1
    exits = [e for e in events if e["event"] == "exit"]
    assert exits[0]["returncode"] == -9 and exits[1]["returncode"] == 0  # SIGKILL, then done
    ledger = _records(os.path.join(supervised["ckpt"], "fault_ledger.jsonl"))
    assert [(r["spec"], r["site"], r["task"], r["epoch"]) for r in ledger] == [
        ("kill@task1.epoch1", "engine.epoch", 1, 1)]
    names = os.listdir(supervised["ckpt"])
    assert {"task_000.ckpt", "task_001.ckpt"} <= set(names)
    assert not any("epoch" in n for n in names)


def test_relaunch_resumes_at_the_killed_epoch_boundary(supervised):
    log = supervised["log"]
    assert [r["type"] for r in log] == [
        "run", "compile_event", "epoch", "epoch", "task", "cil_metrics", "compile_event",
        "epoch", "fault_injected", "run", "resume", "compile_event", "epoch", "task",
        "cil_metrics", "final"]
    resume = next(r for r in log if r["type"] == "resume")
    assert (resume["kind"], resume["start_task"], resume["start_epoch"]) == ("epoch", 1, 1)
    assert resume["path"].endswith("task_001_epoch_001.ckpt")
    epochs = [(r["task_id"], r["epoch"]) for r in log if r["type"] == "epoch"]
    assert epochs == [(0, 1), (0, 2), (1, 1), (1, 2)]
    final = log[-1]
    assert len(final["acc1s"]) == 2 and all(np.isfinite(final["acc1s"]))
    assert final["acc1s"][0] == next(r for r in log if r["type"] == "task")["acc1"]


@pytest.mark.parametrize("spec,site,steps", [
    ("slow_batch@task1.epoch1.step1,raise@task1.epoch1.step2", "engine.step", 2),
    ("producer_die@task1.epoch1.step1", "data.produce", 0),
])
def test_step_and_produce_sites_fire_where_the_jax_loop_does(supervised, tmp_path,
                                                             spec, site, steps):
    ckpt = str(tmp_path / "ckpt")
    _copy_ckpt(supervised["ckpt"], ckpt, "task_000.ckpt")
    log = str(tmp_path / "run.jsonl")
    # The per-step loop: its sites fire at each host batch and each step
    # (the fused path settles step clauses after the epoch instead).
    t = CilTrainer(_cfg(ckpt_dir=ckpt, resume=True, fault_spec=spec, log_file=log,
                        fused_epochs=False), device="cpu")
    with pytest.raises(FaultInjected) as info:
        t.fit()
    assert info.value.site == site and info.value.coords["step"] == max(steps, 1)
    assert t.global_step == steps  # engine.step fires after its step's dispatch
    fired = [(r["site"], r["action"], r["step"]) for r in _records(log)
             if r["type"] == "fault_injected"]
    if site == "engine.step":
        assert fired == [("data.produce", "slow_batch", 1), ("engine.step", "raise", 2)]
    else:
        assert fired == [("data.produce", "producer_die", 1)]
    assert t.faults.armed == ()


def test_records_pass_the_jax_schema(supervised, tmp_path):
    # A resume past a damaged newest checkpoint logs ckpt_fallback; an
    # injected save failure logs fault_injected and ckpt_save_error.
    ckpt = str(tmp_path / "ckpt")
    _copy_ckpt(supervised["ckpt"], ckpt, "task_000.ckpt", "task_001.ckpt")
    with open(os.path.join(ckpt, "task_001.ckpt"), "r+b") as f:
        f.truncate(100)
    log = str(tmp_path / "run.jsonl")
    t = CilTrainer(_cfg(ckpt_dir=ckpt, resume=True, fault_spec="save_ioerror@task1",
                        log_file=log), device="cpu")
    assert t.resumed_from["path"].endswith("task_000.ckpt") and t.start_task == 1
    t._save_checkpoint(1)
    records = _records(log)
    assert [r["type"] for r in records] == ["run", "ckpt_fallback", "resume",
                                            "fault_injected", "ckpt_save_error"]
    assert records[1]["skipped"].endswith("task_001.ckpt")
    errors = []
    for i, rec in enumerate(records + supervised["log"]):
        errors += check_record(rec, f"record {i}")
    assert not errors, errors


_RANK = r"""
import json, os, sys
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.checkpoint import _read_payload

argv = sys.argv[1:] + ["--dist_url", os.environ["DIST_URL"], "--mesh_data", "2", "--resume"]
full, partial = os.environ["FULL"], os.environ["PARTIAL"]
r = int(os.environ["RANK"])
trainer = build_trainer(argv + ["--ckpt_dir", full, "--log_file", "run.jsonl"])
payload, _ = _read_payload(trainer.resumed_from["path"])
sd = trainer.state.model.state_dict()
same = all(torch.equal(sd[k], torch.from_numpy(v))
           for tree in ("params", "batch_stats") for k, v in payload[tree].items())
result = trainer.fit()
out = {"start": [trainer.start_task, trainer.start_epoch],
       "kind": trainer.resumed_from["kind"], "same": same, "acc1s": result["acc1s"]}
try:  # rank 1 sees only the task-0 checkpoint
    build_trainer(argv + ["--ckpt_dir", full if r == 0 else partial])
    out["disagreement"] = None
except RuntimeError as e:
    out["disagreement"] = str(e)
json.dump(out, open(f"result{r}.json", "w"))
dist.destroy_process_group()
"""


def test_two_ranks_agree_on_the_resume_point_or_raise(supervised, tmp_path):
    full, partial = str(tmp_path / "full"), str(tmp_path / "partial")
    shutil.copytree(supervised["ckpt"], full)
    _copy_ckpt(supervised["ckpt"], partial, "task_000.ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FULL", full)
        mp.setenv("PARTIAL", partial)
        spawn_ranks(tmp_path, _RANK, timeout=TEST_LIMIT_S - 10,
                    argv=[*CLI_ARGV[:6], "--batch_size", "4", *CLI_ARGV[8:]])
    results = [json.loads((tmp_path / f"result{r}.json").read_text()) for r in range(2)]
    final = supervised["log"][-1]
    for res in results:
        assert res["start"] == [2, 0] and res["kind"] == "task" and res["same"]
        assert res["acc1s"] == final["acc1s"]
        assert "disagree" in res["disagreement"]
