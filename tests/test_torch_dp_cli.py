"""The CLI at two ``gloo`` ranks on the CPU (``--platform cpu --mesh_data
2``) against one process at the same global batch: the same record
sequence, per-process log files, identical memories on both ranks, epoch
1's mean loss rtol 1e-3 (the same data stream: both ranks draw the global
batch's augmentation), and exactly equal eval counts on one model.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist import PORT, REPO, spawn_ranks

# lr 0.02: from random weights at lr 0.1 the first steps are chaotic, and
# float summation order alone (one process at 1 vs 4 threads) moves epoch
# 1's mean loss by ~3e-3; at 0.02 both runs stay within ~3e-4 of each other.
CLI_ARGV = [
    "--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "0",
    "--increment", "5", "--backbone", "resnet20", "--num_epochs", "1",
    "--eval_every_epoch", "100", "--memory_size", "20", "--aa", "none",
    "--color_jitter", "0", "--seed", "6", "--lr", "0.02",
]
# Per-rank batch: 16 rows (global 32).  Every step all-reduces once per BN
# layer forward and backward, and gloo over this box's loopback takes
# milliseconds a collective, so smaller batches (more steps) cost more time
# than the test is worth.
RANK_BATCH = 16

_CLI_RANK = r"""
import hashlib, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import eval_batches
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss

argv = sys.argv[1:] + ["--dist_url", os.environ["DIST_URL"]]
trainer = build_trainer(argv)
result = trainer.fit()
mx, my = trainer.memory.get()[:2]
digest = hashlib.sha256(np.ascontiguousarray(mx).tobytes() + np.asarray(my).tobytes()).hexdigest()
# Eval of the trained model: this rank's stripes, all-reduced, against one
# process's pass over whole global batches.
val = trainer.scenario_val[:2]
dp = trainer._sum_over_ranks(trainer._eval_totals_device(val)).numpy()
one = sum(trainer.eval_step(trainer.state.model, *trainer._to_device(xb, yb, wb),
                            trainer.state.num_active)
          for xb, yb, wb in eval_batches(val, trainer.global_batch_size)).numpy()
r = dist.get_rank()
json.dump({"digest": digest, "acc1s": result["acc1s"], "eval_dp": dp.tolist(),
           "eval_one": one.tolist(), "steps": trainer.global_step,
           "launches": [fused_loss.FWD_LAUNCHES, fused_loss.BWD_LAUNCHES]},
          open(f"result{r}.json", "w"))
dist.destroy_process_group()
"""


def _records(path):
    return [json.loads(ln) for ln in open(path)]


def test_cli_at_two_ranks_matches_one_process(tmp_path):
    single_log = tmp_path / "single.jsonl"
    # The one-process run at the same global batch, alongside the ranks.
    single = subprocess.Popen(
        [sys.executable, "-m", PORT, *CLI_ARGV, "--batch_size", str(2 * RANK_BATCH),
         "--log_file", str(single_log)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    try:
        spawn_ranks(tmp_path, _CLI_RANK, timeout=240, argv=[
            *CLI_ARGV, "--batch_size", RANK_BATCH, "--mesh_data", 2,
            "--use_pallas_loss", "--log_file", tmp_path / "run.jsonl",
        ])
        out, _ = single.communicate(timeout=240)
    finally:
        single.kill()
    assert single.returncode == 0, out[-3000:]

    ranks = [_records(tmp_path / name) for name in ("run.jsonl", "run_p1.jsonl")]
    results = [json.loads((tmp_path / f"result{r}.json").read_text()) for r in range(2)]
    ref = _records(single_log)
    assert [r["type"] for r in ranks[0]] == [r["type"] for r in ref]
    assert [r["type"] for r in ranks[1]] == [r["type"] for r in ref]
    for r, recs in enumerate(ranks):
        assert {(x["process_index"], x["process_count"]) for x in recs} == {(r, 2)}
    run = ranks[0][0]
    assert run["mesh"] == {"data": 2, "model": 1} and run["processes"] == 2
    assert (run["batch_size"], run["global_batch"]) == (RANK_BATCH, 2 * RANK_BATCH)
    assert ref[0]["global_batch"] == 2 * RANK_BATCH

    # Same global batches, same augmentation draws: epoch 1 agrees.
    first = [next(x for x in recs if x["type"] == "epoch") for recs in (ranks[0], ref)]
    assert first[0]["steps"] == first[1]["steps"]
    assert np.isclose(first[0]["loss"], first[1]["loss"], rtol=1e-3)
    # The metrics are all-reduced in the step: every rank logs the same.
    for a, b in zip(ranks[0], ranks[1]):
        if a["type"] == "epoch":
            assert a["loss"] == b["loss"] and a["acc1"] == b["acc1"]

    assert results[0]["digest"] == results[1]["digest"]
    assert results[0]["acc1s"] == results[1]["acc1s"]
    assert results[0]["steps"] == results[1]["steps"] == sum(
        x["steps"] for x in ranks[0] if x["type"] == "epoch")
    assert results[0]["launches"] == [0, 0]  # the plain versions on the CPU
    for res in results:
        dp, one = res["eval_dp"], res["eval_one"]
        assert dp[1:] == one[1:] and dp[3] == 640  # correct@1, correct@5, count
        assert np.isclose(dp[0], one[0], rtol=1e-5)  # the loss sum, summed in pieces


def test_host_devices_names_torchrun():
    """``--host_devices`` (XLA's host-device emulation) raises, naming what
    takes its place: torchrun with one process per device."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    with pytest.raises(NotImplementedError, match="torchrun with one process per device"):
        build_trainer([*CLI_ARGV, "--host_devices", "2"])
