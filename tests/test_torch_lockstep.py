"""The lockstep sentinel (``--check_lockstep``, ``analysis/lockstep.py``) at
two ``gloo`` ranks on the CPU.

* Matching data: the fused run (the default path) fingerprints every epoch
  (on the task's host arrays), every val batch and every herding batch, and
  the ranks agree on all of them.
* A rank fed a different batch: on the per-step path, where each step's
  fingerprint digests the global batch the ranks take their stripes of,
  rank 1's third batch comes in another order.  Steps 1 and 2 agree; at
  step 3 both ranks write a ``lockstep_violation`` record
  (``fingerprint_mismatch`` on ``digest``), dump their flight recorders
  through ``on_fatal`` and raise ``LockstepViolation`` before the step.
"""

import json

from test_torch_dist import spawn_ranks

RANK_BATCH = 16  # global 32
CLI_ARGV = [
    "--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "0",
    "--increment", "5", "--backbone", "resnet20", "--num_epochs", "1",
    "--eval_every_epoch", "100", "--memory_size", "20", "--aa", "none",
    "--color_jitter", "0", "--seed", "6", "--batch_size", str(RANK_BATCH),
    "--mesh_data", "2", "--check_lockstep",
]

_RANK = r"""
import json, os, sys
import torch.distributed as dist
from analysis.lockstep import LockstepViolation
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import loader
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

argv = sys.argv[1:] + ["--dist_url", os.environ["DIST_URL"]]
rank = int(os.environ["RANK"])
out = {}
trainer = build_trainer(argv + ["--telemetry_dir", "match"])
result = trainer.fit()
out["match"] = {"acc1s": result["acc1s"], "violations": trainer.lockstep.violations,
                "checks": trainer.lockstep._seq}

if rank == 1:
    # Rank 1 reads the third global batch in another order: two rows of its
    # own stripe swap places.
    perm = loader._epoch_perm
    glob = 2 * int(os.environ["RANK_BATCH"])

    def swapped(seed, n):
        p = perm(seed, n).copy()
        i = 2 * glob + glob // 2
        p[[i, i + 1]] = p[[i + 1, i]]
        return p

    loader._epoch_perm = swapped
trainer = build_trainer(argv + ["--telemetry_dir", "diverge", "--no_fused_epochs"])
try:
    trainer.fit()
    out["diverge"] = {"raised": None}
except LockstepViolation as e:
    out["diverge"] = {"raised": str(e), "violations": trainer.lockstep.violations,
                      "steps": trainer.global_step}
json.dump(out, open(f"lockstep{rank}.json", "w"))
dist.destroy_process_group()
"""


def _records(path):
    return [json.loads(ln) for ln in open(path)]


def test_two_ranks_agree_then_both_catch_a_divergent_batch(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK_BATCH", str(RANK_BATCH))
    spawn_ranks(tmp_path, _RANK, timeout=240, argv=CLI_ARGV)
    out = [json.loads((tmp_path / f"lockstep{r}.json").read_text()) for r in range(2)]

    # Matching data: every check passed, the same number on both ranks.
    match = [o["match"] for o in out]
    assert match[0]["violations"] == match[1]["violations"] == []
    assert match[0]["checks"] == match[1]["checks"] > 0
    assert match[0]["acc1s"] == match[1]["acc1s"]
    for r, name in enumerate(("run.jsonl", "run_p1.jsonl")):
        recs = _records(tmp_path / "match" / name)
        units = [x["unit"] for x in recs if x["type"] == "lockstep_fingerprint"]
        assert units.count("train_epoch_fused") == 2
        assert "eval_step" in units and "feature_step" in units
        assert not [x for x in recs if x["type"] == "lockstep_violation"]
        assert {x["process_index"] for x in recs} == {r}

    # A divergent batch: both ranks stop at step 3, before it runs.
    for r, o in enumerate(out):
        d = o["diverge"]
        assert d["raised"] and "digest" in d["raised"], d
        assert d["steps"] == 2
        (v,) = d["violations"]
        assert (v["kind"], v["fields"], v["unit"], v["step"], v["peer"]) == \
            ("fingerprint_mismatch", ["digest"], "train_step", 3, 1 - r)
        recs = _records(tmp_path / "diverge" / ("run.jsonl" if r == 0 else "run_p1.jsonl"))
        (rec,) = [x for x in recs if x["type"] == "lockstep_violation"]
        assert rec["kind"] == "fingerprint_mismatch" and rec["fields"] == ["digest"]
        steps = [x["step"] for x in recs if x["type"] == "lockstep_fingerprint"]
        assert steps == [1, 2, 3]
        flight = json.loads((tmp_path / "diverge" / f"flight_{r}.json").read_text())
        assert flight["reason"] == "lockstep_fingerprint_mismatch"
    mine = [o["diverge"]["violations"][0]["mine"]["digest"] for o in out]
    theirs = [o["diverge"]["violations"][0]["theirs"]["digest"] for o in out]
    assert mine == theirs[::-1] and mine[0] != mine[1]
