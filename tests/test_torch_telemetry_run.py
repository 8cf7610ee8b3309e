"""A whole run with the telemetry on, on the CPU: the slice as a whole.

One 2-task ``synthetic10`` recipe (resnet20, batch 8, one epoch a task,
epoch checkpoints), as the JAX package's own fault tests use it:

* with every telemetry flag on (``--telemetry_dir``, ``--profile_dir``,
  ``--recompile_budget``, ``--check_threads``, ``--check_contracts``,
  ``--check_lockstep``) the run ends bitwise equal to the same run with
  none: every ``state_dict`` tensor, the momentum, acc1s, γ, the matrix and
  every epoch metric;
* its JSONL, spans and flight dump pass ``scripts/check_telemetry_schema.py``
  as it stands, it logs no contract or thread violation, and its files are
  where JAX's are;
* the port's herding counters read no CUDA graph on the CPU;
* its multiset of span names equals that of the JAX trainer's run of the
  same config, and its set of record types equals JAX's but for two:
  ``profile_trace`` (the JAX run is not profiled: its profiler costs ~20 s
  on this CPU) and ``recompile`` (on the CPU the port compiles nothing,
  its steps run eagerly, while XLA compiles every program; on the card each
  task's capture logs one, which ``chip_smoke.py`` checks).  The JAX run
  takes its per-step path, whose span tree and records are its fused
  path's, because its fused scan takes ~3x longer to trace here.
"""

import collections
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import CilTrainer
from test_torch_checkpoint import _cfg, _records, deadline
from test_torch_dist import REPO, two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

EPOCHS = 1


def _schema_script():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", os.path.join(REPO, "scripts", "check_telemetry_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _uninstall_sentinels():
    from analysis import contractcheck, threadcheck

    threadcheck.uninstall()
    contractcheck.uninstall()


def _port_run(d, telemetry: bool):
    flags = dict(ckpt_dir=str(d / "ckpt"), epoch_ckpt_every=1, num_epochs=EPOCHS)
    if telemetry:
        flags.update(telemetry_dir=str(d), profile_dir=str(d / "prof"), recompile_budget=True,
                     check_threads=True, check_contracts=True, check_lockstep=True)
    else:
        flags.update(log_file=str(d / "run.jsonl"))
    from analysis import contractcheck, threadcheck

    try:
        with deadline(120):
            trainer = CilTrainer(_cfg(**flags), device="cpu")
            result = trainer.fit()
        violations = {
            "contracts": list(contractcheck.active().violations) if telemetry else [],
            "threads": list(threadcheck.active().violations) if telemetry else [],
        }
    finally:
        _uninstall_sentinels()
    return {"trainer": trainer, "result": result, "log": _records(d / "run.jsonl"),
            "violations": violations,
            "state": {k: v.clone() for k, v in trainer.state.model.state_dict().items()},
            "momentum": [m.clone() for m in trainer.state.momentum]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    on = tmp_path_factory.mktemp("telemetry_on")
    off = tmp_path_factory.mktemp("telemetry_off")
    return {"on": _port_run(on, True), "off": _port_run(off, False), "dir": on}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.config import CilConfig
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import (
        CilTrainer as JaxTrainer,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.parallel.mesh import make_mesh
    import jax

    d = tmp_path_factory.mktemp("jax")
    cfg = CilConfig(data_set="synthetic10", num_bases=0, increment=5, backbone="resnet20",
                    batch_size=8, num_epochs=EPOCHS, eval_every_epoch=100, memory_size=40,
                    lr=0.05, aa=None, color_jitter=0.0, seed=11, fused_epochs=False,
                    telemetry_dir=str(d), recompile_budget=True, check_contracts=True,
                    check_lockstep=True, ckpt_dir=str(d / "ckpt"), epoch_ckpt_every=1)
    try:
        JaxTrainer(cfg, mesh=make_mesh((1, 1), jax.devices()[:1]), init_dist=False).fit()
    finally:
        _uninstall_sentinels()
    return {"log": _records(d / "run.jsonl"), "spans": _records(d / "spans.jsonl")}


def _of(run, kind):
    return [r for r in run["log"] if r["type"] == kind]


def test_every_telemetry_flag_on_is_bitwise_the_run_with_none(runs):
    a, b = runs["on"], runs["off"]
    assert a["trainer"].global_step == b["trainer"].global_step > 0
    assert a["result"]["acc1s"] == b["result"]["acc1s"]
    assert a["result"]["acc_matrix"] == b["result"]["acc_matrix"]
    assert [r["gamma"] for r in _of(a, "task")] == [r["gamma"] for r in _of(b, "task")]
    for key in ("steps", "loss", "ce", "kd", "acc1", "acc5"):
        assert [r[key] for r in _of(a, "epoch")] == [r[key] for r in _of(b, "epoch")], key
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
    for x, y in zip(a["trainer"].memory.get(), b["trainer"].memory.get()):
        np.testing.assert_array_equal(x, y)
    # The records both runs write agree but for the clocks.
    clocks = {"ts", "epoch_s", "host_s", "device_s", "stall_frac", "seconds", "host_id",
              "compile_s", "backend_compile_s", "cache_retrieval_s"}
    core = ("epoch", "task", "cil_metrics", "final", "compile_event")
    strip = [[{k: v for k, v in r.items() if k not in clocks} for r in run["log"]
              if r["type"] in core] for run in (a, b)]
    assert strip[0] == strip[1]


def test_logs_pass_the_schema_and_no_sentinel_fires(runs):
    d = runs["dir"]
    paths = [str(d / "run.jsonl"), str(d / "spans.jsonl"), str(d / "flight_0.json")]
    mod = _schema_script()
    for path in paths:
        assert mod.check_file(path) == [], path
    assert mod.main(paths) == 0
    on = runs["on"]
    assert on["violations"] == {"contracts": [], "threads": []}
    assert not _of(on, "contract_violation") and not _of(on, "thread_violation")
    assert not _of(on, "lockstep_violation") and not _of(on, "recompile_warning")


def test_files_and_records_of_the_telemetry(runs):
    d, on = runs["dir"], runs["on"]
    names = set(os.listdir(d))
    assert {"run.jsonl", "spans.jsonl", "trace.json", "heartbeat.json", "flight_0.json",
            "prof", "ckpt"} <= names
    beat = json.load(open(d / "heartbeat.json"))
    assert beat["type"] == "heartbeat" and beat["task"] == 1 and beat["process_index"] == 0
    assert beat["steps_total"] == on["trainer"].global_step  # the pump's digest
    flight = json.load(open(d / "flight_0.json"))
    assert flight["reason"] == "close" and flight["open_spans"] == []
    traces = _of(on, "profile_trace")
    assert [(r["task_id"], r["name"]) for r in traces] == [(0, "task0_epoch0"),
                                                          (1, "task1_epoch0")]
    for r in traces:
        trace = json.load(open(r["path"]))
        assert any(e.get("name") == r["name"] for e in trace["traceEvents"])
    events = _of(on, "compile_event")
    assert [(r["task_id"], r["epoch"], r["resumed"], r["compiles"]) for r in events] == \
        [(0, 1, False, 0), (1, 1, False, 0)]  # the CPU captures no graph
    budgets = _of(on, "recompile_budget")
    assert [(r["where"], r["budget"], r["programs"], r["ok"]) for r in budgets] == \
        [("task0", 1, 0, True), ("task1", 2, 0, True)]
    assert not _of(on, "hbm")  # the CPU reports no memory
    # One fingerprint an epoch (fused), a val batch and a herding batch.
    units = collections.Counter(r["unit"] for r in _of(on, "lockstep_fingerprint"))
    assert units["train_epoch_fused"] == 2 * EPOCHS and units["eval_step"] > 0 \
        and units["feature_step"] > 0
    snaps = _of(on, "metrics_snapshot")
    last = snaps[-1]
    assert last["counters"]["steps_total"] == on["trainer"].global_step
    assert last["counters"]["epochs_total"] == 2 * EPOCHS
    assert last["histograms"]["step_latency_ms"]["count"] == 2 * EPOCHS
    assert last["gauges"]["recompiles_total"] == 0
    # Spans: depth-1 tasks under one root, their children covering them.
    spans = [json.loads(ln) for ln in open(d / "spans.jsonl")]
    tasks = [s for s in spans if s["name"] == "task"]
    assert [s["depth"] for s in tasks] == [1, 1]
    for t in tasks:
        kids = sum(s["dur_s"] for s in spans if s["parent"] == t["span_id"])
        assert kids <= t["dur_s"] and kids >= 0.8 * t["dur_s"]


def test_herding_counters_read_no_graph_on_the_cpu(runs):
    """The port's herding counters are in every snapshot, under the
    contract sentinel's extended vocabulary, and read no CUDA graph on the
    CPU: both tasks' feature passes ran eagerly on the resident dataset."""
    on = runs["on"]
    for snap in _of(on, "metrics_snapshot"):
        assert snap["counters"]["herd_graph_captures_total"] == 0
        assert snap["counters"]["herd_graph_replays_total"] == 0
    step = on["trainer"].feature_step
    assert (step.captures, step.replays) == (0, 0) and step._x is not None


def test_span_names_and_record_types_equal_the_jax_run(runs, jax_run):
    on = runs["on"]
    port_spans = collections.Counter(
        json.loads(ln)["name"] for ln in open(runs["dir"] / "spans.jsonl"))
    jax_spans = collections.Counter(s["name"] for s in jax_run["spans"])
    # JAX's names one for one, and the port's own spans of a fused run with
    # no in-loop evaluation: the epoch's dispatch and herding's two halves.
    assert {n: port_spans[n] for n in jax_spans} == jax_spans
    assert port_spans == jax_spans + collections.Counter(
        {"epoch_replays": 2 * EPOCHS, "herd_features": 2, "herd_select": 2})
    port_types = {r["type"] for r in on["log"]}
    jax_types = {r["type"] for r in jax_run["log"]}
    assert "profile_trace" in port_types and "profile_trace" not in jax_types
    assert "recompile" in jax_types and "recompile" not in port_types
    assert port_types - {"profile_trace"} == jax_types - {"recompile"}


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """The 2-task run with telemetry and the loop's evaluation every epoch."""
    d = tmp_path_factory.mktemp("eval_every_epoch")
    with deadline(120):
        CilTrainer(_cfg(telemetry_dir=str(d), num_epochs=2, eval_every_epoch=1),
                   device="cpu").fit()
    return [json.loads(ln) for ln in open(d / "spans.jsonl")]


def test_the_ports_own_spans_sit_at_their_sites(eval_run):
    """``epoch_replays`` inside each ``epoch``, ``evaluate`` after each epoch
    inside its ``task``, and ``herd_features`` then ``herd_select`` inside
    each ``herd``, covering at least 0.8 of it."""
    spans = eval_run
    by_id = {s["span_id"]: s for s in spans}

    def parents(name):
        return [by_id[s["parent"]]["name"] for s in spans if s["name"] == name]

    assert parents("epoch_replays") == ["epoch"] * 4
    assert parents("evaluate") == ["task"] * 4
    assert parents("herd_features") == parents("herd_select") == ["herd"] * 2
    for herd in (s for s in spans if s["name"] == "herd"):
        kids = [s for s in spans if s["parent"] == herd["span_id"]]
        assert [k["name"] for k in kids] == ["herd_features", "herd_select"]
        assert all(k["task"] == herd["task"] for k in kids)
        covered = sum(k["dur_s"] for k in kids)
        assert 0.8 * herd["dur_s"] <= covered <= herd["dur_s"] + 1e-5  # 6-digit rounding
    for r in (s for s in spans if s["name"] == "epoch_replays"):
        assert (r["task"], r["epoch"]) == (by_id[r["parent"]]["task"],
                                           by_id[r["parent"]]["epoch"])
    assert "capture" not in {s["name"] for s in spans}  # the CPU captures no graph
