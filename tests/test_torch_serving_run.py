"""The trainer's serving export on the CPU, a reload in a fresh process, and
the normalization cache.

A 2-task ``synthetic10`` run of the port's CLI with ``--export_dir
--serve_skew_check``: one ``serve_export`` and one ``serve_skew`` record a
task, the served accuracy equal to the trainer's (``skew_abs_max`` 0.0),
an ``export_artifact`` span a task, and logs that pass
``scripts/check_telemetry_schema.py``; the artifacts serve.  Then one fresh
process, whose first call is an export: it holds the repair of
``data/augment.py``'s cache of normalization constants (eager evaluation
after an export is intact), and it reloads the run's newest artifact, whose
logits must equal this process's bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
    direct_predict,
    latest_artifact,
    load_artifact,
    probe_artifact,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
ARGV = [
    "--data_set", "synthetic10", "--num_bases", "0", "--increment", "5",
    "--backbone", "resnet20", "--batch_size", "16", "--num_epochs", "1",
    "--eval_every_epoch", "100", "--memory_size", "20", "--aa", "none",
    "--color_jitter", "0", "--seed", "6",
]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The 2-task CLI run: ``(telemetry dir, export dir)``."""
    root = tmp_path_factory.mktemp("serve_cli")
    tel, export_dir = root / "tel", root / "export"
    # One intra-op thread: beside other test workers, torch's default pool
    # oversubscribes the cores.
    proc = subprocess.run(
        [sys.executable, "-m", PORT, "--platform", "cpu", *ARGV, "--telemetry_dir", str(tel),
         "--export_dir", str(export_dir), "--serve_skew_check", "--serve_buckets", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tel, export_dir


def test_cli_exports_each_task_with_zero_skew(cli_run):
    tel, export_dir = cli_run
    log = tel / "run.jsonl"
    records = [json.loads(ln) for ln in log.read_text().splitlines()]
    exports = [r for r in records if r["type"] == "serve_export"]
    skews = [r for r in records if r["type"] == "serve_skew"]
    tasks = [r for r in records if r["type"] == "task"]
    assert [r["task_id"] for r in exports] == [0, 1]
    assert [r["known"] for r in exports] == [5, 10]
    assert all(r["buckets"] == [4] and "error" not in r for r in exports)
    assert [r["task_id"] for r in skews] == [0, 1]
    for skew, task in zip(skews, tasks):
        assert skew["skew_abs_max"] == 0.0
        assert skew["served_acc_per_task"] == task["acc_per_task"]
    # The export sits between the task's cil_metrics and the teacher snapshot
    # (the metrics pump's snapshots land whenever its clock says).
    types = [r["type"] for r in records if r["type"] != "metrics_snapshot"]
    assert types.index("serve_export") == types.index("cil_metrics") + 1
    spans = [json.loads(ln) for ln in (tel / "spans.jsonl").read_text().splitlines()]
    assert sum(s["name"] == "export_artifact" for s in spans) == 2
    check = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "check_telemetry_schema.py"),
         str(log), str(tel / "spans.jsonl"), str(tel / "flight_0.json")],
        capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    task_id, path = latest_artifact(str(export_dir))
    assert task_id == 1 and path == exports[1]["path"]
    art = load_artifact(path, "cpu")
    assert probe_artifact(art)["ok"]
    x = np.random.RandomState(0).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(art.predict(x), direct_predict(path, x, "cpu"))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["model"] == {"backbone": "resnet20", "width": 10,
                             "compute_dtype": "float32", "precision": "f32",
                             "bn_group_size": 0}


@pytest.fixture(scope="module")
def fresh_process(cli_run, tmp_path_factory):
    """One new Python process whose first call is a ``torch.export``: it
    checks eager evaluation after the export, exports an artifact first and
    serves it, then reloads the CLI run's newest artifact and saves its
    logits of ``x``.  Returns ``(artifact path, x, the process's logits)``."""
    _, export_dir = cli_run
    _, apath = latest_artifact(str(export_dir))
    tmp = tmp_path_factory.mktemp("fresh")
    x = np.random.RandomState(2).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    x_npy, out_npy = str(tmp / "x.npy"), str(tmp / "out.npy")
    np.save(x_npy, x)
    prog = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "torch.set_num_threads(1)\n"
        f"from {PORT}.data.augment import AugmentConfig, eval_preprocess\n"
        f"from {PORT}.models import create_model, grow\n"
        f"from {PORT}.utils import jax_random\n"
        f"from {PORT}.serving import direct_predict, export_artifact, load_artifact\n"
        f"from {PORT}.utils.checkpoint import _model_state\n"
        "model, cfg = create_model('resnet20', 10, seed=1), AugmentConfig()\n"
        "grow(model, jax_random.key(1), 0, 5)\n"
        "model.eval()\n"
        "class Eval(torch.nn.Module):\n"
        "    def forward(self, x, na):\n"
        "        return model(eval_preprocess(x, cfg), na, train=False)[0]\n"
        "x = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (4, 32, 32, 3))"
        ".astype(np.uint8))\n"
        "na = torch.tensor(5, dtype=torch.int32)\n"
        "exported = torch.export.export(Eval(), (x, na)).module()\n"
        "with torch.no_grad():\n"
        "    eager = Eval()(x, na)\n"
        "    assert type(eager) is torch.Tensor, type(eager)\n"
        "    assert torch.equal(eager, exported(x, na))\n"
        "state = _model_state(model)\n"
        f"apath = export_artifact({str(tmp)!r}, 0, cfg, state['params'], "
        "state['batch_stats'], known=5, class_order=list(range(10)), input_size=32, "
        "channels=3, buckets=(4,), device='cpu', model_meta={'backbone': 'resnet20', "
        "'width': 10, 'precision': 'f32', 'bn_group_size': 0})\n"
        "served = load_artifact(apath, 'cpu').predict_padded(x.numpy(), 4)\n"
        "assert np.array_equal(served, direct_predict(apath, x.numpy(), 'cpu'))\n"
        "assert np.array_equal(served, eager.numpy())\n"
        "print('export first: ok')\n"
        f"art = load_artifact({apath!r}, 'cpu')\n"
        f"np.save({out_npy!r}, art.predict_padded(np.load({x_npy!r}), 4))\n"
    )
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp))
    return apath, x, proc, out_npy


def test_export_first_then_eager_eval_in_a_fresh_process(fresh_process):
    """An export as the first caller of a process leaves eager evaluation
    intact: ``eval_preprocess`` traced first (the normalization constants'
    cache once kept the tracer's tensors, and every later eager call of the
    process returned symbolic values), then eager, equals the exported
    module; likewise an artifact exported first, then ``direct_predict``."""
    _, _, proc, _ = fresh_process
    assert proc.returncode == 0 and "export first: ok" in proc.stdout, proc.stderr[-3000:]


def test_fresh_process_reload_bit_identity(fresh_process):
    """The artifact stands alone: a new Python process (no live model)
    reproduces this process's logits bitwise from the saved program and
    the checksummed weights."""
    apath, x, proc, out_npy = fresh_process
    assert proc.returncode == 0, proc.stderr[-3000:]
    here = load_artifact(apath, "cpu").predict_padded(x, 4)
    np.testing.assert_array_equal(here, np.load(out_npy))
