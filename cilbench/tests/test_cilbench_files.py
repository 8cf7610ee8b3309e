"""Every cell, configuration, driver and metric loads from its own file by
the name BENCHMARK.json gives it, and the file keeps to the contract's
shape."""

import importlib
import re

import pytest

from cilbench import run
from cilbench.tests.small import ROOT, bench, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
B = bench()


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["cilbench"]
    assert 1 <= B["run_seconds"] <= 51
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", B["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(entry):
    cfg = load(ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert entry["file"] == f"cilbench/configs/{entry['name']}.json"
    assert set(entry["reduced"]) <= set(cfg) and set(cfg["reduced"]) == set(entry["reduced"])
    assert any(w["config"] == entry["name"] for w in B["workloads"])


@pytest.mark.parametrize("entry", B["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(entry):
    wl = load(ROOT / "cilbench" / "workloads" / f"{entry['name']}.json")
    driver = importlib.import_module(f"cilbench.drivers.{wl['driver']}")
    assert callable(driver.run)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    e2e, per = run.cell_metrics(B, entry["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per
    assert all(m["moves"] in names for m in per)
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", B["per_layer"], ids=lambda m: m["name"])
def test_metric_loads_by_name(metric):
    mod = run.load_metric(metric["name"])
    assert callable(mod.read)
    moved = next(m for m in B["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("metric", B["per_layer"], ids=lambda m: m["name"])
def test_metric_reads_nothing_from_nothing(metric):
    """A reader with no trace and no counters returns no number."""
    r = run.Reading("none", {}, {}, {"batch": 1, "head_width": 1}, None)
    assert run.load_metric(metric["name"]).read(r) is None


def test_alone_it_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and cilbench/, a run
    exits non-zero and prints nothing on standard output."""
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cilbench", tmp_path / "cilbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "-m", "cilbench.run", "--workload", B["workloads"][0]["name"],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
