"""Nothing a run imports is JAX or the JAX package; the reference imports
nothing of the port.  Compared by whole top-level names, in fresh
processes."""

import json
import subprocess
import sys

from cilbench.tests.small import ROOT, bench

JAX_SIDE = {"jax", "jaxlib", "flax", "a_pytorch_tutorial_to_class_incremental_learning_tpu"}
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_drivers_and_metrics_load_no_jax():
    wl = {w["name"] for w in bench()["workloads"]}
    code = ["import importlib, json", "from cilbench import run, calibrate"]
    for cell in sorted(wl):
        drv = json.load(open(ROOT / "cilbench" / "workloads" / f"{cell}.json"))["driver"]
        code.append(f"importlib.import_module('cilbench.drivers.{drv}')")
    for m in bench()["per_layer"]:
        code.append(f"run.load_metric({m['name']!r})")
    # the port itself, as a run loads it
    code.append(f"import {PORT}.main")
    mods = _top_level_after("\n".join(code))
    assert PORT in mods
    assert not (mods & JAX_SIDE), mods & JAX_SIDE


def test_reference_loads_nothing_of_the_port():
    mods = _top_level_after("import cilbench.reference.resnet, cilbench.reference.augment, "
                            "cilbench.reference.herding")
    assert PORT not in mods and not (mods & JAX_SIDE)
    assert "cilbench" in mods
