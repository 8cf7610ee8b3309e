"""The faults read on the card at each cell's own size, three seeds each:
the run with the timed path broken underneath must come out not correct.
The readings are printed, one JSON line a run, for the limits' upper
ends.  A step that leaves the state unchanged needs no run: it reads
``delta_gap`` 1 by the measure's definition.  Run with
``python -m pytest -m cuda -s cilbench/tests/test_cilbench_faults_card.py``."""

import json

import pytest

from cilbench import run
from cilbench.tests import test_cilbench_drivers as faults
from cilbench.tests.small import bench

pytestmark = pytest.mark.cuda

CASES = [
    ("c100-epochs", faults._half_batch, 2.0, {}),
    ("c100-epochs", faults._altered_augmentation, 2.0, {}),
    ("c100-protocol", faults._random_herding, 1.0, {}),
    ("c100-protocol", faults._no_alignment, 1.0, {}),
    ("c100-protocol", faults._eval_off_by_one, 1.0, {}),
    ("c100-protocol", faults._unaugmented_features, 1.0, {}),
]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the faults are read at the cells' own size")


@pytest.mark.parametrize("seed", [201, 202, 203])
@pytest.mark.parametrize("cell,fault,seconds,override", CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _, _ in CASES])
def test_fault_is_not_correct_on_the_card(card, monkeypatch, cell, fault, seconds, override,
                                          seed):
    fault(monkeypatch)
    res = run.run_cell(cell, seed, seconds, False, workload_override=override, bench=bench())
    print(json.dumps({"cell": cell, "fault": fault.__name__, "seed": seed,
                      "correct": res["correct"],
                      "checks": {k: v["value"] for k, v in res["checks"].items()}}))
    assert not res["correct"], res["checks"]
