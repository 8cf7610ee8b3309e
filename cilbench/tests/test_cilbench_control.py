"""The control on the card: the reference computed one precision lower
(TF32, for a configuration that states float32 with TF32 off) put in the
port's place has to fail a cell's limits, where the port itself passes.
At the cell's widths, batch and recipe with fewer images, so that a test
run holds it; ``python -m cilbench.calibrate --workload NAME --seeds ...``
reads the same at the cell's full size.  Run on a CUDA machine with
``python -m pytest -m cuda cilbench/tests/test_cilbench_control.py``."""

import pytest

from cilbench import check, run
from cilbench.tests.small import ROOT, bench, config_of, load

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")


def _limits(cell):
    return load(ROOT / "cilbench" / "workloads" / f"{cell}.json")["limits"]


def _fails(numbers, limits):
    return not check.judge({k: numbers.get(k, 0) for k in limits}, limits)["correct"]


@pytest.mark.parametrize("seed", [101, 102, 103])
def test_c100_control_fails(card, seed):
    cfg = config_of("c100-epochs")
    co = {"dataset": {**cfg["dataset"], "train_per_class": 60, "test_per_class": 10}}
    res = run.run_cell("c100-epochs", seed, 1.0, False, config_override=co,
                       workload_override={"control": True}, bench=bench())
    assert res["correct"], res["checks"]
    assert _fails(res["_log"]["_control"], _limits("c100-epochs"))


@pytest.mark.parametrize("seed", [131, 132, 133])
def test_protocol_control_fails(card, seed):
    cfg = config_of("c100-protocol")
    co = {"dataset": {**cfg["dataset"], "train_per_class": 60, "test_per_class": 10}}
    res = run.run_cell("c100-protocol", seed, 1.0, False, config_override=co,
                       workload_override={"control": True}, bench=bench())
    assert res["correct"], res["checks"]
    assert _fails(res["_log"]["_control"], _limits("c100-protocol"))
