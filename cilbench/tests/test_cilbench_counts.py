"""The frozen FLOP and byte counts."""

import ast
from pathlib import Path

import pytest

from cilbench import cebytes, flops

ROOT = Path(__file__).resolve().parents[2]


def test_resnet32_macs_at_32px():
    m = flops.resnet_macs(depth=32, input_size=32)
    assert round(m["conv"] / 1e6, 1) == 68.9
    assert m["fc"] == 64 * 100


def test_resnet32_at_224px_is_49_times():
    assert flops.resnet_macs(input_size=224)["conv"] == 49 * flops.resnet_macs(input_size=32)["conv"]


def test_train_step_flops():
    fwd = 2 * (flops.resnet_macs()["conv"] + 6400)
    assert flops.train_step_flops(128, True) == 128 * 4 * fwd
    assert flops.train_step_flops(128, False) == 128 * 3 * fwd
    assert round(flops.train_step_flops(128, True) / 1e9, 1) == 70.5


def _chip_smoke_fwd_bytes():
    src = (ROOT / "chip_smoke.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_fwd_bytes")
    ns = {}
    exec(compile(ast.Module([fn], []), "chip_smoke.py", "exec"), ns)
    return ns["_fwd_bytes"]


@pytest.mark.parametrize("b,w,esize", [(128, 100, 4), (64, 100, 4), (128, 1000, 2)])
def test_ce_forward_bytes_match_chip_smoke(b, w, esize):
    assert cebytes.fwd_bytes(b, w, esize) == _chip_smoke_fwd_bytes()(b, w, esize)


def test_ce_backward_bytes():
    # logits and their gradient, labels, num_active, lse, the upstream scalar
    assert cebytes.bwd_bytes(128, 100) == 2 * 128 * 100 * 4 + 128 * 8 + 4 + 128 * 4 + 4
