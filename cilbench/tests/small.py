"""Small settings of each cell for the CPU tests: the same drivers, the
same widths and recipe, fewer images, with the kernels' plain versions."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return load(ROOT / "BENCHMARK.json")


def config_of(cell: str) -> dict:
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    conf = next(c for c in b["configs"] if c["name"] == entry["config"])
    return load(ROOT / conf["file"])


def argv_set(argv, **kv):
    argv = list(argv)
    for k, v in kv.items():
        flag = f"--{k}"
        if flag in argv:
            argv[argv.index(flag) + 1] = str(v)
        else:
            argv += [flag, str(v)]
    return argv


def overrides(cell: str):
    """``(config_override, workload_override)`` of ``cell`` at a CPU size."""
    cfg = config_of(cell)
    if cell == "c100-epochs":
        return ({"argv": argv_set(cfg["argv"], batch_size=128),
                 "dataset": {**cfg["dataset"], "train_per_class": 24, "test_per_class": 2}}, {})
    if cell == "c100-protocol":  # two tasks of 50 classes: a whole protocol in seconds
        return ({"argv": argv_set(cfg["argv"], batch_size=128, increment=50), "increment": 50,
                 "dataset": {**cfg["dataset"], "train_per_class": 6, "test_per_class": 2}},
                {"protocol_s": 1.0})
    raise KeyError(cell)


def run_small(cell: str, seed: int = 7, seconds: float = 1.0, trace: bool = False, **extra):
    from cilbench import run

    co, wo = overrides(cell)
    wo = {**wo, **extra}
    return run.run_cell(cell, seed, seconds, trace, device="cpu", config_override=co,
                        workload_override=wo, bench=bench())
