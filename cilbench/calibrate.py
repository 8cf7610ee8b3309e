"""Readings that set a cell's limits: the port's numbers and the
control's (the reference computed one precision lower, TF32 for f32 with
TF32 off, put in the port's place) over many seeds, in one process.

    python -m cilbench.calibrate --workload NAME --seeds 1,2,3 [--seconds 1]

prints one JSON line a seed: ``{"seed", "numbers", "control"}``.  The
benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser("cilbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default=1.0, type=float)
    p.add_argument("--override", default="{}", help="JSON merged into the cell's parameters")
    args = p.parse_args(argv)
    run.set_environment()
    wo = {"control": True, **json.loads(args.override)}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, args.seconds, False, workload_override=wo)
        log = res["_log"]
        numbers = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"seed": seed, "correct": res["correct"], "numbers": numbers,
                          "control": log.get("_control"), "worst": log.get("_worst"),
                          "metrics": res["metrics"], "wall_s": time.perf_counter() - t0},
                         default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
