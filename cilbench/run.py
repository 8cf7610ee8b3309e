"""Run one cell of the benchmark and print its result as the last line.

    python -m cilbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell is ``BENCHMARK.json``'s entry
``NAME``; its parameters are ``cilbench/workloads/NAME.json`` (whose
``driver`` names ``cilbench/drivers/<driver>.py``), its configuration
``cilbench/configs/<config>.json``.  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` profiles the start of the window and
prints its per-layer metrics, each read by ``cilbench/metrics/<name>.py``.
Without a CUDA device with as many cards as the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "a_pytorch_tutorial_to_class_incremental_learning_tpu")


def process_age_s() -> Optional[float]:
    """Seconds since this process started (``/proc/self/stat``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


T_IMPORT = time.perf_counter()
AGE_AT_IMPORT = process_age_s()


def set_environment() -> None:
    """Kernel and build caches at fixed paths inside the checkout; no JAX
    through a library that would load it by itself."""
    cache = ROOT / "build" / "cilbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """``metrics/<name>.py``, or for a quantity split by cell
    (``idle_share.protocol``) ``metrics/<name before the first dot>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"cilbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str):
    """``(end_to_end, per_layer)`` metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def card() -> str:
    """The card's name and power limit, printed beside every number."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "--id=0"], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class Context:
    """What a driver gets: the cell's files, the seed and window, the
    device, a scratch directory, the tracer and the clocks run.py reads."""

    def __init__(self, cell, seed, seconds, trace, config, workload, device, tmp):
        from .trace import Tracer

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.config, self.workload, self.device, self.tmp = config, workload, device, tmp
        self.root = str(ROOT)
        self.tracer = Tracer(trace, workload.get("trace_seconds", 5.0))
        self.t_window0 = self.t_window1 = None
        self.phases = []  # (set-up phase, seconds since run.py was imported)

    def phase(self, name: str) -> None:
        self.phases.append((name, round(time.perf_counter() - T_IMPORT, 3)))

    def cache_dir(self) -> str:
        """A fixed directory inside the checkout for what a first run makes
        and later runs reuse."""
        p = str(ROOT / "build" / "cilbench" / "data")
        os.makedirs(p, exist_ok=True)
        return p

    def path(self, name: str) -> str:
        p = os.path.join(self.tmp, name)
        os.makedirs(p, exist_ok=True)
        return p

    def window_start(self) -> None:
        import gc

        gc.collect()
        self.t_window0 = time.perf_counter()
        self.tracer.start()

    def window_end(self) -> None:
        self.t_window1 = time.perf_counter()
        self.tracer.stop(self.sync)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event_pair(self):
        import torch

        if self.device.type != "cuda":
            return None
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def reset_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.sync()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             config_override: Optional[dict] = None, workload_override: Optional[dict] = None,
             bench: Optional[dict] = None) -> dict:
    """Run one cell and return the result object.  ``device="cpu"`` and
    the overrides are for the CPU tests: they skip the look for a card."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    workload.update(workload_override or {})
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf_entry["file"])
    config.update(config_override or {})

    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"cilbench: cell {cell} needs {entry['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(2)
    dev = torch.device(device)
    driver = importlib.import_module(f"cilbench.drivers.{workload['driver']}")
    tmp = tempfile.mkdtemp(prefix="cilbench-")
    try:
        ctx = Context(cell, seed, seconds, trace, config, workload, dev, tmp)
        out = driver.run(ctx)
        ctx.tracer.stop(ctx.sync)
        ctx.tracer.finish()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e2e_entries, per_entries = cell_metrics(bench, cell)
    if AGE_AT_IMPORT is not None:
        setup_s = AGE_AT_IMPORT + (ctx.t_window0 - T_IMPORT)
    else:
        setup_s = ctx.t_window0 - T_IMPORT
    from . import check

    verdict = check.judge(out["numbers"], workload["limits"])
    metrics = {}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": verdict["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        summary = ctx.tracer.summary
        reading = Reading(cell, config, workload, out["counters"], summary)
        for m in per_entries:
            v = load_metric(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            dev_info["busy_s"] = summary.busy_s
            dev_info["window_s"] = summary.window_s
    else:
        for m in e2e_entries:
            # A quantity split by cell ("train_img_per_s.x") is the
            # driver's "train_img_per_s".
            v = setup_s if m["name"] == "setup_s" else out["e2e"].get(
                m["name"], out["e2e"].get(m["name"].split(".")[0]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev_info
    if trace and ctx.tracer.summary is not None:
        result["breakdown"] = ctx.tracer.summary.breakdown()
    result["checks"] = verdict["checks"]
    result["_log"] = {k: v for k, v in out["numbers"].items() if k.startswith("_")}
    result["_log"].update(out.get("log", {}))
    result["_log"]["setup_phases"] = ctx.phases
    return result


class Reading:
    """What a per-layer metric reader gets: the cell, its configuration and
    parameters, the cell driver's counters (over the window's untraced part)
    and the traced window's summary (None without a trace)."""

    def __init__(self, cell, config, workload, counters, trace):
        self.cell, self.config, self.workload = cell, config, workload
        self.counters, self.trace = counters, trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser("cilbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = p.parse_args(argv)
    set_environment()
    if not (ROOT / "BENCHMARK.json").exists():
        print("cilbench: no BENCHMARK.json at the checkout's root", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"cilbench: the process loaded {bad} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 3
    from .check import print_checks

    log = result.pop("_log")
    print(f"[cilbench] {args.workload} seed {args.seed}: {json.dumps(log, default=float)} "
          f"[{card()}]", file=sys.stderr)
    print_checks(result["checks"])
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
