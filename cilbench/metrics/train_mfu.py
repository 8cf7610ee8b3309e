"""``train_mfu``: the model FLOPs of the window's steps (after the traced
part; ``cilbench/flops.py``: student forward and backward, the teacher's
forward) over that time, as a share of the published peak of the
configuration's precision (``cilbench/peaks.py``)."""

from cilbench import flops, peaks


def read(r):
    c, cfg = r.counters, r.config
    if not c.get("steps") or not c.get("window_s"):
        return None
    per_step = flops.train_step_flops(
        c["batch"], c["teacher"], depth=cfg["depth"], input_size=cfg["input_size"],
        channels=cfg["channels"], head_width=cfg["head_width"])
    rate = per_step * c["steps"] / c["window_s"]
    return 100.0 * rate / peaks.flop_peak(cfg["precision"], cfg["tf32"])
