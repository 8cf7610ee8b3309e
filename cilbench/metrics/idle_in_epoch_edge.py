"""``idle_in_epoch_edge``: the device's idle time while the trainer is in
neither ``epoch_replays`` nor an evaluation (the epoch's index table, its
fetch and the loop's per-epoch tail), over the traced window.  With
``idle_in_replays`` and ``idle_in_eval`` it sums to the idle share.  No
``epoch_replays`` event in the trace, no reading."""

from cilbench import spanidle

REPLAYS = ("epoch_replays",)
EVAL = ("evaluate", "eval_matrix")


def read(r):
    t = r.trace
    if not spanidle.traced(t) or not spanidle.intervals(t, REPLAYS):
        return None
    inside = spanidle.overlap_ns(spanidle.intervals(t, REPLAYS + EVAL), t.gaps)
    return (sum(e - s for s, e in t.gaps) - inside) / 1e9 / t.window_s
