"""``idle_in_eval.train``, ``idle_in_eval.protocol``: the device's idle
time while the trainer is inside an evaluation (``evaluate``, the loop's
own, or ``eval_matrix``, a task boundary's), over the traced window
(``cilbench/spanidle.py``)."""

from cilbench import spanidle

SPANS = ("evaluate", "eval_matrix")


def read(r):
    return spanidle.share(r, SPANS)
