"""``idle_in_capture``: the device's idle time while the trainer is inside
``capture`` (a task's eager first step and its CUDA-graph capture), over
the traced window (``cilbench/spanidle.py``)."""

from cilbench import spanidle

SPANS = ("capture",)


def read(r):
    return spanidle.share(r, SPANS)
