"""``idle_in_herd``: the device's idle time while the trainer is inside
``herd`` (the feature pass and the greedy selection), over the traced
window (``cilbench/spanidle.py``)."""

from cilbench import spanidle

SPANS = ("herd",)


def read(r):
    return spanidle.share(r, SPANS)
