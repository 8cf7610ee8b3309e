"""``idle_in_replays``: the device's idle time while the trainer is inside
``epoch_replays`` (a fused epoch's dispatch: the gaps between its graph
replays), over the traced window (``cilbench/spanidle.py``)."""

from cilbench import spanidle

SPANS = ("epoch_replays",)


def read(r):
    return spanidle.share(r, SPANS)
