"""Metric smoothing and the JSONL experiment log.

Counterpart of the JAX package's ``utils/logging.py``: the same record
format (``type`` + ``ts`` + process tags + fields, one JSON object per line),
so ``scripts/summarize_results.py`` and ``scripts/compare_race.py`` read port
logs unchanged.  One process writes; multi-process runs arrive with the data
parallel slice.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import time
from collections import defaultdict, deque
from typing import Dict


def _to_float(v) -> float:
    if hasattr(v, "item"):
        return float(v.item())
    return float(v)


class SmoothedValue:
    """Sliding-window metric with global totals; formats as
    ``"{median:.4f} ({global_avg:.4f})"``."""

    def __init__(self, window_size: int = 20, fmt: str | None = None):
        self.window: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1) -> None:
        value = _to_float(value)
        self.window.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return statistics.median(self.window) if self.window else 0.0

    @property
    def avg(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.window) if self.window else 0.0

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class JsonlLogger:
    """Structured experiment log; disabled when ``path`` is falsy."""

    def __init__(self, path: str | None, append: bool = False):
        self.path = path
        self._meta = {}
        if self.path:
            self._meta = {
                "process_index": 0,
                "process_count": 1,
                "host_id": socket.gethostname(),
            }
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            if not append:
                open(self.path, "w").close()

    def log(self, record_type: str, **fields) -> None:
        if not self.path:
            return
        record = {
            "type": record_type,
            "ts": round(time.time(), 3),
            **self._meta,
            **fields,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class MetricLogger:
    """Named collection of :class:`SmoothedValue` meters."""

    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(_to_float(v))

    def __getattr__(self, attr: str):
        meters = self.__dict__.get("meters")
        if meters is not None and attr in meters:
            return meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'"
        )

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )
