"""Input-stall, recompile and device-memory counters.

Counterpart of the JAX package's ``telemetry/counters.py``:

* :class:`StallClock` — per epoch, the host's wall time producing data
  against the time it waits on the card;
* :class:`RecompileMonitor` — counts the programs the engine's tracked
  callables hold.  In the port a program is a captured CUDA graph: the fused
  epoch (``engine/train.py`` ``EpochFn``) exposes ``_cache_size()``, the
  graphs it captured so far, where JAX counts jit cache entries.  Eager
  steps hold no program, so on the CPU and at N > 1 ranks it reads 0;
* :func:`hbm_stats` — the card's memory at a task boundary, under JAX's
  keys (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``); ``{}``
  on the CPU, as XLA:CPU reports none.
"""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, Optional

from ..utils.logging import NullSink, Sink


class StallClock:
    """Per-epoch host-vs-device wall-time accounting.

    The epoch loop charges every interval to one bucket: ``host`` (batch
    index math, uint8 gather, the host-to-device copy) or ``device`` (step
    dispatch and the final metrics fetch, i.e. time the host spends waiting
    on the card).  ``stall_frac = host / (host + device)`` reads as the
    share of the epoch the card was starved by the input pipeline.
    """

    def __init__(self):
        self.host_s = 0.0
        self.device_s = 0.0
        # Filled in by a DevicePrefetcher at shutdown: ring depth and mean
        # fill fraction.  None until a prefetcher reports, so epochs without
        # one carry no invented zeros.
        self.prefetch_depth: Optional[int] = None
        self.prefetch_occupancy: Optional[float] = None

    @contextmanager
    def host(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_s += time.perf_counter() - t0

    @contextmanager
    def device(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.device_s += time.perf_counter() - t0

    def add_host(self, dt: float) -> None:
        self.host_s += dt

    def set_prefetch(self, depth: int, occupancy: float) -> None:
        """Record the prefetcher's ring state for this epoch: with
        prefetching on, ``host_s`` holds only the residual (non-overlapped)
        production time, and the occupancy says why (~1.0: the producer
        stayed ahead; ~0: the consumer drained the ring)."""
        if depth > 0:
            self.prefetch_depth = int(depth)
            self.prefetch_occupancy = float(occupancy)

    @property
    def stall_frac(self) -> float:
        total = self.host_s + self.device_s
        return self.host_s / total if total > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        snap = {
            "host_s": round(self.host_s, 4),
            "device_s": round(self.device_s, 4),
            "stall_frac": round(self.stall_frac, 4),
        }
        if self.prefetch_depth is not None:
            snap["prefetch_depth"] = self.prefetch_depth
            snap["prefetch_depth_occupancy"] = round(self.prefetch_occupancy or 0.0, 4)
        return snap


def clocked(batches: Iterable, clock: StallClock) -> Iterator:
    """Charge the production time of each batch (the time inside
    ``next()``) to ``clock``'s host bucket."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        finally:
            clock.add_host(time.perf_counter() - t0)
        yield batch


class RecompileMonitor:
    """Detect unexpected program growth.

    Every callable of the engine with a ``_cache_size()`` is registered with
    ``track`` in a group (train / eval / feature, as in JAX, where their
    legitimate first-compile moments differ); the sum over a group is its
    programs so far.  ``check(...)`` diffs that sum against the group's last
    check: growth at an *expected* point (a task's first executed epoch,
    which captures the task's graph) emits a ``recompile`` record; growth
    anywhere else also emits ``recompile_warning`` and a Python warning.
    """

    def __init__(self, sink: Optional[Sink] = None):
        self.sink = sink or NullSink()
        self._fns: Dict[str, object] = {}
        self._groups: Dict[str, str] = {}
        self._last: Dict[Optional[str], int] = {}

    def track(self, name: str, fn, group: str = "default") -> None:
        if hasattr(fn, "_cache_size"):
            self._fns[name] = fn
            self._groups[name] = group

    def total(self, group: Optional[str] = None) -> int:
        return sum(
            int(fn._cache_size())
            for name, fn in self._fns.items()
            if group is None or self._groups[name] == group
        )

    def check(self, where: str, expected: bool, group: Optional[str] = None,
              **attrs) -> int:
        """Diff the program count; returns the delta (0 = no new programs)."""
        total = self.total(group)
        delta = total - self._last.get(group, 0)
        self._last[group] = total
        if group is not None:
            attrs["group"] = group
        if delta > 0:
            self.sink.log("recompile", where=where, new_programs=delta,
                          total_programs=total, expected=expected, **attrs)
            if not expected:
                self.sink.log("recompile_warning", where=where, new_programs=delta,
                              total_programs=total, **attrs)
                warnings.warn(
                    f"unexpected CUDA graph capture at {where}: {delta} new program(s), "
                    f"{total} total — a tensor the captured step reads was rebound "
                    "where the engine promises to reuse the task's graph",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return delta


def hbm_stats(devices=None) -> Dict[str, Dict[str, int]]:
    """The memory of each CUDA device in ``devices`` (default: the current
    one), keyed ``cuda:<i>``: the caching allocator's ``bytes_in_use`` and
    ``peak_bytes_in_use`` (``memory_allocated`` / ``max_memory_allocated``)
    and the card's ``bytes_limit`` (``mem_get_info``'s total).  CPU devices
    report nothing, so a CPU run gets ``{}`` and its caller logs no record
    rather than invented zeros.  ``mem_get_info`` asks the CUDA runtime: the
    trainer makes it at a task boundary, on its own thread."""
    import torch

    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())] \
            if torch.cuda.is_available() else []
    out: Dict[str, Dict[str, int]] = {}
    for dev in map(torch.device, devices):
        if dev.type != "cuda":
            continue
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _free, total = torch.cuda.mem_get_info(dev)
        out[str(dev)] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(total),
        }
    return out
