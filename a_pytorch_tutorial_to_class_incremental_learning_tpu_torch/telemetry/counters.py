"""Per-epoch input-stall accounting.

Counterpart of ``StallClock`` in the JAX package's ``telemetry/counters.py``
(the recompile and device-memory counters arrive with the telemetry slice).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional


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
