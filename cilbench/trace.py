"""The traced window: ``torch.profiler`` over part of a run's window, read
into plain lists that the per-layer metric readers take.

Times are the profiler's nanoseconds.  ``busy_s`` is the length of the
union of the device's kernel and copy intervals inside the traced window,
``window_s`` that window's length, so the idle share is ``1 - busy/window``
whatever the number of streams."""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # (name, start_ns, end_ns, correlation) of each device activity
    kernels: List[Tuple[str, int, int, int]] = field(default_factory=list)
    # (name, start_ns, end_ns, thread, correlation) of each host event
    host: List[Tuple[str, int, int, int, int]] = field(default_factory=list)
    # (name, start_ns, end_ns) of each device-side user annotation
    device_annotations: List[Tuple[str, int, int]] = field(default_factory=list)
    gaps: List[Tuple[int, int]] = field(default_factory=list)

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.kernels:
            out[name] += (e - s) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event around their middle."""
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            label = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "no host event"
            named.append([f"{label}", (e - s) / 1e9])
        return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": named}


class Tracer:
    """Profiles from :meth:`start` until :meth:`stop` (or the first
    :meth:`tick` after ``seconds``); inactive when ``enabled`` is False."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self._t0 = 0.0
        self.summary: Optional[TraceSummary] = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()
        self.t0_ns = time.time_ns()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.t1_ns

    def tick(self, sync=None) -> None:
        """Stop once the traced window has lasted ``seconds``."""
        if self.active and time.perf_counter() - self._t0 >= self.seconds:
            self.stop(sync)

    def stop(self, sync=None) -> None:
        if not self.active:
            return
        if sync is not None:
            sync()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def finish(self) -> Optional[TraceSummary]:
        """Read the stopped profile (after the window: the reading takes
        seconds)."""
        if self.prof is not None and self.t1_ns and self.summary is None:
            self.summary = summarize(self.prof, self.t0_ns, self.t1_ns)
            self.prof = None
        return self.summary


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(prof, t0_ns: int, t1_ns: int) -> TraceSummary:
    """Read a stopped profile.  The window is clipped to the span of the
    host events it saw, so clock offsets between host and profiler do not
    widen it."""
    kernels, host, dev_ann = [], [], []
    for e in prof.profiler.kineto_results.events():
        s, t = int(e.start_ns()), int(e.end_ns())
        dev = str(e.device_type()).endswith("CUDA")
        if dev:
            if e.is_user_annotation():
                dev_ann.append((e.name(), s, t))
            else:
                kernels.append((e.name(), s, t, int(e.correlation_id())))
        else:
            host.append((e.name(), s, t, int(e.start_thread_id()), int(e.correlation_id())))
    if host:
        lo = max(t0_ns, min(h[1] for h in host))
        hi = min(t1_ns, max(h[2] for h in host))
    else:
        lo, hi = t0_ns, t1_ns
    hi = max(hi, lo + 1)
    busy = _union([(max(s, lo), min(t, hi)) for _, s, t, _ in kernels if t > lo and s < hi])
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, kernels=kernels,
                        host=host, device_annotations=dev_ann, gaps=gaps)
