"""Profiler hooks: ``--profile_dir``'s trace of an epoch, and what it shows.

Counterpart of the JAX package's ``utils/profiling.py``:

* :func:`task_trace` wraps a region in a ``torch.profiler`` trace (CPU and,
  on a CUDA machine, CUDA activities) and writes it as a Chrome trace
  (``chrome://tracing``, Perfetto) under ``profile_dir``; a no-op when
  profiling is off;
* :func:`kernel_table` and :func:`device_step_ms` read the card's kernel
  events of a finished profile: the counterpart of
  ``device_step_ms_from_xspaces``, the device-side witness of a step time.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def task_trace(profile_dir: Optional[str], name: str) -> Iterator[Optional[str]]:
    """Profile the wrapped region into ``<profile_dir>/<name>.trace.json``.

    Yields the trace file's path (``None`` when profiling is off) so the
    caller can log where it is.  The profiler is started and stopped
    explicitly, so an exception in the region still stops it and the trace
    up to the failure is written."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        with record_function(name):
            yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


def kernel_table(prof) -> Dict[str, List[float]]:
    """``{kernel name: [count, device µs]}`` over a finished profile's CUDA
    events; ``{}`` when it saw none (a CPU run)."""
    from torch.autograd import DeviceType

    out: Dict[str, List[float]] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = out.setdefault(evt.name, [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us()
    return out


def device_step_ms(prof, n_steps: int) -> dict:
    """The card's busy time a step over a profile of ``n_steps`` steps: the
    sum of every kernel's device time over the steps (the kernels of a
    step run back to back on one stream, so the sum is the step's device
    time), and the kernel events used.  ``{}`` without CUDA events: no
    witness rather than a zero."""
    table = kernel_table(prof)
    if not table or n_steps <= 0:
        return {}
    busy_us = sum(us for _, us in table.values())
    return {
        "trace_step_ms": round(busy_us / 1e3 / n_steps, 6),
        "trace_events_used": int(sum(c for c, _ in table.values())),
    }
