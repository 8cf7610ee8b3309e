"""The device's idle time while the trainer is inside named spans.

The port's spans enter a ``torch.profiler.record_function`` of their name
while a profiler is on, so a traced window holds them as host events on the
trainer's thread (the only thread that opens them).  :func:`idle_in` takes
the instants inside any host event of the given names, intersects their
union with the window's idle gaps (``TraceSummary.gaps``) and sums the
seconds; :func:`share` divides that by the window.  Both read nothing
(None) from a trace without device kernels (a CPU run) or without an event
of those names (a commit whose program opens no such span)."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from cilbench.trace import TraceSummary, _union


def intervals(t: TraceSummary, names: Iterable[str]) -> List[Tuple[int, int]]:
    """The union of the host events named in ``names``, sorted and disjoint."""
    names = set(names)
    return _union([(s, e) for n, s, e, _, _ in t.host if n in names])


def overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    out, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def traced(t: Optional[TraceSummary]) -> bool:
    """A trace with a window and device kernels in it."""
    return t is not None and t.window_s > 0 and bool(t.kernels)


def idle_in(t: Optional[TraceSummary], names: Iterable[str]) -> Optional[float]:
    """Seconds of device idle time inside the spans ``names``."""
    if not traced(t):
        return None
    spans = intervals(t, names)
    if not spans:
        return None
    return overlap_ns(spans, t.gaps) / 1e9


def share(r, names: Iterable[str]) -> Optional[float]:
    """:func:`idle_in` over the traced window's length."""
    idle = idle_in(r.trace, names)
    return None if idle is None else idle / r.trace.window_s
