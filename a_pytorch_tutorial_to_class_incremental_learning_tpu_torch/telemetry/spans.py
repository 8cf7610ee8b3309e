"""Host-side span tracer: nested named regions of the task loop.

Counterpart of the JAX package's ``telemetry/spans.py``, with its records,
files and export.  The ``torch.profiler`` trace (``--profile_dir``) answers
"what did the *card* do inside one epoch"; it is heavyweight and therefore
only wraps one epoch a task (``utils/profiling.task_trace``).  This tracer is
the complement: a lightweight always-on record of what the *host* loop spent
its wall time on — build scenario, rehearsal inject, head grow, epoch, eval,
align, herd — cheap enough to run for a whole multi-hour protocol (one dict
and one JSONL line per region).

Spans nest: each carries its ``depth`` and ``parent`` id, so a reader can
reconstruct the tree and compute phase coverage (``scripts/report_run.py``
checks that depth-1 phases cover ~all of the root span's wall time — any gap
is un-attributed host time, the kind of silent stall this PR exists to make
visible).  Each span also enters a ``torch.profiler.record_function`` so
that when a profiler trace *is* active the host phases appear on its
timeline.  A span is a host-side region around whole calls; none opens or
closes while a CUDA graph is being captured (the loop's spans wrap the
epoch, never a step).

Export formats: JSONL (one ``span`` record per line, written on span exit so
a SIGKILL loses at most the open spans) and Chrome ``chrome://tracing`` /
Perfetto JSON (``export_chrome_trace``), the zero-dependency way to *see*
the loop.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, List, Optional


class SpanTracer:
    """Context-manager span API writing ``span`` records to a JSONL file.

    Disabled (``path=None``) the tracer is a pure no-op.  Every rank
    traces: process 0 keeps the legacy ``spans.jsonl`` name, process *i*
    writes ``spans_p{i}.jsonl`` (``utils.logging.process_suffixed``), and
    each record carries ``process_index`` so a merged fleet report can tell
    the streams apart.  When a :class:`~.flight.FlightRecorder` is attached,
    span opens/closes feed its open-span stack — the "what was the host doing
    at death" answer a SIGKILL'd process cannot write itself.
    """

    def __init__(
        self,
        path: Optional[str],
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        flight=None,
    ):
        if path is not None and process_index is None:
            from ..parallel.dist import get_rank, get_world_size

            process_index, process_count = get_rank(), get_world_size()
        from ..utils.logging import process_suffixed

        self.process_index = int(process_index or 0)
        self.process_count = int(process_count or 1)
        self.enabled = bool(path)
        self.path = process_suffixed(path, self.process_index) if path else None
        self.flight = flight
        self._stack: List[int] = []
        self._next_id = 0
        self.completed: List[dict] = []  # in-memory copy for export/coverage
        # Monotonic epoch offset: spans are timestamped with the monotonic
        # clock (immune to NTP steps mid-run) but exported in wall time.
        self._wall0 = time.time() - time.perf_counter()
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            open(self.path, "w").close()

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        span_id = self._next_id
        self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        depth = len(self._stack)
        self._stack.append(span_id)
        if self.flight is not None:
            self.flight.span_open(name, span_id, depth, **attrs)
        t0 = time.perf_counter()
        try:
            # Compose with the profiler: when a torch.profiler trace is
            # active the host phase shows up on the same timeline.
            with record_function(name):
                yield
        finally:
            t1 = time.perf_counter()
            self._stack.pop()
            rec = {
                "type": "span",
                "name": name,
                "span_id": span_id,
                "parent": parent,
                "depth": depth,
                "ts": round(self._wall0 + t0, 6),
                "dur_s": round(t1 - t0, 6),
                "process_index": self.process_index,
                **attrs,
            }
            self.completed.append(rec)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if self.flight is not None:
                self.flight.span_close(span_id)
                self.flight.record(rec)

    # ------------------------------------------------------------------ #
    # Analysis / export
    # ------------------------------------------------------------------ #

    def coverage(self, depth: int = 1) -> Optional[float]:
        """Fraction of the root span's wall time covered by spans at
        ``depth`` — the "is any host time unaccounted for?" number."""
        return coverage(self.completed, depth)

    def export_chrome_trace(self, path: str) -> None:
        """Write the completed spans as ``chrome://tracing`` / Perfetto JSON
        (complete-duration ``"X"`` events, microsecond timestamps).

        ``path`` is re-homed through ``process_suffixed`` (like the span
        JSONL itself), so N processes exporting the same logical name never
        race on one file: process 0 keeps ``trace.json``, process *i* writes
        ``trace_p{i}.json``."""
        if not self.enabled:
            return
        from ..utils.logging import process_suffixed

        path = process_suffixed(path, self.process_index)
        events = [
            {
                "name": rec["name"],
                "ph": "X",
                "ts": round(rec["ts"] * 1e6, 1),
                "dur": round(rec["dur_s"] * 1e6, 1),
                "pid": 0,
                "tid": 0,
                "args": {
                    k: v
                    for k, v in rec.items()
                    if k not in ("type", "name", "ts", "dur_s")
                },
            }
            for rec in self.completed
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def coverage(spans: List[dict], depth: int = 1) -> Optional[float]:
    """Phase coverage from span records (tracer-attached or re-loaded from a
    span JSONL by ``scripts/report_run.py``): sum of ``depth``-level span
    durations over the total duration of the depth-0 roots.  Siblings at one
    depth never overlap (the tracer is single-threaded), so the plain sum is
    the union.  None when there is no root to compare against."""
    roots = [s for s in spans if s.get("depth") == 0]
    if not roots:
        return None
    total = sum(s["dur_s"] for s in roots)
    if total <= 0:
        return None
    covered = sum(s["dur_s"] for s in spans if s.get("depth") == depth)
    return covered / total


def load_spans(path: str) -> List[dict]:
    """Read a span JSONL file (tolerating a truncated last line, the normal
    state after a SIGKILL)."""
    out = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("type") == "span":
                out.append(rec)
    return out
