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
is un-attributed host time, the kind of silent stall the spans exist to make
visible).  A span is a host-side region around whole calls; none opens or
closes while a CUDA graph is being captured (the loop's spans wrap the
epoch, its replays, the capture from outside, never a step).

The profiler: a span opened while a ``torch.profiler`` trace is active
(``torch._C._autograd._profiler_enabled()``) enters a
``torch.profiler.record_function`` of its name, so the host phases appear on
the trace's timeline; with no profiler running it makes no such call.  This
holds for a tracer without a path too (a run without ``--telemetry_dir``):
it writes nothing and keeps nothing, and is a pure no-op unless a profiler
is on, when it only annotates.

The clock: a record's ``ts`` is ``time.time_ns()`` read as the span opens,
the Unix clock the profiler stamps its host events with, so a span and its
profiler event start together (in seconds, to the microsecond); ``dur_s``
is measured on ``time.perf_counter``.

Export formats: JSONL (one ``span`` record per line, written and flushed on
span exit through one line-buffered handle that :meth:`SpanTracer.close`
closes, so a SIGKILL loses at most the open spans) and Chrome
``chrome://tracing`` / Perfetto JSON (``export_chrome_trace``), the
zero-dependency way to *see* the loop.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import ContextManager, Iterator, List, Optional

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


class SpanTracer:
    """Context-manager span API writing ``span`` records to a JSONL file.

    Without a path (``path=None``) the tracer records nothing: its spans
    only annotate an active profiler.  Every rank traces: process 0 keeps
    the legacy ``spans.jsonl`` name, process *i* writes ``spans_p{i}.jsonl``
    (``utils.logging.process_suffixed``), and each record carries
    ``process_index`` so a merged fleet report can tell the streams apart.
    When a :class:`~.flight.FlightRecorder` is attached, span opens/closes
    feed its open-span stack — the "what was the host doing at death" answer
    a SIGKILL'd process cannot write itself.
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
        self._file = None
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._file = open(self.path, "w", buffering=1)

    def span(self, name: str, **attrs) -> ContextManager[None]:
        """The region ``name``: a ``record_function`` while a profiler is
        on, and a ``span`` record with a path."""
        if self.enabled:
            return self._recorded(name, attrs)
        return record_function(name) if _profiler_enabled() else _NO_SPAN

    @contextlib.contextmanager
    def _recorded(self, name: str, attrs: dict) -> Iterator[None]:
        span_id = self._next_id
        self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        depth = len(self._stack)
        self._stack.append(span_id)
        if self.flight is not None:
            self.flight.span_open(name, span_id, depth, **attrs)
        ts_ns = time.time_ns()
        t0 = time.perf_counter()
        try:
            with record_function(name) if _profiler_enabled() else _NO_SPAN:
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
                "ts": round(ts_ns / 1e9, 6),
                "dur_s": round(t1 - t0, 6),
                "process_index": self.process_index,
                **attrs,
            }
            self.completed.append(rec)
            self._write(rec)
            if self.flight is not None:
                self.flight.span_close(span_id)
                self.flight.record(rec)

    def _write(self, rec: dict) -> None:
        """One line through the open handle (line-buffered: each record is
        flushed as it is written); a span after :meth:`close` appends
        through a new one."""
        if self._file is None:
            self._file = open(self.path, "a", buffering=1)
        self._file.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        """Close the JSONL handle (the end of a run)."""
        if self._file is not None:
            self._file.close()
            self._file = None

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
