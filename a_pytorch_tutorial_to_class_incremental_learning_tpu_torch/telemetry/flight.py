"""Flight recorder: a bounded in-memory ring of the last N telemetry events,
dumped to disk on every death path.

Counterpart of the JAX package's ``telemetry/flight.py``, with its dump
format (``flight_dump`` records in ``flight_{process_index}.json``).

The main sink (``utils.logging.JsonlLogger``) is durable for everything it
managed to write, but a crash tells its story in what was *about* to be
written: the span still open, the heartbeat that never landed, the fault that
fired one line before SIGKILL.  This module keeps the last ``capacity``
span/counter/heartbeat/fault events in a ring buffer and writes them to
``flight_{process_index}.json`` whenever the process is dying:

* **fatal exception** — ``sys.excepthook`` wrapper (dump, then chain to the
  previous hook so the traceback still prints),
* **SIGTERM** — handler dumps, restores the previous disposition and
  re-delivers the signal so the exit status stays ``killed by SIGTERM``,
* **atexit** — clean exits leave a final dump too (it is the *steady-state*
  forensic artifact: Podracer-style supervisors treat kill-and-relaunch as
  the normal lifecycle, so crash-time observability must be always on),
* **injected kill** — ``faults.FaultInjector`` accepts an ``on_fatal``
  callback the engine points at :meth:`FlightRecorder.fatal_dump`, invoked
  after the ledger write but before ``os.kill(SIGKILL)`` (SIGKILL itself is
  uncatchable),
* **heartbeat cadence** — ``telemetry.Heartbeat`` calls :meth:`dump` on every
  beat, so even an uncatchable death (OOM-killer, power loss) leaves a dump
  at most half a heartbeat interval stale.

Python signal handlers run between bytecodes on the main thread — no
async-signal-safety minefield — and every dump is an atomic same-directory
``os.replace`` so ``scripts/supervise.py`` never harvests a torn file.

Stdlib-only on purpose: the dump path must work exactly when the process is
least healthy, so it must not touch torch or the card (process identity is
passed in by the :class:`~.Telemetry` facade, which already resolved it for
the sink).
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import List, Optional

from ..utils.logging import Sink


class FlightRecorder:
    """Ring buffer of recent telemetry events + the open-span stack.

    ``record(event)`` is O(1) and lock-guarded (the heartbeat daemon thread
    and the training loop both feed it).  ``dump(reason)`` snapshots the ring
    and the spans currently open and atomically writes one ``flight_dump``
    JSON record — schema-checked like every other record this repo emits.
    """

    def __init__(
        self,
        path: str,
        capacity: int = 256,
        process_index: int = 0,
        process_count: int = 1,
        host_id: Optional[str] = None,
    ):
        self.path = path
        self.capacity = int(capacity)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.host_id = host_id
        self._events: deque = deque(maxlen=self.capacity)
        self._open_spans: List[dict] = []
        self._lock = threading.Lock()
        # Serializes the publish step (freeze re-check + os.replace) so a
        # periodic dump that snapshotted *before* a fatal dump can never
        # overwrite the forensic file *after* it.  Acquisition order is
        # always _io_lock -> _lock, never the reverse (jaxlint JL303); the
        # slow tmp-file write happens under neither (JL304).
        self._io_lock = threading.Lock()
        self._seq = 0          # total events ever recorded (dropped = seq - len)
        self._fatal = False    # a fatal dump already captured the death state
        #                        (guarded by _lock; jaxlint JL305)
        self._installed = False
        self._prev_excepthook = None
        self._prev_sigterm = None

    # ------------------------------------------------------------------ #
    # Recording
    # ------------------------------------------------------------------ #

    def record(self, event: dict) -> None:
        with self._lock:
            self._seq += 1
            self._events.append(event)

    def span_open(self, name: str, span_id: int, depth: int, **attrs) -> None:
        entry = {"name": name, "span_id": span_id, "depth": depth, **attrs}
        with self._lock:
            self._open_spans.append(entry)
            self._seq += 1
            self._events.append({
                # ring-internal forensic event, never written through the
                # sink — not part of the schema vocabulary by design
                "type": "span_open",  # jaxlint: disable=JL501
                "ts": round(time.time(), 3),
                **entry,
            })

    def span_close(self, span_id: int) -> None:
        with self._lock:
            self._open_spans = [
                s for s in self._open_spans if s["span_id"] != span_id
            ]

    def open_spans(self) -> List[dict]:
        with self._lock:
            return [dict(s) for s in self._open_spans]

    # ------------------------------------------------------------------ #
    # Dumping
    # ------------------------------------------------------------------ #

    def dump(self, reason: str = "periodic") -> Optional[dict]:
        """Periodic/close dump: atomically write the current tail as a
        ``flight_dump`` record; returns the payload (None when skipped or the
        write failed — a full disk while dying must not mask the original
        death).  A no-op once a fatal dump captured the death state: the
        heartbeat daemon keeps running for a few ms after an injected kill's
        dump, and its cadence dump must not overwrite the forensic tail."""
        return self._write_dump(reason, fatal=False)

    def fatal_dump(self, reason: str = "fatal") -> Optional[dict]:
        """Death-path dump (injected kill, SIGTERM, unhandled exception):
        freezes the on-disk tail — later periodic/atexit dumps are skipped so
        the post-mortem artifact is the state *at death*."""
        return self._write_dump(reason, fatal=True)

    def _write_dump(self, reason: str, fatal: bool = False) -> Optional[dict]:
        with self._lock:
            # The freeze gate and flag live under the lock: dump() runs on
            # the heartbeat daemon while fatal_dump() runs on whichever
            # thread is dying (jaxlint JL305 flagged the bare flag).
            if self._fatal and not fatal:
                return None
            if fatal:
                self._fatal = True
            events = list(self._events)
            open_spans = [dict(s) for s in self._open_spans]
            seq = self._seq
        payload = {
            "type": "flight_dump",
            "ts": round(time.time(), 3),
            "reason": reason,
            "pid": os.getpid(),
            "process_index": self.process_index,
            "process_count": self.process_count,
            "capacity": self.capacity,
            "dropped": max(0, seq - len(events)),
            "events": events,
            "open_spans": open_spans,
            "last_open_span": open_spans[-1]["name"] if open_spans else None,
        }
        if self.host_id is not None:
            payload["host_id"] = self.host_id
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(
                os.path.dirname(os.path.abspath(self.path)), exist_ok=True
            )
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            # Atomic publish: re-check the freeze under _io_lock so the
            # ordering "fatal dump replaced the file" -> "every later
            # periodic replace is suppressed" is airtight even when this
            # dump snapshotted before the fatal one landed.
            with self._io_lock:
                with self._lock:
                    frozen = self._fatal and not fatal
                if frozen:
                    os.unlink(tmp)
                    return None
                os.replace(tmp, self.path)  # jaxlint: disable=JL402 -- self.path is per-process by construction: the telemetry facade names it flight_{process_index}.json, and the supervisor's flight_*.json harvest glob depends on exactly that naming
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return payload

    # ------------------------------------------------------------------ #
    # Death-path installation
    # ------------------------------------------------------------------ #

    def install(self) -> None:
        """Hook the fatal-exception, SIGTERM and atexit paths (idempotent)."""
        if self._installed:
            return
        self._installed = True

        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.fatal_dump(f"exception:{exc_type.__name__}")
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _hook

        def _on_sigterm(signum, frame):
            self.fatal_dump("sigterm")
            # Restore the previous disposition and re-deliver so the exit
            # status the supervisor sees is still "killed by SIGTERM".
            signal.signal(signal.SIGTERM, self._prev_sigterm or signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            self._prev_sigterm = None  # not the main thread: skip the handler

        atexit.register(self._atexit_dump)

    def _atexit_dump(self) -> None:
        self.dump("atexit")  # the freeze gate in _write_dump handles fatal

    def uninstall(self) -> None:
        """Undo :meth:`install` (facade close; also keeps tests that build
        many Telemetry objects in one process from stacking hooks)."""
        if not self._installed:
            return
        self._installed = False
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        try:
            signal.signal(signal.SIGTERM, self._prev_sigterm or signal.SIG_DFL)
        except ValueError:
            pass  # not the main thread; install() never hooked it either
        atexit.unregister(self._atexit_dump)


class FlightSink(Sink):
    """Tee sink: every record goes to the wrapped sink *and* the flight ring.

    The engine rebinds ``self.jsonl`` to this wrapper, so everything the run
    emits (epoch/task/fault/recompile records) is in the crash tail without
    any call site changing.  Unknown attributes delegate to the inner sink —
    ``utils/checkpoint.py`` duck-types the trainer's logger (``.log`` only
    today, but delegation keeps the wrapper transparent).
    """

    def __init__(self, inner: Sink, flight: FlightRecorder):
        self.inner = inner
        self.flight = flight

    def log(self, record_type: str, **fields) -> None:
        self.flight.record({
            "type": record_type, "ts": round(time.time(), 3), **fields,
        })
        self.inner.log(record_type, **fields)

    def __getattr__(self, name):
        return getattr(self.inner, name)
