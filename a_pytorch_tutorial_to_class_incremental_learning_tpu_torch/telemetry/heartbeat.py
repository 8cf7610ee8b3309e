"""In-process liveness heartbeat.

Counterpart of the JAX package's ``telemetry/heartbeat.py``, with its file
format and per-process names, so ``scripts/supervise.py``'s hang probe and
``read_heartbeat`` read the port's files as they stand.  The training
process itself atomically rewrites one small JSON file on a cadence, so a
watchdog *reads* "alive, on task 3 epoch 41" instead of probing the card.

Contract (consumed by the watchdog and documented in README):

* the file is a single JSON object: ``{"type": "heartbeat", "ts", "mono",
  "seq", "pid", "process_index", "step", "task", "epoch", "phase",
  "last_step_ms"}``; ``ts`` is wall-clock seconds, ``mono`` the monotonic
  clock at the same instant, ``seq`` strictly monotonic;
* it is replaced atomically (write temp + ``os.replace`` on the same
  filesystem), so a reader never sees a partial write;
* during a live run its age never exceeds ~2x the configured interval.

Long blocking calls (a graph capture, a fused-epoch device wait) release the
GIL, so the optional background thread keeps beating through them — the loop
only has to ``update()`` the state fields; the thread owns the cadence.  The
thread writes files only: it never touches CUDA.  While it runs, a forced
beat from the loop is stamped and put in the flight ring at once, in the
loop's order, and the thread writes its file and the flight dump: the loop
never waits on the disk (two fsyncs a beat, five beats a task).  This
departs from the JAX package, whose forced beats write on the loop's
thread; the files and the ring are the same.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class Heartbeat:
    """Atomic heartbeat-file emitter.

    ``update(**state)`` is called from the training loop (cheap: stores the
    fields and writes only when the interval elapsed).  ``start()`` spawns a
    daemon thread that keeps writing the latest state every ``interval_s/2``
    even while the loop is stuck inside one long call; ``stop()`` joins it
    and writes a final beat.  Disabled (``path=None``) every method is a
    no-op.  Every rank beats into its *own* file (process 0 keeps the
    legacy name, process *i* gets ``heartbeat_p{i}.json``), each beat tagged
    with ``process_index`` plus a monotonic-clock ``mono`` field — the
    ``(ts, mono)`` pair is what ``scripts/report_run.py`` uses to align
    clock-skewed per-process streams.  With a
    :class:`~.flight.FlightRecorder` attached, every beat also lands in the
    flight ring and triggers a periodic flight dump, so even an uncatchable
    death leaves a dump at most half an interval stale.
    """

    def __init__(
        self,
        path: Optional[str],
        interval_s: float = 15.0,
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
        self.interval_s = float(interval_s)
        self._seq = 0
        self._state = {}
        self._last_write = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._pending: Optional[dict] = None  # a forced beat the thread writes
        self._thread: Optional[threading.Thread] = None
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._write()

    # ------------------------------------------------------------------ #

    def update(self, force: bool = False, **state) -> None:
        """Record the loop's latest position; write if the cadence is due."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            self._state.update({k: v for k, v in state.items() if v is not None})
            # _last_write is written by the daemon thread under the lock;
            # reading it outside raced the cadence decision (jaxlint JL305).
            due = force or now - self._last_write >= self.interval_s
        if not due:
            return
        if self._thread is None:
            self._write()
            return
        payload = self._beat()
        with self._lock:
            self._pending = payload
        self._wake.set()

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="cil-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=self.interval_s + 5.0)
            self._thread = None
        with self._lock:
            payload, self._pending = self._pending, None
        if payload is not None:
            self._persist(payload)
        if self.enabled:
            self._write()  # final beat: the freshest possible "last seen"

    # ------------------------------------------------------------------ #

    def _run(self) -> None:
        # Half the interval keeps worst-case staleness (a beat just missed
        # plus a full sleep) under the 2x-interval freshness contract.
        while True:
            woken = self._wake.wait(self.interval_s / 2.0)
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._lock:
                payload, self._pending = self._pending, None
            if payload is not None:
                self._persist(payload)  # a forced beat of the loop's
            elif not woken:
                self._write()  # the cadence

    def _write(self) -> None:
        self._persist(self._beat())

    def _beat(self) -> dict:
        """Stamp the next beat and record it in the flight ring."""
        with self._lock:
            self._seq += 1
            payload = {
                "type": "heartbeat",
                "ts": round(time.time(), 3),
                # Monotonic stamp beside the wall stamp: (ts - mono) is a
                # per-process clock offset, so a merged report can align
                # streams whose wall clocks disagree (NTP skew across hosts).
                "mono": round(time.monotonic(), 3),
                "seq": self._seq,
                "pid": os.getpid(),
                "process_index": self.process_index,
                **self._state,
            }
        if self.flight is not None:
            self.flight.record(payload)
        return payload

    def _persist(self, payload: dict) -> None:
        """Write the beat's file atomically, then dump the flight ring."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            # Same-directory rename: atomic on POSIX, so a concurrent reader
            # (the watchdog) sees either the old or the new beat, never a
            # torn write.
            os.replace(tmp, self.path)
            # Under the lock: _persist runs on both the daemon thread and
            # the training loop (update/stop), and update() reads this stamp
            # to decide cadence (jaxlint JL301).
            with self._lock:
                self._last_write = time.monotonic()
            if self.flight is not None:
                self.flight.dump("heartbeat")
        except OSError:
            # A full disk must not kill training; staleness is the signal.
            try:
                os.unlink(tmp)
            except OSError:
                pass


def read_heartbeat(path: str, max_age_s: float) -> dict:
    """Watchdog-side read: the parsed beat plus ``age_s`` and ``fresh``.

    ``fresh`` is False when the file is missing, unparsable, or older than
    ``max_age_s`` (the contract says 2x the emitter's interval).
    """
    try:
        with open(path) as f:
            beat = json.load(f)
        age = time.time() - float(beat["ts"])
    except (OSError, ValueError, KeyError):
        return {"fresh": False}
    beat["age_s"] = round(age, 3)
    beat["fresh"] = age <= max_age_s
    return beat
