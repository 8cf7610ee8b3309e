"""Fleet health: per-replica circuit breakers + heartbeat staleness.

A copy of the JAX package's ``serving/health.py`` (stdlib only): the port
cannot import that package, whose ``__init__`` loads JAX.

The front end must never learn a replica is dead by timing out a user's
request twice.  This module keeps the per-replica verdict the router reads
on every dispatch:

* **Consecutive-error breaker** — every failed dispatch bumps the replica's
  consecutive-error count; at ``error_threshold`` the replica is ejected
  from rotation.  Any success resets the count (errors must be
  *consecutive* — a 1%% flake rate on a busy replica is noise, not death).
* **Heartbeat staleness** — replicas run as supervised subprocesses, each
  beating into its own ``heartbeat.json`` (``telemetry/heartbeat.py``).  A
  beat older than ``heartbeat_max_age_s`` ejects the replica even though
  its TCP port may still accept connections (a wedged runtime accepts
  and hangs; the heartbeat is the liveness signal that cannot lie).
* **Re-admission** — ejection is never final: the supervisor relaunches the
  replica, and the front end's monitor probes ejected replicas out-of-band
  (``/healthz`` + warm-up flag).  ``note_ready`` puts a probed-healthy
  replica back in rotation.

Every transition emits one ``replica_ejected`` record
(``event: "eject" | "readmit"``) so the fleet-health timeline in
``report_run.py`` reconstructs exactly when capacity dipped and recovered.

Stdlib-only, and every shared field lives under one lock; the heartbeat
``os.stat`` happens outside it (threadcheck: never hold a lock across a
blocking call — a stat on wedged NFS can block for minutes).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional


class FleetHealth:
    """Rotation membership for ``n`` replicas (ids ``0..n-1``)."""

    def __init__(
        self,
        n: int,
        error_threshold: int = 3,
        heartbeat_max_age_s: float = 0.0,
        heartbeat_paths: Optional[List[str]] = None,
        sink=None,
    ):
        if n <= 0:
            raise ValueError(f"fleet needs at least one replica, got {n}")
        self.n = int(n)
        self.error_threshold = int(error_threshold)
        self.heartbeat_max_age_s = float(heartbeat_max_age_s)
        self.heartbeat_paths = list(heartbeat_paths or [])
        self._sink = sink
        self._lock = threading.Lock()
        self._consecutive: Dict[int, int] = {i: 0 for i in range(self.n)}
        self._ejected: Dict[int, bool] = {i: False for i in range(self.n)}
        self._ejections = 0
        self._readmissions = 0

    # ------------------------------------------------------------------ #
    # Dispatch feedback
    # ------------------------------------------------------------------ #

    def note_ok(self, replica: int) -> None:
        """A dispatch to ``replica`` succeeded: reset its breaker."""
        with self._lock:
            self._consecutive[replica] = 0

    def note_error(self, replica: int) -> bool:
        """A dispatch failed; returns True when this error ejects it."""
        with self._lock:
            self._consecutive[replica] += 1
            count = self._consecutive[replica]
            trip = (not self._ejected[replica]
                    and count >= self.error_threshold)
            if trip:
                self._ejected[replica] = True
                self._ejections += 1
        if trip:
            self._emit(replica, "eject", "consecutive_errors",
                       consecutive_errors=count)
        return trip

    def note_ready(self, replica: int) -> bool:
        """An out-of-band probe found the replica healthy; re-admit it.
        Returns True when this call changed its state."""
        with self._lock:
            changed = self._ejected[replica]
            self._ejected[replica] = False
            self._consecutive[replica] = 0
            if changed:
                self._readmissions += 1
        if changed:
            self._emit(replica, "readmit", "probe_ok")
        return changed

    # ------------------------------------------------------------------ #
    # Heartbeat staleness
    # ------------------------------------------------------------------ #

    def check_heartbeats(self) -> List[int]:
        """Eject every replica whose heartbeat file is stale; returns the
        replicas ejected by THIS sweep.  Disabled unless both a positive
        ``heartbeat_max_age_s`` and per-replica paths were configured.  A
        missing file is not stale (the replica may still be starting; the
        consecutive-error breaker covers a replica that never comes up)."""
        if self.heartbeat_max_age_s <= 0 or not self.heartbeat_paths:
            return []
        now = time.time()
        stale: List[tuple] = []
        for replica, path in enumerate(self.heartbeat_paths[: self.n]):
            try:
                age = now - os.stat(path).st_mtime
            except OSError:
                continue
            if age > self.heartbeat_max_age_s:
                stale.append((replica, age))
        tripped: List[int] = []
        for replica, age in stale:
            with self._lock:
                trip = not self._ejected[replica]
                if trip:
                    self._ejected[replica] = True
                    self._ejections += 1
            if trip:
                tripped.append(replica)
                self._emit(replica, "eject", "heartbeat_stale",
                           heartbeat_age_s=round(age, 1))
        return tripped

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    def healthy(self) -> List[int]:
        with self._lock:
            return [i for i in range(self.n) if not self._ejected[i]]

    def ejected(self) -> List[int]:
        with self._lock:
            return [i for i in range(self.n) if self._ejected[i]]

    def is_healthy(self, replica: int) -> bool:
        with self._lock:
            return not self._ejected[replica]

    def stats(self) -> dict:
        with self._lock:
            return {
                "healthy": [i for i in range(self.n)
                            if not self._ejected[i]],
                "ejected": [i for i in range(self.n) if self._ejected[i]],
                "ejections": self._ejections,
                "readmissions": self._readmissions,
                "consecutive_errors": dict(self._consecutive),
            }

    # ------------------------------------------------------------------ #

    def _emit(self, replica: int, event: str, reason: str, **extra) -> None:
        # Outside the lock on every path: a sink write is file I/O.
        if self._sink is not None:
            self._sink.log("replica_ejected", replica=replica, event=event,
                           reason=reason, **extra)
        print(f"| fleet: replica {replica} {event} ({reason})")
