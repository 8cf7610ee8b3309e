"""Fleet front end: admission control, shedding, failover, rolling swaps.

A copy of the JAX package's ``serving/frontend.py`` with the port's
imports: the port cannot import that package, whose ``__init__`` loads
JAX.  The replicas (``replica.py``) own the work on the card; this module
owns *availability*.  It is deliberately stdlib-only — no torch, no numpy —
because it must keep routing while any replica's runtime is wedged, and
because it runs in-process under the ThreadCheck sentinel
(``analysis/threadcheck.py``): no lock is ever held across a socket read,
a ``Future.result`` or a queue operation.  The fault site
``serve.frontend`` (``frontend_ioerror``) fires before each dispatch.

* **Admission + shedding** — two priority classes (``X-Priority: high`` /
  ``low``) share one bounded in-flight budget.  Low is admitted only below
  ``low_watermark``, high up to ``capacity``; beyond that the request is
  shed with HTTP 503 and a rate-limited ``serve_shed`` record.  Shedding
  low first keeps the high-priority p99 flat through overload — the
  batching/latency tradeoff the Gemma serving comparison (arXiv:2605.25645)
  frames — and an explicit 503 beats an implicit timeout: the client knows
  *now* and can back off.
* **Failover** — a dispatch error marks the replica in the circuit breaker
  (``health.py``) and retries the next healthy replica with a
  short growing backoff (``frontend_retry`` records), all inside the
  request's deadline.  A SIGKILL'd replica costs the fleet one retry per
  in-flight request, never a failed client request.
* **Hedging** — optionally, when the primary attempt is still pending at
  the hedge point, the same request is dispatched to a second replica and
  the first success wins (the tail-at-scale move: p99 of one replica
  becomes ~p99² of two).
* **Rolling swaps** — when the artifact store publishes a newer task, the
  rollout loop swaps ONE replica at a time via its skew-gated ``/swap``
  (``InferenceServer.swap_to``).  A refused swap (injected ``swap_ioerror``,
  probe mismatch) leaves that replica on the old artifact, emits
  ``serve_rollback``, and halts the wave — the rest of the fleet keeps
  serving, and the next poll retries.  Fleet availability never depends on
  a swap succeeding.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from .health import FleetHealth

PRIORITIES = ("high", "low")


def _read_manifest(export_dir: str) -> dict:
    """Local mirror of ``artifact.read_manifest`` — same file, same
    torn-read tolerance — so this module never imports the torch-backed
    artifact machinery."""
    import os

    path = os.path.join(export_dir, "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q / 100.0 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class _Shed(Exception):
    """Request rejected at admission (becomes the 503)."""


class Frontend:
    """HTTP front end over a fleet of replica endpoints.

    ``replicas`` is the fixed address list ``[(host, port), ...]`` — replica
    i's supervisor relaunches it on the same port, so addresses are stable
    identities and health state (not the address list) tracks liveness.
    """

    def __init__(
        self,
        replicas: Sequence[Tuple[str, int]],
        port: int = 0,
        host: str = "127.0.0.1",
        capacity: int = 32,
        low_watermark: Optional[int] = None,
        default_deadline_ms: float = 2000.0,
        max_attempts: int = 4,
        retry_backoff_s: float = 0.02,
        hedge_ms: Optional[float] = None,
        error_threshold: int = 3,
        heartbeat_max_age_s: float = 0.0,
        heartbeat_paths: Optional[List[str]] = None,
        probe_s: float = 0.5,
        export_dir: Optional[str] = None,
        rollout_poll_s: Optional[float] = None,
        sink=None,
        faults=None,
        metrics=None,
    ):
        # Lazy import: telemetry/metrics.py is itself stdlib-only, but its
        # package __init__ pulls numpy — resolving it here keeps this
        # *module* importable with nothing but the stdlib.
        if metrics is None:
            from ..telemetry.metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics
        self.replicas = [(h, int(p)) for h, p in replicas]
        self.capacity = int(capacity)
        self.low_watermark = (int(low_watermark) if low_watermark is not None
                              else max(self.capacity // 2, 1))
        self.default_deadline_ms = float(default_deadline_ms)
        self.max_attempts = int(max_attempts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.hedge_ms = float(hedge_ms) if hedge_ms is not None else None
        self.probe_s = float(probe_s)
        self.export_dir = export_dir
        self.rollout_poll_s = (float(rollout_poll_s)
                               if rollout_poll_s is not None else None)
        self._sink = sink
        self._faults = faults
        self.health = FleetHealth(
            len(self.replicas),
            error_threshold=error_threshold,
            heartbeat_max_age_s=heartbeat_max_age_s,
            heartbeat_paths=heartbeat_paths,
            sink=sink,
        )

        self._lock = threading.Lock()
        self._inflight = {"high": 0, "low": 0}
        self._rr = 0  # round-robin cursor
        self._last_shed_emit: Dict[str, float] = {p: 0.0 for p in PRIORITIES}
        self._latencies: Dict[str, List[float]] = {p: [] for p in PRIORITIES}
        # Fleet counters live in the registry (the /metrics exposition the
        # scraper polls; /stats reads the same instruments).  Registry
        # updates always run OUTSIDE self._lock: the registry has its own
        # lock and the two must never nest (lock-order discipline).
        reg = self.metrics
        self._m_served = {
            p: reg.counter("fe_requests_total", priority=p)
            for p in PRIORITIES
        }
        self._m_failed = {
            p: reg.counter("fe_failed_total", priority=p) for p in PRIORITIES
        }
        self._m_shed = {
            p: reg.counter("fe_shed_total", priority=p) for p in PRIORITIES
        }
        self._m_latency = {
            p: reg.histogram("fe_latency_ms", lowest=0.5, growth=2.0,
                             buckets=18, priority=p)
            for p in PRIORITIES
        }
        self._m_inflight = {
            p: reg.gauge("fe_inflight", priority=p) for p in PRIORITIES
        }
        self._m_retries = reg.counter("fe_retries_total")
        self._m_hedges = reg.counter("fe_hedges_total")
        self._m_hedge_wins = reg.counter("fe_hedge_wins_total")
        self._m_rollout_swaps = reg.counter("fe_rollout_swaps_total")
        self._m_rollout_rollbacks = reg.counter("fe_rollout_rollbacks_total")
        self._m_ejected = reg.gauge("fe_ejected_replicas")
        self._m_ejections = reg.counter("fe_ejections_total")

        self._stop = threading.Event()
        # Hedged attempts need a second thread per request; cap the pool so
        # a hedge storm cannot spawn unbounded threads.
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=max(2 * len(self.replicas), 4),
            thread_name_prefix="frontend-hedge",
        )
        self._monitor: Optional[threading.Thread] = None
        self._rollout: Optional[threading.Thread] = None

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def _reply(self, code, body, ctype="application/json",
                       headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/stats":
                    self._reply(200, json.dumps(frontend.stats()).encode())
                elif self.path == "/healthz":
                    self._reply(200, json.dumps(
                        {"replicas": frontend.health.stats()}).encode())
                elif self.path == "/metrics":
                    self._reply(200, frontend.metrics.to_prometheus().encode(),
                                ctype="text/plain; version=0.0.4")
                else:
                    self._reply(404, b'{"error": "no route"}')

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, b'{"error": "no route"}')
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                priority = self.headers.get("X-Priority", "high").lower()
                if priority not in PRIORITIES:
                    priority = "high"
                deadline_ms = float(self.headers.get(
                    "X-Deadline-Ms", frontend.default_deadline_ms))
                try:
                    payload, hdrs = frontend.handle(body, priority,
                                                    deadline_ms)
                except _Shed as e:
                    self._reply(503, json.dumps(
                        {"shed": True, "priority": priority,
                         "reason": str(e)}).encode())
                except Exception as e:  # noqa: BLE001 — becomes the 502
                    self._reply(502, json.dumps(
                        {"error": repr(e), "priority": priority}).encode())
                else:
                    self._reply(200, payload,
                                ctype="application/octet-stream",
                                headers=hdrs)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #

    def start(self) -> "Frontend":
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="frontend-http",
            daemon=True,
        )
        self._http_thread.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="frontend-monitor", daemon=True,
        )
        self._monitor.start()
        if self.rollout_poll_s is not None and self.export_dir:
            self._rollout = threading.Thread(
                target=self._rollout_loop, name="frontend-rollout",
                daemon=True,
            )
            self._rollout.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._http_thread is not None:
            # shutdown() blocks on an event only serve_forever() sets; on a
            # never-started front end it would wait forever.
            self._httpd.shutdown()
            self._http_thread.join()
        self._httpd.server_close()
        if self._monitor is not None:
            self._monitor.join()
        if self._rollout is not None:
            self._rollout.join()
        self._hedge_pool.shutdown(wait=True)

    # ------------------------------------------------------------------ #
    # Request path
    # ------------------------------------------------------------------ #

    def handle(self, body: bytes, priority: str,
               deadline_ms: float) -> Tuple[bytes, dict]:
        """Admission → (hedged) dispatch-with-failover → response bytes.
        Raises :class:`_Shed` on admission reject, the last dispatch error
        on total failure."""
        self._admit(priority)
        t0 = time.perf_counter()
        deadline = t0 + max(deadline_ms, 1.0) / 1000.0
        try:
            payload, hdrs = self._dispatch_hedged(body, deadline)
            lat_ms = (time.perf_counter() - t0) * 1000.0
            with self._lock:
                lat = self._latencies[priority]
                lat.append(lat_ms)
                if len(lat) > 16384:
                    del lat[:-8192]
            self._m_served[priority].inc()
            self._m_latency[priority].observe(lat_ms)
            hdrs["X-Priority"] = priority
            return payload, hdrs
        except _Shed:
            raise
        except Exception:
            self._m_failed[priority].inc()
            raise
        finally:
            with self._lock:
                self._inflight[priority] -= 1
                left = self._inflight[priority]
            self._m_inflight[priority].set(left)

    def _admit(self, priority: str) -> None:
        now = time.monotonic()
        with self._lock:
            total = self._inflight["high"] + self._inflight["low"]
            limit = (self.capacity if priority == "high"
                     else self.low_watermark)
            if total < limit:
                self._inflight[priority] += 1
                now_inflight = self._inflight[priority]
            else:
                now_inflight = None
                emit = now - self._last_shed_emit[priority] > 0.5
                if emit:
                    self._last_shed_emit[priority] = now
        if now_inflight is not None:
            self._m_inflight[priority].set(now_inflight)
            return
        shed = self._m_shed[priority]
        shed.inc()
        # Sheds are per-request events at overload rates — emit at most ~2/s
        # per class, carrying the cumulative count, so the telemetry stream
        # does not amplify the very overload it reports.
        if emit and self._sink is not None:
            self._sink.log("serve_shed", priority=priority, queued=total,
                           capacity=limit, shed_total=int(shed.value))
        raise _Shed(f"over {priority} admission limit ({total}/{limit})")

    def _pick(self, exclude: frozenset) -> Optional[int]:
        """Next healthy replica after the round-robin cursor; falls back to
        any non-excluded replica when the whole fleet looks ejected (a
        wrong breaker verdict must degrade to trying, not to refusing)."""
        healthy = [i for i in self.health.healthy() if i not in exclude]
        pool = healthy or [i for i in range(len(self.replicas))
                           if i not in exclude]
        if not pool:
            return None
        with self._lock:
            self._rr += 1
            return pool[self._rr % len(pool)]

    def _dispatch_once(self, replica: int, body: bytes,
                       timeout_s: float) -> Tuple[bytes, dict]:
        if self._faults is not None:
            actions = self._faults.fire("serve.frontend", task=replica)
            if "frontend_ioerror" in actions:
                raise OSError(
                    f"fault-injected dispatch failure (replica {replica})"
                )
        host, port = self.replicas[replica]
        conn = http.client.HTTPConnection(host, port,
                                          timeout=max(timeout_s, 0.05))
        try:
            conn.request("POST", "/predict", body=body, headers={
                "Content-Type": "application/octet-stream",
            })
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise OSError(
                    f"replica {replica} returned {resp.status}: "
                    f"{payload[:128]!r}"
                )
            return payload, {
                "X-Task-Id": resp.headers.get("X-Task-Id", ""),
                "X-Replica": str(replica),
            }
        finally:
            conn.close()

    def _dispatch_chain(self, body: bytes, deadline: float,
                        exclude: frozenset, chosen: List[int],
                        ) -> Tuple[bytes, dict]:
        """Retry-with-backoff across healthy replicas until the deadline.
        ``chosen`` collects the replicas tried (the hedge excludes them)."""
        last: Optional[Exception] = None
        backoff = self.retry_backoff_s
        for attempt in range(1, self.max_attempts + 1):
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            replica = self._pick(exclude | frozenset(chosen[-1:]))
            if replica is None:
                replica = self._pick(exclude)
            if replica is None:
                raise OSError("no replica available")
            chosen.append(replica)
            try:
                payload, hdrs = self._dispatch_once(replica, body, remaining)
            except Exception as e:  # noqa: BLE001 — every flavor fails over
                last = e
                self.health.note_error(replica)
                self._m_retries.inc()
                if self._sink is not None:
                    self._sink.log("frontend_retry", replica=replica,
                                   attempt=attempt, error=repr(e))
                time.sleep(min(backoff, max(deadline - time.perf_counter(),
                                            0.0)))
                backoff *= 2
                continue
            self.health.note_ok(replica)
            return payload, hdrs
        raise last if last is not None else OSError("request deadline hit")

    def _dispatch_hedged(self, body: bytes,
                         deadline: float) -> Tuple[bytes, dict]:
        chosen: List[int] = []
        if self.hedge_ms is None or len(self.replicas) < 2:
            return self._dispatch_chain(body, deadline, frozenset(), chosen)
        primary = self._hedge_pool.submit(
            self._dispatch_chain, body, deadline, frozenset(), chosen)
        done, _ = wait([primary], timeout=self.hedge_ms / 1000.0)
        if done:
            return primary.result()
        # Primary still pending at the hedge point: race a second attempt
        # on a different replica; first success wins, the loser's result
        # is discarded (replicas are stateless per-request).
        self._m_hedges.inc()
        hedge = self._hedge_pool.submit(
            self._dispatch_chain, body, deadline,
            frozenset(chosen[:1]), [])
        futures = {primary, hedge}
        last: Optional[Exception] = None
        while futures:
            remaining = deadline - time.perf_counter() + 1.0
            done, futures = wait(futures, timeout=max(remaining, 0.05),
                                 return_when=FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                try:
                    payload, hdrs = fut.result()
                except Exception as e:  # noqa: BLE001 — other fut may win
                    last = e
                    continue
                if fut is hedge:
                    self._m_hedge_wins.inc()
                return payload, hdrs
        raise last if last is not None else OSError("request deadline hit")

    # ------------------------------------------------------------------ #
    # Health monitor + rolling swaps
    # ------------------------------------------------------------------ #

    def _monitor_loop(self) -> None:
        known_ejected: set = set()
        while not self._stop.wait(self.probe_s):
            self.health.check_heartbeats()
            ejected = set(self.health.ejected())
            # Transition counting stays local to this (single) thread; the
            # registry carries the level and the cumulative eject count.
            fresh = ejected - known_ejected
            if fresh:
                self._m_ejections.inc(len(fresh))
            self._m_ejected.set(len(ejected))
            known_ejected = ejected
            for replica in sorted(ejected):
                if self._probe_ready(replica):
                    self.health.note_ready(replica)
                    known_ejected.discard(replica)

    def _probe_ready(self, replica: int) -> bool:
        """Out-of-band ``/healthz`` probe: the replica must answer AND be
        warm (post-relaunch it accepts TCP before its programs compile)."""
        host, port = self.replicas[replica]
        conn = http.client.HTTPConnection(host, port, timeout=2.0)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            if resp.status != 200:
                return False
            info = json.loads(resp.read())
            return bool(info.get("warm"))
        except OSError:
            return False
        finally:
            conn.close()

    def _replica_task(self, replica: int) -> Optional[int]:
        host, port = self.replicas[replica]
        conn = http.client.HTTPConnection(host, port, timeout=2.0)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            task = json.loads(resp.read()).get("task_id")
            return int(task) if task is not None else None
        except (OSError, ValueError):
            return None
        finally:
            conn.close()

    def _rollout_loop(self) -> None:
        while not self._stop.wait(self.rollout_poll_s):
            try:
                self.rollout_once()
            except Exception as e:  # noqa: BLE001 — rollout must not die
                print(f"| frontend: rollout pass failed: {e!r}")

    def rollout_once(self) -> dict:
        """One rolling-swap wave: move every healthy replica that is behind
        the manifest's latest task, one at a time, halting the wave at the
        first refusal.  Idempotent — call it until it reports converged."""
        man = _read_manifest(self.export_dir) if self.export_dir else {}
        latest = man.get("latest")
        if latest is None:
            return {"converged": True, "latest": None}
        latest = int(latest)
        moved, behind = [], []
        for replica in range(len(self.replicas)):
            if not self.health.is_healthy(replica):
                behind.append(replica)  # swept into a later wave
                continue
            current = self._replica_task(replica)
            if current == latest:
                continue
            if current is None:
                # Unreachable but not (yet) ejected: liveness is the
                # breaker's verdict to make, not the rollout's — swapping
                # a dead endpoint would read as a rollback.
                behind.append(replica)
                continue
            ok, detail = self._swap_replica(replica, latest)
            if not ok:
                behind.append(replica)
                self._m_rollout_rollbacks.inc()
                if self._sink is not None:
                    self._sink.log(
                        "serve_rollback", task_id=latest,
                        rolled_back_to=current, replica=replica,
                        reason=detail,
                    )
                print(f"| frontend: replica {replica} refused swap to "
                      f"task {latest} ({detail}); wave halted")
                # One replica at a time ALSO means one failure stops the
                # wave: if the artifact itself is bad, the rest of the
                # fleet must not march into it.
                break
            moved.append(replica)
            self._m_rollout_swaps.inc()
        return {"converged": not behind and not moved, "latest": latest,
                "moved": moved, "behind": behind}

    def _swap_replica(self, replica: int, task_id: int) -> Tuple[bool, str]:
        host, port = self.replicas[replica]
        conn = http.client.HTTPConnection(host, port, timeout=120.0)
        try:
            conn.request(
                "POST", "/swap",
                body=json.dumps({"task_id": task_id}).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status == 200:
                return True, ""
            try:
                detail = json.loads(payload).get("error", payload[:128])
            except ValueError:
                detail = repr(payload[:128])
            return False, str(detail)
        except OSError as e:
            return False, repr(e)
        finally:
            conn.close()

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Same dict shape as ever; the counts are now *read back* from the
        registry (the single source of truth /metrics also exposes), while
        the percentiles keep coming from the exact latency samples."""
        with self._lock:
            inflight = dict(self._inflight)
            sorted_lat = {p: sorted(self._latencies[p]) for p in PRIORITIES}
        # Registry reads happen after self._lock is released (never nested).
        out = {
            "served": {p: int(self._m_served[p].value) for p in PRIORITIES},
            "failed": {p: int(self._m_failed[p].value) for p in PRIORITIES},
            "shed": {p: int(self._m_shed[p].value) for p in PRIORITIES},
            "retries": int(self._m_retries.value),
            "hedges": int(self._m_hedges.value),
            "hedge_wins": int(self._m_hedge_wins.value),
            "rollout_swaps": int(self._m_rollout_swaps.value),
            "rollout_rollbacks": int(self._m_rollout_rollbacks.value),
            "inflight": inflight,
            "latency_ms": {},
        }
        for p in PRIORITIES:
            vals = sorted_lat[p]
            out["latency_ms"][p] = {
                "count": len(vals),
                "p50": round(_percentile(vals, 50), 3),
                "p95": round(_percentile(vals, 95), 3),
                "p99": round(_percentile(vals, 99), 3),
            }
        out["health"] = self.health.stats()
        return out
