"""One fleet replica: an ``InferenceServer`` behind a tiny HTTP transport.

Counterpart of the JAX package's ``serving/replica.py``; it runs on the
card unless ``--platform cpu`` is given.  The resilience tier runs N of
these as *supervised subprocesses*
(``scripts/supervise.py``) off one shared artifact store, so a replica
dying — SIGKILL'd by a preemption or the injected ``replica_die`` fault —
is a routine lifecycle event (Podracer, arXiv:2104.06272): the supervisor
relaunches it with decorrelated-jitter backoff, it rebinds its fixed port
(``allow_reuse_address``), warms up, and the front end's probe re-admits
it.  Each replica beats into its own ``<telemetry_dir>/replica_<i>/``
heartbeat + flight ring, which is exactly what the front end's staleness
breaker and the supervisor's hang detection watch.

Transport is stdlib ``http.server`` with a thread per connection; payloads
are raw ``.npy`` bytes (``encode_image`` / ``decode_logits``), so a client
needs numpy and nothing else:

* ``POST /predict``  — uint8 image ``.npy`` in, logits ``.npy`` out, with
  ``X-Task-Id`` / ``X-Latency-Ms`` response headers.  Fires the
  ``serve.replica`` fault site (``replica_die`` / ``slow_replica``) before
  touching the queue — the fault strikes the replica, never the client.
* ``GET /healthz``   — ``{replica, task_id, warm, served, pid}``; ``warm``
  flips true after the post-start self-inference, and the front end's
  re-admission probe requires it (a replica that accepts TCP but has not
  compiled its programs yet would eat real traffic).
* ``POST /swap``     — ``{"task_id": T}`` → skew-gated ``swap_to`` on the
  wrapped server; HTTP 409 on rollback so the rollout loop sees the
  verdict in-band.  Replicas run ``auto_swap=False``: the fleet rolls one
  replica at a time, a watcher-per-replica racing the rollout would not.
* ``GET /stats``     — the server's stats dict + ``trace_count``.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def encode_image(x) -> bytes:
    """uint8 image array -> ``.npy`` bytes (the /predict request body)."""
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(x, np.uint8))
    return buf.getvalue()


def decode_logits(body: bytes):
    """/predict response body -> logits array."""
    import numpy as np

    return np.load(io.BytesIO(body))


class ReplicaServer:
    """HTTP wrapper around one ``InferenceServer``; serves until stopped."""

    def __init__(
        self,
        export_dir: str,
        replica_id: int,
        port: int = 0,
        host: str = "127.0.0.1",
        max_wait_ms: float = 2.0,
        telemetry=None,
        sink=None,
        faults=None,
        request_timeout_s: float = 30.0,
        metrics=None,
        device=None,
    ):
        from ..telemetry import MetricsRegistry
        from .server import InferenceServer

        self.replica_id = int(replica_id)
        self.request_timeout_s = float(request_timeout_s)
        self._faults = faults
        self._telemetry = telemetry
        self._warm = threading.Event()
        # A replica always carries a live registry (the /metrics exposition
        # the fleet scraper polls) unless the telemetry facade was built
        # with --no_metrics, in which case its NullRegistry wins.
        if metrics is None and telemetry is not None:
            metrics = getattr(telemetry, "metrics", None)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.server = InferenceServer(
            export_dir,
            max_wait_ms=max_wait_ms,
            telemetry=telemetry,
            sink=sink,
            faults=faults,
            auto_swap=False,
            replica_id=self.replica_id,
            metrics=self.metrics,
            device=device,
        )
        replica = self

        class Handler(BaseHTTPRequestHandler):
            # One replica serves many short requests; per-request log lines
            # on stderr would swamp the supervisor's event stream.
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json",
                       headers: Optional[dict] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj: dict) -> None:
                self._reply(code, json.dumps(obj).encode())

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply_json(200, replica.healthz())
                elif self.path == "/stats":
                    stats = replica.server.stats()
                    stats["replica"] = replica.replica_id
                    stats["trace_count"] = replica.server.trace_count()
                    self._reply_json(200, stats)
                elif self.path == "/metrics":
                    self._reply(
                        200,
                        replica.metrics.to_prometheus().encode(),
                        ctype="text/plain; version=0.0.4",
                    )
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/predict":
                    self._predict()
                elif self.path == "/swap":
                    self._swap()
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def _predict(self):
                body = self._body()
                try:
                    # The fault strikes before the queue: replica_die
                    # SIGKILLs this process (the supervisor relaunches),
                    # slow_replica stalls just this request.
                    if replica._faults is not None:
                        replica._faults.fire(
                            "serve.replica", task=replica.replica_id
                        )
                    x = decode_logits(body)  # same .npy codec both ways
                    fut = replica.server.submit(x)
                    res = fut.result(timeout=replica.request_timeout_s)
                except Exception as e:  # noqa: BLE001 — becomes a 500
                    self._reply_json(500, {"error": repr(e),
                                           "replica": replica.replica_id})
                    return
                import numpy as np

                out = io.BytesIO()
                np.save(out, res["logits"])
                self._reply(
                    200, out.getvalue(), ctype="application/octet-stream",
                    headers={
                        "X-Task-Id": str(res["task_id"]),
                        "X-Replica": str(replica.replica_id),
                        "X-Latency-Ms": f"{res['latency_ms']:.3f}",
                    },
                )

            def _swap(self):
                try:
                    req = json.loads(self._body() or b"{}")
                    result = replica.server.swap_to(int(req["task_id"]))
                except Exception as e:  # noqa: BLE001 — becomes a 500
                    self._reply_json(500, {"error": repr(e)})
                    return
                result["replica"] = replica.replica_id
                self._reply_json(200 if result.get("ok") else 409, result)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #

    def start(self) -> "ReplicaServer":
        self.server.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"replica-{self.replica_id}-http", daemon=True,
        )
        self._http_thread.start()
        self._warmup()
        return self

    def _warmup(self) -> None:
        """One self-inference so the first real request never pays a cold
        queue; ``warm`` gates front-end re-admission."""
        import numpy as np

        meta = self.server._artifact.meta  # artifact is set post-start
        x = np.zeros(
            (meta["input_size"], meta["input_size"], meta["channels"]),
            np.uint8,
        )
        self.server.submit(x).result(timeout=60.0)
        self._warm.set()

    def healthz(self) -> dict:
        return {
            "replica": self.replica_id,
            "task_id": self.server.task_id,
            "warm": self._warm.is_set(),
            "served": self.server.stats()["served"],
            "pid": os.getpid(),
        }

    def stop(self) -> None:
        if self._http_thread is not None:
            # shutdown() blocks on an event only serve_forever() sets; on a
            # never-started replica it would wait forever.
            self._httpd.shutdown()
            self._http_thread.join()
        self._httpd.server_close()
        self.server.stop()


# --------------------------------------------------------------------- #
# Supervised fleet launcher (subprocess side)
# --------------------------------------------------------------------- #


def supervised_replica_cmd(
    repo_root: str,
    export_dir: str,
    replica_id: int,
    port: int,
    telemetry_dir: str,
    fault_spec: Optional[str] = None,
    max_age_s: float = 15.0,
    backoff_base: float = 0.2,
    backoff_max: float = 2.0,
    check_threads: bool = False,
    check_contracts: bool = False,
    python: Optional[str] = None,
    compile_cache: Optional[str] = None,
    platform: str = "cuda",
) -> list:
    """The ``scripts/supervise.py`` command line that runs one replica of
    this package as a supervised subprocess — the same relaunch machinery
    training uses, so a SIGKILL'd replica comes back on its own with
    jittered backoff.  The replica's heartbeat lives under
    ``<telemetry_dir>/replica_<i>/``; the resume flag is disabled (a
    replica has no checkpoint to resume).  ``compile_cache`` is passed on
    to the replica, which accepts it and does nothing with it."""
    import sys

    py = python or sys.executable
    rdir = os.path.join(telemetry_dir, f"replica_{replica_id}")
    child = [
        py, "-m", f"{__package__}.replica",
        "--export_dir", export_dir,
        "--replica_id", str(replica_id),
        "--port", str(port),
        "--telemetry_dir", rdir,
        "--platform", platform,
    ]
    if fault_spec:
        child += ["--fault_spec", fault_spec,
                  "--fault_ledger", os.path.join(rdir, "fault_ledger.jsonl")]
    if check_threads:
        child.append("--check_threads")
    if check_contracts:
        child.append("--check_contracts")
    if compile_cache:
        child += ["--compile_cache", compile_cache]
    return [
        py, os.path.join(repo_root, "scripts", "supervise.py"),
    ] + [
        "--heartbeat", os.path.join(rdir, "heartbeat.json"),
        "--max_age", str(max_age_s),
        "--poll", "0.5", "--grace", "20",
        "--backoff_base", str(backoff_base),
        "--backoff_max", str(backoff_max),
        "--backoff_seed", str(1000 + replica_id),
        "--max_failures", "10", "--failure_window", "600",
        "--resume_flag", "",
        "--telemetry_dir", rdir,
        "--log", os.path.join(rdir, "supervisor.jsonl"),
        "--",
    ] + child


def stop_supervised_replica(proc, telemetry_dir: str, replica_id: int,
                            timeout_s: float = 15.0) -> None:
    """Stop one replica launched (as ``proc``) from
    :func:`supervised_replica_cmd`, and every replica process its
    supervisor launched.  The supervisor starts each child in a session of
    its own and does not pass a signal on, so killing the supervisor's
    group alone would leave the replica serving: the supervisor goes first
    (it can relaunch nothing after), then each child's group, by the pids
    of the supervisor log's ``launch`` events."""
    import json
    import signal
    import subprocess

    log = os.path.join(telemetry_dir, f"replica_{replica_id}", "supervisor.jsonl")
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        pass
    pids = set()
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                try:
                    event = json.loads(line)
                except ValueError:
                    continue
                if event.get("event") == "launch" and event.get("pid"):
                    pids.add(int(event["pid"]))
    for pid in pids:
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def main(argv=None) -> int:
    """``python -m
    a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.replica``
    — one replica process, serves until SIGTERM/SIGKILL.  Run under
    ``scripts/supervise.py`` in fleets."""
    import argparse

    from ..utils.platform import resolve_device

    p = argparse.ArgumentParser("cil-tpu serving replica (PyTorch)")
    p.add_argument("--export_dir", required=True)
    p.add_argument("--replica_id", type=int, required=True)
    p.add_argument("--port", type=int, required=True,
                   help="fixed port: the supervisor's relaunch must rebind "
                   "the address the front end already routes to")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--telemetry_dir", default=None)
    p.add_argument("--fault_spec", default=None)
    p.add_argument("--fault_ledger", default=None)
    p.add_argument("--check_threads", action="store_true")
    p.add_argument("--check_contracts", action="store_true")
    p.add_argument("--compile_cache", default=None,
                   help="accepted for parity; the port compiles no XLA "
                   "programs (a replica captures its graphs at load)")
    p.add_argument("--heartbeat_s", type=float, default=2.0)
    p.add_argument("--metrics_interval_s", type=float, default=2.0,
                   help="MetricsPump flush cadence for metrics_snapshot "
                   "records + the heartbeat's serve-qps digest")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where the artifacts load: cuda (an error without a "
                   "CUDA device) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.platform)

    check = None
    if args.check_threads:
        from analysis import threadcheck

        check = threadcheck.install()
    contracts = None
    if args.check_contracts:
        from analysis import contractcheck

        contracts = contractcheck.install()

    telemetry = None
    sink = None
    if args.telemetry_dir:
        from ..telemetry import Telemetry
        from ..utils.logging import JsonlLogger

        os.makedirs(args.telemetry_dir, exist_ok=True)
        sink = JsonlLogger(os.path.join(args.telemetry_dir, "run.jsonl"))
        if contracts is not None:
            from analysis import contractcheck

            sink = contractcheck.wrap_sink(sink)
        telemetry = Telemetry(
            telemetry_dir=args.telemetry_dir, sink=sink,
            heartbeat_interval_s=args.heartbeat_s,
            metrics_interval_s=args.metrics_interval_s,
            metrics_source="replica", devices=[device],
        )
        if check is not None:
            check.bind_sink(telemetry.sink)
        if contracts is not None:
            from analysis import contractcheck

            contracts.bind_sink(telemetry.sink)
            telemetry.metrics = contractcheck.wrap_registry(telemetry.metrics)

    # Price the load: a compile is a bucket's graph capture on the card.
    from ..telemetry import CompileWatch

    watch = CompileWatch.install()
    watch_before = watch.snapshot()

    faults = None
    if args.fault_spec:
        from faults.injector import injector_from

        faults = injector_from(
            args.fault_spec, ledger_path=args.fault_ledger,
            sink=telemetry.sink if telemetry is not None else sink,
        )

    replica = ReplicaServer(
        args.export_dir,
        replica_id=args.replica_id,
        port=args.port,
        host=args.host,
        max_wait_ms=args.max_wait_ms,
        telemetry=telemetry,
        sink=sink,
        faults=faults,
        device=device,
    ).start()
    compile_delta = CompileWatch.delta(watch_before, watch.snapshot())
    if sink is not None:
        sink.log("compile_event", task_id=int(replica.server.task_id or 0),
                 source="replica", **compile_delta)
    if telemetry is not None:
        telemetry.heartbeat.update(force=True, phase="serve",
                                   task=replica.server.task_id or 0)
        telemetry.heartbeat.start()
    print(f"| replica {args.replica_id} serving task "
          f"{replica.server.task_id} on {replica.host}:{replica.port} "
          f"({device}, compile_s={compile_delta['compile_s']})",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        replica.stop()
        if telemetry is not None:
            telemetry.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
