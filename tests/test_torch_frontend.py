"""The port's fleet front end and health breaker, and one real port replica.

The front end and the breaker are the port's copies
(``…_torch/serving/frontend.py``, ``health.py``: the port cannot import the
JAX package's ``serving``, whose ``__init__`` loads JAX), held to the
contracts of the JAX package's ``tests/test_frontend.py`` against stub HTTP
replicas (the same three routes with scriptable latency, task id and swap
verdicts): shed ordering, failover with no failed client request, the
breaker's eject and readmit, hedging, and rolling swaps that halt and roll
back on a refusal.  Then one real port replica, a supervised subprocess
(``supervised_replica_cmd``, ``--platform cpu``) over two exported
artifacts, answers ``/healthz``, ``/predict``, ``/stats`` and ``/swap``
(the first swap refused by ``swap_ioerror@task1``, then promoted).
"""

import http.client
import json
import os
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
    direct_predict,
    register_artifact,
    stop_supervised_replica,
    supervised_replica_cmd,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.frontend import (
    Frontend,
    _Shed,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.health import (
    FleetHealth,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.replica import (
    decode_logits,
    encode_image,
)
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ListSink:
    def __init__(self):
        self._lock = threading.Lock()
        self.records = []

    def log(self, rtype, **fields):
        with self._lock:
            self.records.append({"type": rtype, **fields})

    def of(self, rtype):
        with self._lock:
            return [r for r in self.records if r["type"] == rtype]


class StubReplica:
    """Scriptable replica endpoint: fixed port, adjustable latency/verdicts."""

    def __init__(self, replica_id=0, task_id=0, latency_s=0.0, swap_ok=True,
                 port=0):
        self.replica_id = replica_id
        self.task_id = task_id
        self.latency_s = latency_s
        self.swap_ok = swap_ok
        self.swap_calls = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                if code == 200 and self.path == "/predict":
                    self.send_header("X-Task-Id", str(stub.task_id))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200, {"replica": stub.replica_id,
                                  "task_id": stub.task_id, "warm": True})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                if self.path == "/swap":
                    task = json.loads(body)["task_id"]
                    stub.swap_calls.append(task)
                    if stub.swap_ok:
                        stub.task_id = task
                        self._reply(200, {"ok": True, "task_id": task})
                    else:
                        self._reply(409, {"ok": False,
                                          "error": "stub refuses the swap"})
                    return
                if stub.latency_s:
                    time.sleep(stub.latency_s)
                self._reply(200, {"replica": stub.replica_id,
                                  "task_id": stub.task_id})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()
        self._httpd.server_close()


def _post(port, path="/predict", body=b"x", headers=None, timeout=10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture
def fleet2():
    stubs = [StubReplica(0), StubReplica(1, task_id=0)]
    yield stubs
    for s in stubs:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — tests stop some stubs themselves
            pass


def test_shed_low_first_high_unharmed(fleet2):
    for s in fleet2:
        s.latency_s = 0.15
    sink = ListSink()
    fe = Frontend([("127.0.0.1", s.port) for s in fleet2],
                  capacity=2, low_watermark=1, sink=sink).start()
    try:
        outcomes = {"high": [], "low": []}
        lock = threading.Lock()

        def lo():
            st, _ = _post(fe.port, headers={"X-Priority": "low"})
            with lock:
                outcomes["low"].append(st)

        def hi():
            for _ in range(4):
                st, _ = _post(fe.port, headers={"X-Priority": "high"})
                with lock:
                    outcomes["high"].append(st)

        threads = [threading.Thread(target=lo) for _ in range(12)]
        threads.append(threading.Thread(target=hi))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        # Low takes the sheds; high takes none and never fails.
        assert outcomes["high"] == [200, 200, 200, 200]
        assert 503 in outcomes["low"]
        assert set(outcomes["low"]) <= {200, 503}
        stats = fe.stats()
        assert stats["shed"]["high"] == 0
        assert stats["shed"]["low"] >= 1
        shed_recs = sink.of("serve_shed")
        assert shed_recs and all(r["priority"] == "low" for r in shed_recs)
    finally:
        fe.stop()


def test_shed_is_an_exception_not_a_decrement():
    # White-box: a shed raised at admission must not decrement inflight
    # (the finally in handle() only runs for admitted requests).
    fe = Frontend([("127.0.0.1", 1)], capacity=1, low_watermark=1)
    fe._inflight["high"] = 1
    with pytest.raises(_Shed):
        fe._admit("low")
    assert fe._inflight == {"high": 1, "low": 0}
    fe.stop()


def test_failover_zero_failed_requests(fleet2):
    sink = ListSink()
    fe = Frontend([("127.0.0.1", s.port) for s in fleet2],
                  capacity=8, error_threshold=3, sink=sink).start()
    try:
        st, _ = _post(fe.port)
        assert st == 200
        fleet2[0].stop()  # SIGKILL stand-in: connections now refused
        statuses = [_post(fe.port)[0] for _ in range(10)]
        assert statuses == [200] * 10  # failover: zero failed requests
        assert sink.of("frontend_retry")
        assert 0 in fe.health.ejected()
    finally:
        fe.stop()


def test_breaker_ejects_and_readmits(fleet2):
    sink = ListSink()
    fe = Frontend([("127.0.0.1", s.port) for s in fleet2],
                  capacity=8, error_threshold=2, probe_s=0.1,
                  sink=sink).start()
    try:
        port0 = fleet2[0].port
        fleet2[0].stop()
        for _ in range(8):
            assert _post(fe.port)[0] == 200
        assert 0 in fe.health.ejected()
        # The replica comes back on the same port (supervised relaunch);
        # the warm /healthz probe must re-admit it without any traffic.
        fleet2[0] = StubReplica(0, port=port0)
        deadline = time.time() + 5
        while time.time() < deadline and not fe.health.is_healthy(0):
            time.sleep(0.05)
        assert fe.health.is_healthy(0)
        events = [(r["replica"], r["event"])
                  for r in sink.of("replica_ejected")]
        assert (0, "eject") in events and (0, "readmit") in events
    finally:
        fe.stop()


def test_hedged_request_returns_first_success():
    # One pathologically slow replica, one fast: whenever the round-robin
    # picks the slow one first, the hedge races the fast one and the first
    # success wins — requests never pay the slow replica's full latency.
    slow = StubReplica(0, latency_s=0.8)
    fast = StubReplica(1)
    fe = Frontend([("127.0.0.1", slow.port), ("127.0.0.1", fast.port)],
                  capacity=8, hedge_ms=60.0).start()
    try:
        t0 = time.perf_counter()
        for _ in range(6):
            assert _post(fe.port)[0] == 200
        elapsed = time.perf_counter() - t0
        assert fe.stats()["hedges"] >= 1
        # 6 sequential requests against the slow replica alone would take
        # >= 4.8 s; hedging must keep the batch well under that.
        assert elapsed < 4.0
    finally:
        fe.stop()
        slow.stop()
        fast.stop()


def test_rollout_refusal_halts_wave_and_emits_rollback(tmp_path, fleet2):
    fleet2[0].swap_ok = False
    sink = ListSink()
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"latest": 1, "artifacts": {"0": {"path": "task_000"},
                                    "1": {"path": "task_001"}}}))
    fe = Frontend([("127.0.0.1", s.port) for s in fleet2],
                  export_dir=str(tmp_path), sink=sink).start()
    try:
        out = fe.rollout_once()
        assert out["moved"] == [] and out["behind"] == [0]
        rb = sink.of("serve_rollback")
        assert len(rb) == 1 and rb[0]["replica"] == 0
        assert rb[0]["task_id"] == 1 and rb[0]["rolled_back_to"] == 0
        # The wave halted at the refusal: replica 1 was never asked.
        assert fleet2[1].swap_calls == []
        # The refusing replica relents (one-shot fault analogue): the next
        # wave converges.
        fleet2[0].swap_ok = True
        out = fe.rollout_once()
        assert sorted(out["moved"]) == [0, 1]
        assert fe.rollout_once()["converged"]
        assert [s.task_id for s in fleet2] == [1, 1]
    finally:
        fe.stop()


def test_rollout_skips_unreachable_replica_without_rollback(tmp_path):
    live = StubReplica(1, task_id=1)
    sink = ListSink()
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"latest": 1, "artifacts": {"1": {"path": "task_001"}}}))
    # Replica 0 is a dead port: reachable-never.  Liveness is the breaker's
    # verdict; the rollout must report it behind, not rolled back.
    dead = StubReplica(0)
    dead_port = dead.port
    dead.stop()
    fe = Frontend([("127.0.0.1", dead_port), ("127.0.0.1", live.port)],
                  export_dir=str(tmp_path), sink=sink).start()
    try:
        out = fe.rollout_once()
        assert out["behind"] == [0] and out["moved"] == []
        assert sink.of("serve_rollback") == []
        assert fe.stats()["rollout_rollbacks"] == 0
    finally:
        fe.stop()
        live.stop()


def test_fleet_health_heartbeat_staleness(tmp_path):
    import os

    sink = ListSink()
    paths = [str(tmp_path / f"hb_{i}.json") for i in range(2)]
    for p in paths:
        with open(p, "w") as f:
            f.write("{}")
    fh = FleetHealth(2, heartbeat_max_age_s=5.0, heartbeat_paths=paths,
                     sink=sink)
    assert fh.check_heartbeats() == []
    old = time.time() - 60.0
    os.utime(paths[1], (old, old))
    assert fh.check_heartbeats() == [1]
    assert fh.ejected() == [1]
    recs = sink.of("replica_ejected")
    assert recs[0]["reason"] == "heartbeat_stale"
    assert recs[0]["heartbeat_age_s"] >= 55.0
    # A missing file is NOT stale: a replica may simply not have telemetry.
    os.unlink(paths[0])
    assert fh.check_heartbeats() == []




# --------------------------------------------------------------------------- #
# One real replica of the port, supervised, on the CPU
# --------------------------------------------------------------------------- #


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dead(pid, timeout_s=10.0):
    """Gone, or a zombie (its parent, the supervisor, died first)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except OSError:
            return True
        time.sleep(0.1)
    return False


def _get_json(port, path, timeout=5.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _predict(port, x):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60.0)
    try:
        conn.request("POST", "/predict", body=encode_image(x),
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body[:300]
        return decode_logits(body), int(resp.getheader("X-Task-Id"))
    finally:
        conn.close()


def test_port_replica_answers_health_predict_and_swap(tmp_path):
    from test_torch_serving import _export, _model

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        export_dir, serve_dir = str(tmp_path / "export"), str(tmp_path / "serve")
        os.makedirs(export_dir)
        os.makedirs(serve_dir)
        paths = [_export(export_dir, t, _model(known, t), known, buckets=(2,))
                 for t, known in ((0, 5), (1, 10))]
    finally:
        torch.set_num_threads(threads)
    import shutil

    shutil.copytree(paths[0], os.path.join(serve_dir, "task_000"))
    register_artifact(serve_dir, 0, {"path": "task_000"})
    port, tdir = _free_port(), str(tmp_path / "tel")
    cmd = supervised_replica_cmd(REPO, serve_dir, 0, port, tdir,
                                 fault_spec="swap_ioerror@task1", platform="cpu")
    assert cmd[cmd.index("-m") + 1] == \
        "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.replica"
    os.makedirs(os.path.join(tdir, "replica_0"), exist_ok=True)
    console = open(tmp_path / "console.log", "wb")
    proc = subprocess.Popen(cmd, cwd=REPO, start_new_session=True, stdout=console,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline, info = time.time() + 180, {}
        while time.time() < deadline and not info.get("warm"):
            try:
                _, info = _get_json(port, "/healthz")
            except (OSError, ValueError):
                time.sleep(0.2)
        assert info.get("warm") and info["task_id"] == 0 and info["replica"] == 0, \
            (info, open(tmp_path / "console.log").read()[-3000:])
        x = np.random.RandomState(9).randint(0, 256, (32, 32, 3)).astype(np.uint8)
        padded = np.stack([x, np.zeros_like(x)])
        logits, task = _predict(port, x)
        assert task == 0
        np.testing.assert_array_equal(logits, direct_predict(paths[0], padded, "cpu")[0])

        shutil.copytree(paths[1], os.path.join(serve_dir, "task_001"))
        register_artifact(serve_dir, 1, {"path": "task_001"})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120.0)
        verdicts = []
        try:
            for _ in range(2):
                conn.request("POST", "/swap", body=json.dumps({"task_id": 1}).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                verdicts.append((resp.status, json.loads(resp.read())))
        finally:
            conn.close()
        assert verdicts[0][0] == 409 and verdicts[0][1]["task_id"] == 0
        assert verdicts[1][0] == 200 and verdicts[1][1]["task_id"] == 1
        logits, task = _predict(port, x)
        assert task == 1
        np.testing.assert_array_equal(logits, direct_predict(paths[1], padded, "cpu")[0])
        _, stats = _get_json(port, "/stats")
        assert stats["trace_count"] == 0 and stats["failed"] == 0
        assert stats["served"] >= 3 and stats["rollbacks"] == 1 and stats["task_id"] == 1
    finally:
        stop_supervised_replica(proc, tdir, 0)
        console.close()
    supervised = [json.loads(ln) for ln in
                  open(os.path.join(tdir, "replica_0", "supervisor.jsonl"))]
    for pid in {e["pid"] for e in supervised if e["event"] == "launch"}:
        assert _dead(pid), f"replica process {pid} outlived its stop"
    records = [json.loads(ln) for ln in
               open(os.path.join(tdir, "replica_0", "run.jsonl")) if ln.strip()]
    kinds = [r["type"] for r in records]
    assert kinds.count("serve_rollback") == 1 and kinds.count("serve_swap") == 2
    assert "compile_event" in kinds
