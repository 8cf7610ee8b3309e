"""Hot-swapping micro-batching inference server over exported artifacts.

Counterpart of the JAX package's ``serving/server.py``: the same threads,
records, registry series and fault site.  Stdlib threading only (the work
on the card all lives in the artifacts' captured graphs):

* **Batcher thread** — drains the request queue into micro-batches: the
  first request opens a batch, further requests join until either the
  largest bucket fills or the max-wait deadline passes; the batch is padded
  to the smallest covering bucket and dispatched as ONE replay of that
  bucket's CUDA graph (on the CPU, one call of its loaded program).  Every
  response carries the model task-id that produced it (the skew story
  depends on knowing *which* model answered).
* **Watcher thread** — polls ``manifest.json``; when a newer task's artifact
  is published it loads the new artifact and captures its graphs *outside*
  the lock (a thread-local capture: the batcher keeps replaying the old
  artifact meanwhile), then swaps the artifact reference atomically under
  it.  In-flight batches hold a local reference and finish on the old
  artifact; a failed load (corrupt payload, injected ``swap_ioerror``)
  emits ``serve_swap_failed`` and keeps serving the current artifact —
  graceful degradation, retried at the next poll.

Lock discipline follows ``data/prefetch.py``: every attribute shared
between the worker threads and the caller-facing methods is written under
``self._lock``; requests and results travel through the queue /
per-request futures.  Telemetry funnels into the same ``Sink``
vocabulary as training (``serve_swap`` / ``serve_swap_failed`` /
``serve_latency``), and passing a ``Telemetry`` facade means the records
also ring through its ``FlightRecorder`` — a server crash leaves the same
forensics a trainer crash does.

The serving hot path never traces or captures: queries replay the graphs
captured at load only.  ``trace_count()`` exposes the exports and captures
made after load by every loaded artifact (through a ``RecompileMonitor``),
so tests can pin it at zero across warm restarts.

The server runs on the card unless the caller asks for the CPU
(``device="cpu"``, ``--platform cpu``); without CUDA the default raises.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from ..telemetry import NullRegistry, RecompileMonitor
from ..utils.logging import NullSink
from ..utils.platform import resolve_device

from .artifact import ServingArtifact, load_artifact, read_manifest


class InferenceServer:
    """Batched inference over the newest artifact in ``export_dir``.

    ``submit(x)`` returns a ``concurrent.futures.Future`` resolving to
    ``{"logits", "task_id", "latency_ms"}``.  ``stop()`` drains: every
    accepted request is answered before the threads exit — a clean shutdown
    drops nothing.  ``device`` is where the artifacts load (CUDA unless
    ``"cpu"`` is asked for).
    """

    def __init__(
        self,
        export_dir: str,
        max_wait_ms: float = 5.0,
        poll_s: float = 0.25,
        telemetry=None,
        sink=None,
        faults=None,
        monitor: Optional[RecompileMonitor] = None,
        latency_log_every: int = 256,
        auto_swap: bool = True,
        replica_id: Optional[int] = None,
        metrics=None,
        device=None,
    ):
        self.export_dir = export_dir
        self.device = resolve_device(device)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1000.0
        self.poll_s = float(poll_s)
        # auto_swap=False puts swaps under external control (the fleet front
        # end rolls replicas one at a time via swap_to); the watcher thread
        # is simply not started.  replica_id tags this server's telemetry in
        # fleet runs.
        self.auto_swap = bool(auto_swap)
        self.replica_id = replica_id
        self._telemetry = telemetry
        self._sink = (telemetry.sink if telemetry is not None else sink) or NullSink()
        self._faults = faults
        self.monitor = monitor if monitor is not None else RecompileMonitor(self._sink)
        self.latency_log_every = int(latency_log_every)
        # Time-series registry (telemetry/metrics.py): explicit > the
        # telemetry facade's > no-op.  Instrument updates always run OUTSIDE
        # self._lock — the registry has its own lock and the two must never
        # nest (lock-order discipline).
        if metrics is None and telemetry is not None:
            metrics = getattr(telemetry, "metrics", None)
        self.metrics = metrics if metrics is not None else NullRegistry()
        self._m_requests = self.metrics.counter("serve_requests_total")
        self._m_failed = self.metrics.counter("serve_failed_total")
        self._m_batches = self.metrics.counter("serve_batches_total")
        self._m_queue_depth = self.metrics.gauge("serve_queue_depth")
        self._m_bucket_occ = self.metrics.gauge("serve_bucket_occupancy")

        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._artifact: Optional[ServingArtifact] = None
        self._batcher: Optional[threading.Thread] = None
        self._watcher: Optional[threading.Thread] = None
        # Stats (all guarded by _lock; threads and callers both touch them).
        self._latencies_ms: List[float] = []
        self._served = 0
        self._failed = 0
        self._batches = 0
        self._slots = 0
        self._bucket_counts: Dict[int, int] = {}
        self._swaps = 0
        self._swap_failures = 0
        self._rollbacks = 0
        self._window_start = time.perf_counter()
        self._window_served = 0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #

    def start(self) -> "InferenceServer":
        latest = read_manifest(self.export_dir).get("latest")
        if latest is None:
            raise FileNotFoundError(
                f"no artifact published in {self.export_dir!r} "
                "(manifest.json missing or empty)"
            )
        art = self._load(int(latest))
        with self._lock:
            self._artifact = art
        self._sink.log(
            "serve_swap", from_task=None, to_task=art.task_id,
            load_ms=art.load_ms, compile_ms=art.compile_ms, path=art.path,
        )
        self._batcher = threading.Thread(
            target=self._batcher_loop, name="serve-batcher", daemon=True
        )
        self._batcher.start()
        if self.auto_swap:
            self._watcher = threading.Thread(
                target=self._watcher_loop, name="serve-watcher", daemon=True
            )
            self._watcher.start()
        return self

    def stop(self) -> None:
        """Drain and join.  The batcher keeps dispatching while the queue is
        non-empty, so every request accepted before ``stop()`` resolves; the
        post-join sweep catches a submit that raced the flag."""
        self._stop.set()
        if self._batcher is not None:
            self._batcher.join()
        if self._watcher is not None:
            self._watcher.join()
        with self._lock:
            art = self._artifact
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._dispatch(art, [item])
        self._flush_latency(force=True)

    # ------------------------------------------------------------------ #
    # Requests
    # ------------------------------------------------------------------ #

    def submit(self, x_u8: np.ndarray) -> Future:
        """Enqueue one image ``[H, W, C] uint8``; resolves to logits +
        the serving model's task id + measured latency."""
        if self._stop.is_set():
            raise RuntimeError("server is stopped")
        fut: Future = Future()
        self._queue.put((np.ascontiguousarray(x_u8, np.uint8), fut,
                         time.perf_counter()))
        return fut

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    @property
    def task_id(self) -> Optional[int]:
        with self._lock:
            return self._artifact.task_id if self._artifact else None

    def trace_count(self, group: str = "serve") -> int:
        """Exports and captures made after load, over every loaded
        artifact's buckets — the number a warm restart must keep at zero."""
        return self.monitor.total(group)

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies_ms, np.float64)
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "served": self._served,
                "failed": self._failed,
                "batches": self._batches,
                "task_id": self._artifact.task_id if self._artifact else None,
                "swaps": self._swaps,
                "swap_failures": self._swap_failures,
                "rollbacks": self._rollbacks,
                "bucket_counts": dict(self._bucket_counts),
                "bucket_occupancy": (
                    round(self._served / self._slots, 4) if self._slots else 0.0
                ),
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
                "p95_ms": float(np.percentile(lat, 95)) if lat.size else 0.0,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
                "throughput_rps": round(self._served / elapsed, 2),
            }

    # ------------------------------------------------------------------ #
    # Worker threads
    # ------------------------------------------------------------------ #

    def _batcher_loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            with self._lock:
                art = self._artifact
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            max_bucket = art.buckets[-1]
            while len(batch) < max_bucket:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(art, batch)

    def _dispatch(self, art: ServingArtifact, batch) -> None:
        n = len(batch)
        xs = np.stack([item[0] for item in batch])
        bucket = art.bucket_for(n)
        try:
            if n < bucket:
                xs = np.concatenate(
                    [xs, np.zeros((bucket - n,) + xs.shape[1:], np.uint8)]
                )
            logits = art.predict_padded(xs, bucket)
        except Exception as e:
            for _item in batch:
                _item[1].set_exception(e)
            with self._lock:
                self._failed += n
            self._m_failed.inc(n)
            print(f"| serve: batch of {n} failed: {e!r}")
            return
        done = time.perf_counter()
        for i, (_x, fut, t_enq) in enumerate(batch):
            fut.set_result({
                "logits": logits[i],
                "task_id": art.task_id,
                "latency_ms": (done - t_enq) * 1000.0,
            })
        with self._lock:
            self._latencies_ms.extend(
                (done - item[2]) * 1000.0 for item in batch
            )
            if len(self._latencies_ms) > 16384:
                # Percentiles over the recent tail; a long-lived server must
                # not grow the sample list without bound.
                del self._latencies_ms[:-8192]
            self._served += n
            self._window_served += n
            self._batches += 1
            self._slots += bucket
            self._bucket_counts[bucket] = self._bucket_counts.get(bucket, 0) + 1
            flush = self._window_served >= self.latency_log_every
            occupancy = self._served / self._slots if self._slots else 0.0
        # Registry updates after self._lock is released (never nested).
        self._m_requests.inc(n)
        self._m_batches.inc()
        self._m_queue_depth.set(self._queue.qsize())
        self._m_bucket_occ.set(occupancy)
        hist = self.metrics.histogram(
            "serve_batch_latency_ms", lowest=0.5, growth=2.0, buckets=18,
            bucket=str(bucket),
        )
        for item in batch:
            hist.observe((done - item[2]) * 1000.0)
        if flush:
            self._flush_latency()

    def _flush_latency(self, force: bool = False) -> None:
        with self._lock:
            if self._window_served == 0 and not force:
                return
            if not self._latencies_ms:
                return
            lat = np.asarray(self._latencies_ms, np.float64)
            elapsed = max(time.perf_counter() - self._window_start, 1e-9)
            record = dict(
                count=int(lat.size),
                p50_ms=round(float(np.percentile(lat, 50)), 3),
                p95_ms=round(float(np.percentile(lat, 95)), 3),
                p99_ms=round(float(np.percentile(lat, 99)), 3),
                throughput_rps=round(self._window_served / elapsed, 2),
                bucket_occupancy=(
                    round(self._served / self._slots, 4) if self._slots else 0.0
                ),
                batches=self._batches,
                task_id=self._artifact.task_id if self._artifact else -1,
            )
            self._window_served = 0
            self._window_start = time.perf_counter()
        self._sink.log("serve_latency", **record)

    def _watcher_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self._maybe_swap()

    def _maybe_swap(self) -> None:
        man = read_manifest(self.export_dir)
        latest = man.get("latest")
        if latest is None:
            return
        latest = int(latest)
        with self._lock:
            current = self._artifact.task_id if self._artifact else None
        if current == latest:
            return
        try:
            if self._faults is not None:
                actions = self._faults.fire("serve.swap", task=latest)
                if "swap_ioerror" in actions:
                    raise OSError(
                        f"fault-injected swap failure (task {latest})"
                    )
            art = self._load(latest, manifest=man)
        except Exception as e:
            with self._lock:
                self._swap_failures += 1
            self._sink.log(
                "serve_swap_failed", task_id=latest, error=repr(e),
            )
            print(
                f"| serve: swap to task {latest} failed ({e!r}); "
                f"still serving task {current}"
            )
            return
        # Load + capture happened entirely outside the lock; the swap itself
        # is one reference assignment.  In-flight batches keep their local
        # reference and finish on the old artifact.
        with self._lock:
            self._artifact = art
            self._swaps += 1
        self._sink.log(
            "serve_swap", from_task=current, to_task=art.task_id,
            load_ms=art.load_ms, compile_ms=art.compile_ms, path=art.path,
        )
        print(
            f"| serve: swapped task {current} -> {art.task_id} "
            f"(load {art.load_ms:.0f} ms, capture {art.compile_ms:.0f} ms)"
        )

    def swap_to(self, task_id: int) -> dict:
        """Externally driven, skew-gated swap (the fleet's rolling-update
        primitive; requires ``auto_swap=False`` only by convention — the
        caller owns the cadence).

        Load the target artifact and capture its graphs, then replay its
        golden probe (``skew.probe_artifact``) through them BEFORE
        promotion.  Any failure — injected
        ``swap_ioerror``, unreadable artifact, probe mismatch — keeps the
        current artifact serving, emits ``serve_rollback``, and reports
        ``ok=False``; the rest of the fleet is the caller's problem, this
        replica just refuses to get worse.  In-flight batches always finish
        on the artifact they started with.
        """
        task_id = int(task_id)
        with self._lock:
            current = self._artifact.task_id if self._artifact else None
        if current == task_id:
            return {"ok": True, "task_id": task_id, "noop": True}
        probe = None
        try:
            # task coordinate = swap TARGET (same as the auto-swap path);
            # per-replica injection comes from each replica owning its own
            # injector + ledger, not from the coordinate.
            if self._faults is not None:
                actions = self._faults.fire("serve.swap", task=task_id)
                if "swap_ioerror" in actions:
                    raise OSError(
                        f"fault-injected swap failure (task {task_id})"
                    )
            art = self._load(task_id)
            from .skew import probe_artifact

            probe = probe_artifact(art)
            if not probe["ok"]:
                raise OSError(
                    f"post-swap probe mismatch "
                    f"(max_abs={probe['max_abs']}, "
                    f"{probe.get('error', 'logits differ')})"
                )
        except Exception as e:
            with self._lock:
                self._swap_failures += 1
                self._rollbacks += 1
            record = dict(task_id=task_id, rolled_back_to=current,
                          reason=repr(e))
            if self.replica_id is not None:
                record["replica"] = self.replica_id
            if probe is not None:
                record["probe_checked"] = bool(probe.get("checked"))
                if probe.get("max_abs", 0.0) not in (None, float("inf")):
                    record["probe_max_abs"] = float(probe["max_abs"])
            self._sink.log("serve_rollback", **record)
            print(
                f"| serve: swap to task {task_id} rolled back ({e!r}); "
                f"still serving task {current}"
            )
            return {"ok": False, "task_id": current, "target": task_id,
                    "error": repr(e)}
        with self._lock:
            self._artifact = art
            self._swaps += 1
        self._sink.log(
            "serve_swap", from_task=current, to_task=art.task_id,
            load_ms=art.load_ms, compile_ms=art.compile_ms, path=art.path,
        )
        print(
            f"| serve: swapped task {current} -> {art.task_id} "
            f"(probe {'ok' if probe and probe['checked'] else 'absent'})"
        )
        return {"ok": True, "task_id": art.task_id,
                "probe_checked": bool(probe and probe.get("checked"))}

    def _load(self, task_id: int, manifest: Optional[dict] = None
              ) -> ServingArtifact:
        man = manifest if manifest is not None else read_manifest(self.export_dir)
        entry = man.get("artifacts", {}).get(str(task_id))
        if entry is None:
            raise OSError(f"task {task_id} not in manifest of {self.export_dir}")
        art = load_artifact(os.path.join(self.export_dir, entry["path"]), self.device)
        art.register_recompiles(self.monitor)
        return art


def main(argv=None) -> int:
    """Standalone entry: ``python -m
    a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.server
    --export_dir DIR`` (on the card; ``--platform cpu`` for the CPU).

    Serves until interrupted; prints a stats line every ``--report_s``."""
    import argparse

    p = argparse.ArgumentParser("cil-tpu inference server (PyTorch)")
    p.add_argument("--export_dir", required=True)
    p.add_argument("--serve_max_wait_ms", default=5.0, type=float,
                   help="micro-batch max-wait deadline")
    p.add_argument("--serve_poll_s", default=0.25, type=float,
                   help="manifest poll cadence for hot swaps")
    p.add_argument("--telemetry_dir", default=None,
                   help="serve telemetry (run.jsonl + flight ring) here")
    p.add_argument("--report_s", default=10.0, type=float)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where the artifacts load: cuda (an error without a "
                   "CUDA device) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.platform)

    telemetry = None
    if args.telemetry_dir:
        from ..telemetry import Telemetry
        from ..utils.logging import JsonlLogger

        os.makedirs(args.telemetry_dir, exist_ok=True)
        telemetry = Telemetry(
            telemetry_dir=args.telemetry_dir,
            sink=JsonlLogger(os.path.join(args.telemetry_dir, "run.jsonl")),
            metrics_source="serve", devices=[device],
        )
    server = InferenceServer(
        args.export_dir,
        max_wait_ms=args.serve_max_wait_ms,
        poll_s=args.serve_poll_s,
        telemetry=telemetry,
        device=device,
    ).start()
    print(f"| serving task {server.task_id} from {args.export_dir} on {device}")
    try:
        while True:
            time.sleep(args.report_s)
            print(f"| serve stats: {server.stats()}")
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        if telemetry is not None:
            telemetry.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
