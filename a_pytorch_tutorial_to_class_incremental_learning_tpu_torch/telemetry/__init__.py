"""Telemetry: spans, heartbeat, flight recorder, metrics, the recompile,
compile and memory counters, and the continual-learning metrics.

Counterpart of the JAX package's ``telemetry/`` package, with its record
vocabulary and files, so ``scripts/check_telemetry_schema.py``,
``scripts/report_run.py`` and ``scripts/supervise.py`` read a port run as
they read a JAX one.  :class:`Telemetry` is the facade the trainer threads
through its loop; with no ``telemetry_dir`` or ``heartbeat_path`` every call
is a no-op.

None of it reaches into a captured CUDA graph: spans and metrics wrap whole
calls on the trainer's thread, the heartbeat, pump and flight threads write
files and never touch CUDA, and the device-memory sample (:meth:`Telemetry.
log_hbm`) runs on the trainer's thread at a task boundary.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from ..utils.logging import NullSink, Sink
from .cil_metrics import (  # noqa: F401
    AccuracyMatrix,
    average_incremental_accuracy,
    backward_transfer,
    per_task_forgetting,
)
from .compilewatch import CompileWatch  # noqa: F401
from .counters import RecompileMonitor, StallClock, clocked, hbm_stats  # noqa: F401
from .flight import FlightRecorder, FlightSink  # noqa: F401
from .heartbeat import Heartbeat, read_heartbeat  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsPump,
    MetricsRegistry,
    NullRegistry,
    histogram_quantile,
    merge_histograms,
    merge_snapshots,
    snapshot_to_prometheus,
)
from .spans import SpanTracer, coverage, load_spans  # noqa: F401


class Telemetry:
    """One handle over the telemetry, built from the config's flags.

    * ``telemetry_dir`` — spans in ``<dir>/spans.jsonl`` (and a Chrome trace
      at close), the default heartbeat file, and the flight recorder's
      ``<dir>/flight_{process_index}.json``.
    * ``heartbeat_path`` — the heartbeat file (works without a telemetry
      dir).
    * ``sink`` — where counter and metric records go (the trainer's
      experiment log).  With a telemetry dir the facade wraps it in a
      :class:`FlightSink`, so every record also lands in the flight ring;
      the trainer reads the wrapped sink back from ``self.sink``.
    * ``flight_events`` — the ring's capacity (0 disables it).
    * ``devices`` — the devices :meth:`log_hbm` samples (the trainer's).

    Process identity comes from ``torch.distributed`` (rank and world size
    once a group is up, else 0 and 1) unless given, and every component
    writes its own per-process file.
    """

    def __init__(
        self,
        telemetry_dir: Optional[str] = None,
        heartbeat_path: Optional[str] = None,
        heartbeat_interval_s: float = 15.0,
        sink: Optional[Sink] = None,
        flight_events: int = 256,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        metrics: bool = True,
        metrics_interval_s: float = 10.0,
        metrics_source: str = "train",
        devices: Optional[Sequence] = None,
    ):
        self.dir = telemetry_dir
        self.sink = sink or NullSink()
        self.devices = devices
        self.flight: Optional[FlightRecorder] = None
        if process_index is None and (telemetry_dir or heartbeat_path):
            from ..parallel.dist import get_rank, get_world_size

            process_index, process_count = get_rank(), get_world_size()
        process_index = int(process_index or 0)
        process_count = int(process_count or 1)
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            if heartbeat_path is None:
                heartbeat_path = os.path.join(telemetry_dir, "heartbeat.json")
            if flight_events > 0:
                import socket

                self.flight = FlightRecorder(
                    os.path.join(telemetry_dir, f"flight_{process_index}.json"),
                    capacity=flight_events,
                    process_index=process_index,
                    process_count=process_count,
                    host_id=socket.gethostname(),
                )
                self.flight.install()
                self.sink = FlightSink(self.sink, self.flight)
        self.spans = SpanTracer(
            os.path.join(telemetry_dir, "spans.jsonl") if telemetry_dir else None,
            process_index=process_index,
            process_count=process_count,
            flight=self.flight,
        )
        self.heartbeat = Heartbeat(
            heartbeat_path,
            heartbeat_interval_s,
            process_index=process_index,
            process_count=process_count,
            flight=self.flight,
        )
        self.recompiles = RecompileMonitor(self.sink)
        self.matrix = AccuracyMatrix()
        # The registry stays on by default (one shared lock, instruments
        # resolved once); metrics=False hands out no-op instruments.  The
        # pump (metrics_snapshot records, the heartbeat's progress digest)
        # runs when telemetry is on, i.e. there is a heartbeat: unlike the
        # JAX facade, whose pump also runs for a bare run log, so that a
        # run without telemetry flags keeps a log free of wall-clock-paced
        # records.
        self.metrics = MetricsRegistry() if metrics else NullRegistry()
        self.pump: Optional[MetricsPump] = None
        if metrics and self.heartbeat.enabled:
            self.pump = MetricsPump(
                self.metrics,
                self.sink,
                interval_s=metrics_interval_s,
                source=metrics_source,
                heartbeat=self.heartbeat,
            )
            self.pump.start()

    @property
    def enabled(self) -> bool:
        return self.spans.enabled or self.heartbeat.enabled

    def span(self, name: str, **attrs):
        return self.spans.span(name, **attrs)

    def log_hbm(self, **attrs) -> None:
        """Sample the card's memory at a task boundary; no record on the
        CPU, which reports none."""
        stats = hbm_stats(self.devices)
        if stats:
            self.sink.log("hbm", devices=stats, **attrs)

    def close(self) -> None:
        """End of run: the pump's last flush, the heartbeat's last beat, the
        Chrome trace beside the span JSONL (whose handle closes), and a last
        flight dump; then the death-path hooks are undone, so a process that
        builds many trainers does not stack them."""
        if self.pump is not None:
            self.pump.stop()
        self.heartbeat.stop()
        if self.spans.enabled:
            # Process 0 writes trace.json, process i trace_p{i}.json.
            self.spans.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self.spans.close()
        if self.flight is not None:
            self.flight.dump("close")
            self.flight.uninstall()
