"""The port's telemetry modules against the JAX package's: the same calls
into ``SpanTracer``, ``Heartbeat``, ``FlightRecorder``/``FlightSink``,
``MetricsRegistry``/``MetricsPump``, ``RecompileMonitor``,
``CompileWatch.delta`` and the ``Telemetry`` facade give the same records
and files, up to timestamps, durations, pids and host names; and
``hbm_stats`` reports nothing on the CPU."""

import json
import os
import signal
import sys
import warnings

import pytest

from a_pytorch_tutorial_to_class_incremental_learning_tpu import telemetry as jtel
from a_pytorch_tutorial_to_class_incremental_learning_tpu.telemetry import (
    compilewatch as jcompilewatch,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import telemetry as ttel

# Wall-clock and per-process values: never compared.
VOLATILE = {"ts", "mono", "pid", "host_id", "dur_s", "age_s", "dur"}


def _norm(obj):
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


class _ListSink:
    def __init__(self):
        self.records = []

    def log(self, record_type, **fields):
        self.records.append({"type": record_type, **fields})


def _jsonl(path):
    return [json.loads(ln) for ln in open(path)]


def _both(tmp_path, fn):
    """``fn(package, directory)`` for the JAX package, then the port."""
    out = []
    for name, pkg in (("jax", jtel), ("port", ttel)):
        d = tmp_path / name
        d.mkdir()
        out.append(fn(pkg, d))
    return out


def _drive_spans(tracer):
    with tracer.span("fit"):
        with tracer.span("task", task=0):
            with tracer.span("epoch", task=0, epoch=1):
                pass
            with tracer.span("herd", task=0):
                pass
        with tracer.span("task", task=1):
            with pytest.raises(ValueError), tracer.span("epoch", task=1, epoch=1):
                raise ValueError("a span closes on an exception too")


@pytest.mark.parametrize("process_index", [0, 2])
def test_span_tracer_and_chrome_trace_match_jax(tmp_path, process_index):
    def run(pkg, d):
        tracer = pkg.SpanTracer(str(d / "spans.jsonl"), process_index=process_index,
                                process_count=3)
        _drive_spans(tracer)
        tracer.export_chrome_trace(str(d / "trace.json"))
        names = sorted(os.listdir(d))
        spans_file = [n for n in names if n.startswith("spans")][0]
        trace_file = [n for n in names if n.startswith("trace")][0]
        trace = json.load(open(d / trace_file))
        return {"files": names, "spans": _norm(_jsonl(d / spans_file)),
                "loaded": _norm(pkg.load_spans(str(d / spans_file))),
                "completed": _norm(tracer.completed), "trace": _norm(trace),
                "coverage_defined": tracer.coverage() is not None}

    j, t = _both(tmp_path, run)
    assert j == t
    assert t["files"] == (["spans.jsonl", "trace.json"] if process_index == 0
                          else ["spans_p2.jsonl", "trace_p2.json"])
    assert [s["name"] for s in t["spans"]] == ["epoch", "herd", "task", "epoch", "task", "fit"]
    assert ttel.coverage([]) is None


def test_disabled_tracer_is_a_no_op(tmp_path):
    tracer = ttel.SpanTracer(None)
    with tracer.span("fit"):
        pass
    assert not tracer.enabled and tracer.completed == [] and tracer.coverage() is None


def _profiled(tracer):
    """``_drive_spans`` under a CPU ``torch.profiler``; its host events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive_spans(tracer)
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() in ("fit", "task", "epoch", "herd")]


@pytest.mark.parametrize("with_path", [False, True])
def test_spans_annotate_an_active_profiler(tmp_path, with_path):
    """With or without a JSONL path, each span is one host event of the
    profiler's, by name (a run without --telemetry_dir, traced)."""
    tracer = ttel.SpanTracer(str(tmp_path / "spans.jsonl") if with_path else None)
    events = _profiled(tracer)
    assert sorted(e.name() for e in events) == sorted(
        ["fit", "task", "epoch", "herd", "task", "epoch"])
    assert len(tracer.completed) == (6 if with_path else 0)


@pytest.mark.parametrize("with_path", [False, True])
def test_spans_without_a_profiler_make_no_annotation_or_cuda_call(tmp_path, monkeypatch,
                                                                   with_path):
    """With no profiler running a span asks one flag: no record_function,
    no CUDA call, no synchronization, no event."""
    import torch

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import spans

    calls = []

    def counted(name):
        def call(*a, **k):
            calls.append(name)
            raise AssertionError(f"a span called {name}")
        return call

    tracer = ttel.SpanTracer(str(tmp_path / "spans.jsonl") if with_path else None)
    monkeypatch.setattr(spans, "record_function", counted("record_function"))
    for name in ("synchronize", "Event", "current_stream", "is_available", "device_count"):
        monkeypatch.setattr(torch.cuda, name, counted(f"torch.cuda.{name}"))
    _drive_spans(tracer)
    assert calls == []
    assert len(tracer.completed) == (6 if with_path else 0)


def test_span_ts_is_the_profilers_clock(tmp_path):
    """A span record's ``ts`` and its profiler event's start agree within
    1 ms: both are the Unix clock."""
    tracer = ttel.SpanTracer(str(tmp_path / "spans.jsonl"))
    events = _profiled(tracer)
    starts = sorted((e.name(), e.start_ns()) for e in events)
    recs = sorted((r["name"], r["ts"]) for r in tracer.completed)
    assert [n for n, _ in starts] == [n for n, _ in recs]
    for (_, ns), (_, ts) in zip(starts, recs):
        assert abs(ns / 1e9 - ts) < 1e-3, (ns / 1e9, ts)


def test_span_jsonl_is_one_handle_flushed_per_record(tmp_path):
    """Each record is on disk as its span closes; ``close`` closes the
    handle, and a span after it appends."""
    path = tmp_path / "spans.jsonl"
    tracer = ttel.SpanTracer(str(path))
    with tracer.span("fit"):
        with tracer.span("task", task=0):
            pass
        assert [json.loads(ln)["name"] for ln in open(path)] == ["task"]
    handle = tracer._file
    assert [json.loads(ln)["name"] for ln in open(path)] == ["task", "fit"]
    tracer.close()
    assert handle.closed and tracer._file is None
    with tracer.span("late"):
        pass
    tracer.close()
    assert [json.loads(ln)["name"] for ln in open(path)] == ["task", "fit", "late"]


@pytest.mark.parametrize("process_index", [0, 1])
def test_heartbeat_matches_jax(tmp_path, process_index):
    def run(pkg, d):
        hb = pkg.Heartbeat(str(d / "heartbeat.json"), interval_s=100.0,
                           process_index=process_index, process_count=2)
        hb.update(force=True, task=0, phase="train")
        hb.update(step=3, task=0, epoch=1, last_step_ms=1.5)  # not due: no write
        first = json.load(open(hb.path))
        hb.start()
        hb.update(force=True, task=0, epoch=1)
        hb.stop()
        last = json.load(open(hb.path))
        fresh = pkg.read_heartbeat(hb.path, max_age_s=60.0)
        return {"file": os.path.basename(hb.path), "first": _norm(first), "last": _norm(last),
                "fresh": fresh["fresh"], "missing": pkg.read_heartbeat(str(d / "no"), 1.0)}

    j, t = _both(tmp_path, run)
    assert j == t
    assert t["file"] == ("heartbeat.json" if process_index == 0 else "heartbeat_p1.json")
    assert t["last"]["step"] == 3 and t["last"]["phase"] == "train" and t["fresh"]
    assert t["missing"] == {"fresh": False}


def test_forced_beat_is_written_by_the_heartbeat_thread(tmp_path):
    """With the heartbeat thread running, a forced beat enters the flight
    ring at once, in the loop's order, and its file and flight dump are
    written by the thread: the loop does not wait on the disk."""
    import threading
    import time

    rec = ttel.FlightRecorder(str(tmp_path / "flight_0.json"), capacity=8, process_index=0,
                              process_count=1, host_id="h")
    hb = ttel.Heartbeat(str(tmp_path / "heartbeat.json"), interval_s=100.0, process_index=0,
                        process_count=1, flight=rec)
    writers = []
    persist = hb._persist

    def tracked(payload):
        writers.append(threading.current_thread().name)
        persist(payload)

    hb._persist = tracked
    hb.start()
    try:
        for i in range(20):
            hb.update(force=True, task=i, phase="eval")
            rec.record({"type": "epoch", "task_id": i})
        ring = [e for e in rec._events if e["type"] in ("heartbeat", "epoch")]
        assert [(e["type"], e.get("task", e.get("task_id"))) for e in ring[-8:]] == [
            (t, i) for i in range(16, 20) for t in ("heartbeat", "epoch")]
        deadline = time.time() + 10
        while time.time() < deadline and json.load(open(hb.path)).get("task") != 19:
            time.sleep(0.01)
        assert json.load(open(hb.path))["task"] == 19
        assert writers and set(writers) == {"cil-heartbeat"}
    finally:
        hb.stop()
    beat = json.load(open(hb.path))
    assert beat["task"] == 19 and beat["seq"] == 22  # init, 20 forced, the final one
    assert not hb._thread


def test_flight_recorder_and_sink_match_jax(tmp_path):
    def run(pkg, d):
        rec = pkg.FlightRecorder(str(d / "flight_0.json"), capacity=4, process_index=0,
                                 process_count=1, host_id="h")
        inner = _ListSink()
        sink = pkg.FlightSink(inner, rec)
        rec.span_open("task", 0, 1, task=0)
        for i in range(5):  # one more than the ring holds
            sink.log("epoch", task_id=0, epoch=i + 1)
        periodic = rec.dump("heartbeat")
        rec.span_close(0)
        rec.span_open("herd", 1, 2, task=0)
        fatal = rec.fatal_dump("fault_kill")
        frozen = rec.dump("heartbeat")  # the fatal tail stays on disk
        on_disk = json.load(open(d / "flight_0.json"))
        return {"periodic": _norm(periodic), "fatal": _norm(fatal), "frozen": frozen,
                "on_disk": _norm(on_disk), "inner": inner.records,
                "open": rec.open_spans()}

    j, t = _both(tmp_path, run)
    assert j == t
    assert t["on_disk"]["reason"] == "fault_kill" and t["on_disk"]["last_open_span"] == "herd"
    assert t["frozen"] is None and t["on_disk"]["dropped"] == 3  # 7 events, 4 kept


def test_flight_install_hooks_and_uninstall_restores_them(tmp_path):
    before = (sys.excepthook, signal.getsignal(signal.SIGTERM))
    rec = ttel.FlightRecorder(str(tmp_path / "flight_0.json"))
    rec.install()
    rec.install()  # idempotent
    assert sys.excepthook is not before[0]
    assert signal.getsignal(signal.SIGTERM) is not before[1]
    rec.uninstall()
    assert (sys.excepthook, signal.getsignal(signal.SIGTERM)) == before


def _drive_metrics(reg):
    steps = reg.counter("steps_total")
    steps.inc()
    steps.inc(4)
    reg.counter("steps_total").inc(2)  # the same instrument
    reg.gauge("stall_frac").set(0.25)
    reg.gauge("prefetch_occupancy").add(0.5)
    hist = reg.histogram("step_latency_ms", lowest=0.5, growth=2.0, buckets=18)
    for v in (0.1, 0.5, 0.7, 3.0, 40.0, 1e9):
        hist.observe(v)
    reg.counter("served_total", priority="high").inc()
    with pytest.raises(TypeError):
        reg.gauge("steps_total")
    return reg.snapshot()


def test_metrics_registry_and_pure_helpers_match_jax():
    out = []
    for pkg in (jtel, ttel):
        snap = _drive_metrics(pkg.MetricsRegistry())
        h = snap["histograms"]["step_latency_ms"]
        out.append({
            "snap": snap, "prom": pkg.snapshot_to_prometheus(snap),
            "merged": pkg.merge_snapshots([snap, snap]),
            "q": [pkg.histogram_quantile(h, q) for q in (0.0, 0.5, 0.9, 1.0)],
            "null": pkg.NullRegistry().snapshot(),
            "null_prom": pkg.NullRegistry().to_prometheus(),
        })
        with pytest.raises(ValueError):
            pkg.merge_histograms(h, {**h, "growth": 3.0})
    assert out[0] == out[1]
    assert out[1]["snap"]["counters"]["steps_total"] == 7.0


def test_metrics_pump_matches_jax(tmp_path):
    def run(pkg, d):
        reg = pkg.MetricsRegistry()
        sink = _ListSink()
        hb = pkg.Heartbeat(str(d / "heartbeat.json"), interval_s=100.0, process_index=0,
                           process_count=1)
        pump = pkg.MetricsPump(reg, sink, interval_s=100.0, source="train", heartbeat=hb)
        reg.counter("steps_total").inc(10)
        pump.flush()
        reg.counter("steps_total").inc(5)
        pump.start()
        pump.stop()  # the last flush
        hb.stop()
        recs = [{**r, "rates": sorted(r["rates"])} for r in sink.records]
        beat = json.load(open(d / "heartbeat.json"))
        return {"records": recs, "digest": beat.get("steps_total")}

    j, t = _both(tmp_path, run)
    assert j == t
    assert [r["seq"] for r in t["records"]] == [1, 2] and t["digest"] == 15.0


class _Program:
    """Stands for a callable that compiles: ``_cache_size`` is its
    programs so far."""

    def __init__(self):
        self.n = 0

    def _cache_size(self):
        return self.n


def test_recompile_monitor_matches_jax():
    out = []
    for pkg in (jtel, ttel):
        sink = _ListSink()
        mon = pkg.RecompileMonitor(sink)
        train, evals = _Program(), _Program()
        mon.track("epoch_fn", train, group="train")
        mon.track("eval_step", evals, group="eval")
        mon.track("plain", lambda: None, group="train")  # holds no programs: ignored
        deltas = []
        train.n = 1
        deltas.append(mon.check("task0/epoch1", expected=True, group="train", task_id=0))
        deltas.append(mon.check("task0/epoch2", expected=False, group="train", task_id=0))
        evals.n = 1
        train.n = 2
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            deltas.append(mon.check("task0/epoch3", expected=False, group="train"))
        deltas.append(mon.check("eval@known0", expected=True, group="eval"))
        out.append({"records": sink.records, "deltas": deltas, "total": mon.total(),
                    "warned": [issubclass(w.category, RuntimeWarning) for w in caught]})
    assert out[0]["records"] == out[1]["records"]
    assert out[0]["deltas"] == out[1]["deltas"] == [1, 0, 1, 1]
    assert out[0]["total"] == out[1]["total"] == 3
    assert out[0]["warned"] == out[1]["warned"] == [True]
    assert [r["type"] for r in out[1]["records"]] == ["recompile", "recompile",
                                                      "recompile_warning", "recompile"]


def test_clocked_charges_production_to_the_host_like_jax():
    out = []
    for pkg in (jtel, ttel):
        clock = pkg.StallClock()
        batches = list(pkg.clocked(iter([1, 2, 3]), clock))
        out.append((batches, clock.host_s > 0, clock.device_s, sorted(clock.snapshot())))
    assert out[0] == out[1] == ([1, 2, 3], True, 0.0, ["device_s", "host_s", "stall_frac"])


def test_compile_event_fields_match_jax():
    before = {"backend_compile_s": 1.0, "cache_retrieval_s": 0.25, "compiles": 2,
              "cache_hits": 1}
    after = {"backend_compile_s": 4.5, "cache_retrieval_s": 0.5, "compiles": 5,
             "cache_hits": 2}
    got = ttel.CompileWatch.delta(before, after)
    assert got == jcompilewatch.CompileWatch.delta(before, after)
    watch = ttel.CompileWatch()  # a fresh one, not the process's
    watch.record_capture(2.0)
    watch.record_build(0.5, cache_hit=False)
    watch.record_build(0.25, cache_hit=True)
    zero = {k: 0 for k in before}
    assert ttel.CompileWatch.delta(zero, watch.snapshot()) == {
        "compile_s": 2.5, "backend_compile_s": 2.75, "cache_retrieval_s": 0.25,
        "compiles": 3, "cache_hits": 1}


def test_telemetry_facade_matches_jax(tmp_path):
    def run(pkg, d):
        sink = _ListSink()
        tel = pkg.Telemetry(telemetry_dir=str(d), heartbeat_interval_s=100.0, sink=sink,
                            flight_events=16, process_index=0, process_count=1,
                            metrics_interval_s=100.0)
        tel.heartbeat.start()
        with tel.span("fit"):
            with tel.span("task", task=0):
                tel.heartbeat.update(force=True, task=0, phase="train")
                tel.metrics.counter("steps_total").inc(3)
                tel.sink.log("epoch", task_id=0, epoch=1)
        tel.log_hbm(task_id=0)  # the CPU reports no memory: no record
        tel.close()
        files = sorted(os.listdir(d))
        flight = json.load(open(d / "flight_0.json"))
        recs = [{**r, "rates": sorted(r["rates"])} if "rates" in r else r
                for r in sink.records]
        return {"files": files, "records": recs,
                "spans": _norm(_jsonl(d / "spans.jsonl")),
                "trace": _norm(json.load(open(d / "trace.json"))),
                "heartbeat": _norm(json.load(open(d / "heartbeat.json"))),
                "flight": _norm(flight), "enabled": tel.enabled}

    before = (sys.excepthook, signal.getsignal(signal.SIGTERM))
    j, t = _both(tmp_path, run)
    assert (sys.excepthook, signal.getsignal(signal.SIGTERM)) == before
    assert j == t
    assert t["files"] == ["flight_0.json", "heartbeat.json", "spans.jsonl", "trace.json"]
    assert [r["type"] for r in t["records"]] == ["epoch", "metrics_snapshot"]
    assert t["flight"]["reason"] == "close"


def test_disabled_facade_writes_nothing(tmp_path):
    tel = ttel.Telemetry()
    with tel.span("fit"):
        tel.heartbeat.update(force=True, task=0)
    tel.log_hbm(task_id=0)
    tel.close()
    assert not tel.enabled and tel.flight is None and tel.pump is None


def test_hbm_stats_is_empty_on_the_cpu(monkeypatch):
    import torch

    assert ttel.hbm_stats(["cpu"]) == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttel.hbm_stats() == {}
    sink = _ListSink()
    ttel.Telemetry(sink=sink, devices=[torch.device("cpu")]).log_hbm(task_id=0)
    assert sink.records == []
