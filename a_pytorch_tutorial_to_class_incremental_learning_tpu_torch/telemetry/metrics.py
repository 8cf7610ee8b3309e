"""Fleet metrics plane: in-process time-series registry + snapshot pump.

Counterpart of the JAX package's ``telemetry/metrics.py``: the same
instruments, names, bucket layouts, snapshot shape, merge helpers,
Prometheus text and ``metrics_snapshot`` records, so a port run's series
merge with the JAX package's and pass ``analysis/contract_registry.json``.

The event-shaped telemetry (JSONL records, spans, flight dumps) answers
"what happened"; this module answers "how fast is it happening *right now*"
— the substrate the serving fleet's scraper, the SLO burn-rate alerts, and
the watchdog's stalled-vs-progressing distinction all read from.

Three instrument kinds, Prometheus-shaped:

* :class:`Counter` — monotonic totals (requests served, steps run).
* :class:`Gauge` — last-write-wins levels (queue depth, ring occupancy).
* :class:`Histogram` — exponential-bucket latency distributions.  Buckets
  are ``lowest * growth**i`` upper bounds, so two histograms with the same
  layout merge by element-wise addition: merging is associative and
  commutative, which is what lets the fleet scraper fold N replicas'
  distributions into one aggregate in any order.

Lock discipline (threadlint JL303–JL306, ``--check_threads``): the registry
owns ONE lock shared by every instrument it creates — a single lock cannot
participate in an acquisition-order cycle — and no file/socket/sleep call
ever runs under it.  ``snapshot()`` copies every value atomically under that
lock and returns plain dicts; rendering (Prometheus text), merging, and
quantile estimation are pure functions over snapshots, so they run lock-free.

:class:`MetricsPump` is the bridge back into the event world: a daemon
thread that flushes a schema-checked ``metrics_snapshot`` record into the
run's JSONL sink on a cadence, and pushes a progress digest (step rate,
serve qps) into the heartbeat so ``scripts/supervise.py`` can tell "alive
but stalled" from "making progress" without scraping anything.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# Heartbeat progress digest: counter series -> (absolute field, rate field).
# The pump publishes these into the heartbeat file; the supervisor's stall
# probe watches the absolute fields for freezes under a fresh heartbeat.
DIGEST_SERIES = {
    "steps_total": ("steps_total", "step_rate"),
    "serve_requests_total": ("serve_requests_total", "serve_qps"),
}


def series_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Prometheus series key: ``name`` or ``name{k="v",...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter.  ``inc()`` is the hot-path call: one shared-lock
    acquisition, one float add."""

    kind = "counter"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins level."""

    kind = "gauge"

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Exponential-bucket histogram.

    Bucket ``i`` (0-based) counts observations ``v <= lowest * growth**i``
    not already counted by a lower bucket; one final overflow bucket counts
    the rest.  The layout ``(lowest, growth, len(buckets))`` is the merge
    key: equal layouts merge by element-wise addition.
    """

    kind = "histogram"

    def __init__(self, lock: threading.Lock, lowest: float = 1.0,
                 growth: float = 2.0, buckets: int = 20):
        if lowest <= 0 or growth <= 1.0 or buckets < 1:
            raise ValueError(
                f"bad histogram layout: lowest={lowest} growth={growth} "
                f"buckets={buckets}")
        self._lock = lock
        self.lowest = float(lowest)
        self.growth = float(growth)
        self._counts = [0] * (buckets + 1)  # + overflow
        self._sum = 0.0
        self._count = 0
        # Precomputed upper bounds; index search is log-free and branchless
        # enough for a hot path without importing math under the lock.
        self._bounds = [lowest * growth ** i for i in range(buckets)]

    def observe(self, v: float) -> None:
        v = float(v)
        # Bound search outside the lock: bounds are immutable after init.
        idx = len(self._bounds)
        for i, b in enumerate(self._bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1


class MetricsRegistry:
    """Process-local instrument registry with atomic snapshots.

    One lock for everything it owns: instruments share it (so ``snapshot``
    reads every value in one critical section with no nested acquisition),
    and a single lock is structurally immune to lock-order inversion.
    Instruments are created once and cached by ``(name, labels)`` — calling
    ``counter("served_total", priority="high")`` twice returns the same
    object, so call sites can re-resolve instead of threading references.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    # ------------------------------------------------------------------ #

    def _get(self, name: str, factory, labels: dict):
        key = series_name(name, tuple(sorted(labels.items())))
        # Fast path: dict reads are atomic under the GIL, but the candidate
        # may be mid-insert on another thread — resolve under the lock.
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = factory()
                self._metrics[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        inst = self._get(name, lambda: Counter(self._lock), labels)
        if not isinstance(inst, Counter):
            raise TypeError(f"{name!r} already registered as {inst.kind}")
        return inst

    def gauge(self, name: str, **labels) -> Gauge:
        inst = self._get(name, lambda: Gauge(self._lock), labels)
        if not isinstance(inst, Gauge):
            raise TypeError(f"{name!r} already registered as {inst.kind}")
        return inst

    def histogram(self, name: str, lowest: float = 1.0, growth: float = 2.0,
                  buckets: int = 20, **labels) -> Histogram:
        inst = self._get(
            name,
            lambda: Histogram(self._lock, lowest, growth, buckets),
            labels,
        )
        if not isinstance(inst, Histogram):
            raise TypeError(f"{name!r} already registered as {inst.kind}")
        return inst

    # ------------------------------------------------------------------ #

    def snapshot(self) -> dict:
        """Atomic copy of every instrument: one lock hold, plain dicts out.

        ``{"counters": {series: value}, "gauges": {series: value},
        "histograms": {series: {count, sum, lowest, growth, buckets}}}`` —
        JSON-ready, so the same shape flows into ``metrics_snapshot``
        records, the Prometheus renderer, and the fleet merge.
        """
        counters, gauges, histograms = {}, {}, {}
        with self._lock:
            for key, inst in self._metrics.items():
                if isinstance(inst, Counter):
                    counters[key] = inst._value
                elif isinstance(inst, Gauge):
                    gauges[key] = inst._value
                else:
                    histograms[key] = {
                        "count": inst._count,
                        "sum": round(inst._sum, 6),
                        "lowest": inst.lowest,
                        "growth": inst.growth,
                        "buckets": list(inst._counts),
                    }
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def to_prometheus(self) -> str:
        return snapshot_to_prometheus(self.snapshot())


class _NullInstrument:
    """Stands in for every instrument kind when metrics are disabled."""

    kind = "null"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, n: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled metrics plane: hands out shared no-op instruments so call
    sites resolve-and-use unconditionally — the off-path the ≤3% overhead
    gate in ``scripts/perf_gate.py`` compares against."""

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, lowest: float = 1.0, growth: float = 2.0,
                  buckets: int = 20, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def to_prometheus(self) -> str:
        return ""


# --------------------------------------------------------------------------- #
# Pure functions over snapshots (lock-free by construction)
# --------------------------------------------------------------------------- #


def _split_series(series: str) -> Tuple[str, str]:
    """``name{k="v"}`` -> ``(name, 'k="v"')``; bare names get ``""``."""
    if series.endswith("}") and "{" in series:
        name, _, rest = series.partition("{")
        return name, rest[:-1]
    return series, ""


def histogram_bounds(h: dict) -> List[float]:
    """Finite upper bounds of a snapshot histogram (overflow excluded)."""
    n = len(h["buckets"]) - 1
    return [h["lowest"] * h["growth"] ** i for i in range(n)]


def histogram_quantile(h: dict, q: float) -> float:
    """Quantile estimate from a snapshot histogram: the upper bound of the
    bucket where the cumulative count crosses ``q`` (the overflow bucket
    reports the largest finite bound — the estimate saturates rather than
    inventing an unbounded number)."""
    total = h["count"]
    if total <= 0:
        return 0.0
    bounds = histogram_bounds(h)
    target = q * total
    cum = 0
    for i, c in enumerate(h["buckets"]):
        cum += c
        if cum >= target:
            return bounds[min(i, len(bounds) - 1)]
    return bounds[-1]


def merge_histograms(a: dict, b: dict) -> dict:
    """Element-wise merge of two equal-layout snapshot histograms."""
    if (a["lowest"], a["growth"], len(a["buckets"])) != (
            b["lowest"], b["growth"], len(b["buckets"])):
        raise ValueError("cannot merge histograms with different layouts")
    return {
        "count": a["count"] + b["count"],
        "sum": round(a["sum"] + b["sum"], 6),
        "lowest": a["lowest"],
        "growth": a["growth"],
        "buckets": [x + y for x, y in zip(a["buckets"], b["buckets"])],
    }


def merge_snapshots(snaps: List[dict]) -> dict:
    """Fold N snapshots into one aggregate: counters sum, histograms merge,
    gauges last-wins (levels from different processes do not add)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + v
        for k, v in snap.get("gauges", {}).items():
            out["gauges"][k] = v
        for k, h in snap.get("histograms", {}).items():
            prev = out["histograms"].get(k)
            out["histograms"][k] = h if prev is None else merge_histograms(
                prev, h)
    return out


def sum_series(table: dict, name: str) -> float:
    """Sum every series of ``name`` across its label sets."""
    return sum(v for k, v in table.items() if _split_series(k)[0] == name)


def snapshot_to_prometheus(snap: dict) -> str:
    """Render a snapshot as Prometheus text exposition (v0.0.4).

    Histograms render the standard cumulative ``_bucket{le=...}`` series
    plus ``_sum``/``_count``; the scraper reconstructs per-bucket counts by
    differencing, and equal ``le`` ladders merge associatively.
    """
    lines: List[str] = []
    typed = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for series, value in snap.get("counters", {}).items():
        _type(_split_series(series)[0], "counter")
        lines.append(f"{series} {_fmt(value)}")
    for series, value in snap.get("gauges", {}).items():
        _type(_split_series(series)[0], "gauge")
        lines.append(f"{series} {_fmt(value)}")
    for series, h in snap.get("histograms", {}).items():
        name, labels = _split_series(series)
        _type(name, "histogram")
        prefix = f"{name}_bucket{{{labels + ',' if labels else ''}"
        cum = 0
        for bound, c in zip(histogram_bounds(h), h["buckets"]):
            cum += c
            lines.append(f'{prefix}le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{prefix}le="+Inf"}} {h["count"]}')
        suffix = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{suffix} {_fmt(h['sum'])}")
        lines.append(f"{name}_count{suffix} {h['count']}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Float format without spurious exponent/trailing noise: integral
    values render as integers so counter lines stay exact."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# --------------------------------------------------------------------------- #
# MetricsPump: registry -> JSONL records + heartbeat digest
# --------------------------------------------------------------------------- #


class MetricsPump:
    """Daemon thread flushing periodic ``metrics_snapshot`` records.

    Each flush takes one atomic registry snapshot, derives per-second rates
    against the previous flush, logs the record through the sink (append-
    mode JSONL — never while holding any lock), and pushes the progress
    digest (``DIGEST_SERIES``) into the heartbeat.  ``stop()`` joins the
    thread and flushes one final snapshot so a clean exit never loses the
    tail of the series.
    """

    def __init__(self, registry: MetricsRegistry, sink, interval_s: float = 10.0,
                 source: str = "train", heartbeat=None):
        self.registry = registry
        self.sink = sink
        self.interval_s = float(interval_s)
        self.source = source
        self.heartbeat = heartbeat
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._last_mono = 0.0
        self._last_counters: Dict[str, float] = {}

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="cil-metrics-pump", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=self.interval_s + 5.0)
            self._thread = None
        self.flush()  # final snapshot: the freshest possible series tail

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()

    def flush(self) -> None:
        snap = self.registry.snapshot()
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            seq = self._seq
            prev_mono, prev = self._last_mono, self._last_counters
            self._last_mono, self._last_counters = now, snap["counters"]
        rates: Dict[str, float] = {}
        dt = now - prev_mono
        if prev_mono > 0 and dt > 0:
            rates = {
                k: round((v - prev.get(k, 0.0)) / dt, 6)
                for k, v in snap["counters"].items()
            }
        # Sink + heartbeat writes run with an empty lockset: the JSONL
        # append and the heartbeat's tmp+replace both block on disk.
        self.sink.log(
            "metrics_snapshot",
            source=self.source,
            seq=seq,
            interval_s=self.interval_s,
            counters=snap["counters"],
            gauges=snap["gauges"],
            histograms=snap["histograms"],
            rates=rates,
        )
        if self.heartbeat is not None:
            digest = {}
            for series, (abs_field, rate_field) in DIGEST_SERIES.items():
                present = any(_split_series(k)[0] == series
                              for k in snap["counters"])
                if present:
                    total = sum_series(snap["counters"], series)
                    digest[abs_field] = round(total, 3)
                    digest[rate_field] = round(
                        sum(r for k, r in rates.items()
                            if _split_series(k)[0] == series), 3)
            if digest:
                self.heartbeat.update(**digest)
