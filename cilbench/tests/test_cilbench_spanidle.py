"""The idle-in-span readers (``cilbench/spanidle.py`` and the
``idle_in_*`` metrics) on a hand-built trace with known gaps and spans,
and the program's spans in a CPU trace of each cell."""

import collections

import pytest
import torch

from cilbench import run, trace
from cilbench.tests.small import argv_set, bench, overrides

# A 1,000 ns window: busy [100, 300) and [400, 600), idle 600 ns.
GAPS = [(0, 100), (300, 400), (600, 1000)]
HOST = [
    ("epoch", 0, 560, 1, 0),
    ("epoch_replays", 50, 350, 1, 0),  # idle 50 + 50
    ("capture", 320, 340, 1, 0),  # idle 20, inside the replays
    ("evaluate", 550, 900, 1, 0),  # idle 300
    ("eval_matrix", 850, 950, 1, 0),  # idle 100, 50 of it inside evaluate
    ("herd", 0, 500, 1, 0),  # idle 100 + 100
    ("aten::mm", 120, 130, 1, 0),
]
READS = {
    "idle_in_replays": 0.1,
    "idle_in_eval.train": 0.35,
    "idle_in_eval.protocol": 0.35,
    "idle_in_epoch_edge": 0.15,
    "idle_in_herd": 0.2,
    "idle_in_capture": 0.02,
}


def _summary(host=HOST, kernels=(("k", 100, 300, 1), ("k", 400, 600, 2))):
    return trace.TraceSummary(window_s=1e-6, busy_s=4e-7, kernels=list(kernels),
                              host=list(host), gaps=list(GAPS))


def _read(name, summary):
    return run.load_metric(name).read(run.Reading("c", {}, {}, {}, summary))


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_the_exact_share(name):
    assert _read(name, _summary()) == pytest.approx(READS[name], abs=1e-12)


def test_the_epochs_split_sums_to_the_idle_share():
    s = _summary()
    parts = sum(_read(n, s) for n in ("idle_in_replays", "idle_in_eval.train",
                                       "idle_in_epoch_edge"))
    assert parts == pytest.approx(1.0 - s.busy_s / s.window_s, abs=1e-12)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_without_kernels(name):
    assert _read(name, _summary(kernels=())) is None
    assert _read(name, None) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_without_its_spans(name):
    """An older program's trace: host events, none of the reader's spans."""
    assert _read(name, _summary(host=[("epoch", 0, 560, 1, 0), ("aten::mm", 120, 130, 1, 0)])) \
        is None


def test_a_span_outside_every_gap_reads_zero():
    assert _read("idle_in_capture", _summary(host=[("capture", 120, 280, 1, 0)])) == 0.0


def test_herd_parts_read_the_mean_span_wall():
    spans = [{"name": "herd_features", "dur_s": 0.5}, {"name": "herd_features", "dur_s": 0.7},
             {"name": "herd_select", "dur_s": 0.01}, {"name": "herd", "dur_s": 0.75}]
    r = run.Reading("c", {}, {}, {"spans": spans}, None)
    assert run.load_metric("herd_features_s_per_task").read(r) == pytest.approx(0.6)
    assert run.load_metric("herd_select_s_per_task").read(r) == pytest.approx(0.01)
    empty = run.Reading("c", {}, {}, {"spans": [{"name": "herd", "dur_s": 1.0}]}, None)
    assert run.load_metric("herd_select_s_per_task").read(empty) is None


# The CPU runs: the whole window traced, the loop's evaluation every epoch.
SPANS = {"c100-epochs": {"epoch_replays", "evaluate"},
         "c100-protocol": {"epoch_replays", "eval_matrix", "herd", "herd_features",
                           "herd_select"}}


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_cpu_trace_holds_the_programs_spans(cell, monkeypatch):
    kept = []
    orig = trace.summarize
    monkeypatch.setattr(trace, "summarize", lambda *a: kept.append(orig(*a)) or kept[-1])
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        co, wo = overrides(cell)
        co = {**co, "argv": argv_set(co["argv"], eval_every_epoch=1)}
        res = run.run_cell(cell, 7, 1.0, True, device="cpu", config_override=co,
                           workload_override={**wo, "trace_seconds": 1e6}, bench=bench())
    finally:
        torch.set_num_threads(before)
    assert res["correct"], res["checks"]
    names = collections.Counter(h[0] for h in kept[0].host)
    assert SPANS[cell] <= set(names), names
    assert "capture" not in names  # the CPU runs the fused epoch eagerly
    if cell == "c100-protocol":
        m = res["metrics"]
        assert m["herd_features_s_per_task"]["value"] > 0
        assert m["herd_select_s_per_task"]["value"] > 0
    # no device activity on the CPU: no idle reading
    assert not any(k.startswith("idle_in") for k in res["metrics"])
