"""``herd_select_s_per_task``: the mean wall seconds of the program's
``herd_select`` span (the memory's greedy selection on the host) a task,
over the tasks of the window after its traced part (the trainer's
``spans.jsonl`` records, with ``--telemetry_dir`` in the traced run)."""

SPAN = "herd_select"


def read(r):
    durs = [s["dur_s"] for s in r.counters.get("spans", []) if s.get("name") == SPAN]
    return sum(durs) / len(durs) if durs else None
