"""``eval_s_per_task``: the mean wall seconds of the program's ``eval_matrix`` span a task,
over the tasks of the window after its traced part (the trainer's
``spans.jsonl`` records, with ``--telemetry_dir`` in the traced run)."""

SPAN = "eval_matrix"


def read(r):
    durs = [s["dur_s"] for s in r.counters.get("spans", []) if s.get("name") == SPAN]
    return sum(durs) / len(durs) if durs else None
