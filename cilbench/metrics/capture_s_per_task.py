"""``capture_s_per_task``: the mean ``compile_s`` of the trainer's
``compile_event`` records, one a task: the fused epoch's eager step and
CUDA-graph capture at the task's first epoch (``run.jsonl`` of the traced
run)."""


def read(r):
    caps = r.counters.get("compile_s") or []
    mean = sum(caps) / len(caps) if caps else 0.0
    return mean if mean > 0 else None  # no capture: the CPU runs eagerly
