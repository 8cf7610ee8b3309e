"""``replay_step_ms``: CUDA events around each epoch of replayed steps in
the window (after the traced part), summed and divided by their steps."""


def read(r):
    c = r.counters
    if not c.get("replay_ms") or not c.get("replay_steps"):
        return None
    return c["replay_ms"] / c["replay_steps"]
