"""Training/serving skew: accuracy re-measured through the artifact.

Counterpart of the JAX package's ``serving/skew.py``.  The trainer's
accuracy row says what the live model scored right after weight alignment;
``measure_skew`` asks whether the *served* model (export, save, reload, a
replayed graph a bucket) still scores that, and logs one ``serve_skew``
record with the per-task served accuracies beside the training row.  A
lazy image-folder slice (file paths) decodes as evaluation decodes it
(``train=False``) at the artifact's ``meta["input_size"]``; pixel slices
pass through.

``probe_artifact`` is the online form of the question: the export froze a
golden ``probe.npz`` (a seeded input and the logits of the artifact's own
load path), and a freshly swapped-in server replays it and demands bit
equality.  It is the promotion gate of a swap: a miss rolls the swap back
(``serve_rollback``) instead of serving skewed logits.
"""

from __future__ import annotations

import io
import os
from typing import Optional, Sequence

import numpy as np

from ..data.datasets import maybe_decode
from .artifact import _check_sidecar


def _slice_accuracy(artifact, x: np.ndarray, y: np.ndarray) -> float:
    logits = artifact.predict(x)
    top1 = np.argmax(logits[:, : artifact.known], axis=-1)
    return float(100.0 * np.mean(top1 == np.asarray(y)))


def measure_skew(
    artifact,
    scenario_val,
    sink=None,
    train_acc_per_task: Optional[Sequence[float]] = None,
) -> dict:
    """Served accuracy of each seen task's validation slice against the
    training row; one record.  The artifact's ``known`` says how many of
    ``scenario_val``'s tasks its head covers.  Returns the record's fields
    (also logged to ``sink`` when given)."""
    seen, cum = 0, 0
    for inc in scenario_val.increments():
        if cum + inc > artifact.known:
            break
        cum += inc
        seen += 1
    served, weights = [], []
    for j in range(seen):
        task = scenario_val[j]
        x = maybe_decode(task.x, artifact.meta["input_size"], train=False)
        served.append(round(_slice_accuracy(artifact, x, task.y), 5))
        weights.append(len(task.y))
    total = max(sum(weights), 1)
    served_acc1 = round(float(sum(a * w for a, w in zip(served, weights)) / total), 5)
    train_row = ([float(a) for a in train_acc_per_task[:seen]]
                 if train_acc_per_task is not None else None)
    skew_abs_max = (round(max(abs(s - t) for s, t in zip(served, train_row)), 5)
                    if train_row else None)
    record = dict(
        task_id=artifact.task_id,
        served_acc1=served_acc1,
        served_acc_per_task=served,
        train_acc_per_task=train_row,
        skew_abs_max=skew_abs_max,
        n=int(total),
    )
    if sink is not None:
        sink.log("serve_skew", **record)
    return record


def probe_artifact(artifact) -> dict:
    """Replay the artifact's golden probe through its loaded programs.

    Returns ``{"ok", "checked", "max_abs"}`` (and ``"error"`` on a failure).
    ``ok`` is the verdict: bit equality with the logits the export froze.
    An artifact without a probe passes with ``checked=False``; a probe that
    fails its checksum or cannot be read fails, since an unverifiable
    artifact must not be promoted."""
    probe_name = artifact.meta.get("files", {}).get("probe")
    if not probe_name:
        return {"ok": True, "checked": False, "max_abs": 0.0}
    path = os.path.join(artifact.path, probe_name)
    try:
        _check_sidecar(path)
        with open(path, "rb") as f:
            blob = np.load(io.BytesIO(f.read()))
            probe_x = blob["x"]
            want_logits = blob["logits"]
            bucket = int(blob["bucket"])
    except (OSError, ValueError, KeyError) as e:
        return {"ok": False, "checked": True, "max_abs": float("inf"),
                "error": f"unreadable probe: {e!r}"}
    if bucket not in artifact.buckets:
        return {"ok": False, "checked": True, "max_abs": float("inf"),
                "error": f"probe bucket {bucket} not loaded"}
    got_logits = artifact.predict_padded(probe_x, bucket)
    max_abs = float(np.max(np.abs(got_logits.astype(np.float64)
                                  - want_logits.astype(np.float64))))
    return {"ok": bool(np.array_equal(got_logits, want_logits)), "checked": True,
            "max_abs": max_abs}
