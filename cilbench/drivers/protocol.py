"""``protocol``: whole class-incremental protocols through ``CilTrainer.fit``,
back to back, each on a trainer of its own (a fresh network from its
seed, as a user's sweep over seeds runs them).

Set-up writes the data (``drivers/epochs.py``), builds the first
protocol's trainer, loads the benchmark's weights into it and follows its
first 3 steps of task 0 through the fused epoch function (the eager step,
the capture, replays), then evaluates once and runs one herding feature
pass, so every shape a protocol uses is warm.  That trainer runs the
first protocol; each later one builds its own from ``--seed`` plus its
index.  The window runs a fixed number of whole protocols: ``--seconds``
over the cell's ``protocol_s`` (the longest a protocol has taken on the
card), rounded down, and at least one, so the window stays inside
``--seconds`` (one protocol of 24-38 s at 51 s).  A window cut inside a
protocol would mix early and late tasks, whose costs differ, in a
proportion that moves with the speed; one that runs protocols until a
time has passed holds one more or one fewer as the speed changes.  A
wrapper around each trainer's ``_run_epoch_fused`` counts the steps.
``protocol_img_per_s`` is the training images of the window over its
length, every task boundary (growth, capture, alignment, the eval matrix,
the teacher snapshot, herding) and the trainers' construction included.

At every task boundary the window passes, the trainer's herding call is
observed: the model as evaluated (after alignment), the trainer's
accuracy row, the augmentation draws of the feature pass, and the
features and the selection the memory made.  After the window the plain
references judge them: the alignment (the new rows' mean norm equals the
old rows'), the eval matrix (the plain classifier's top-1 count of each
seen task's test slice), the feature pass (the plain augmentation and
the plain network's features on one batch a boundary, drawn from the
seed) and the herding selection (the plain barycenter greedy on the same features)."""

from __future__ import annotations

import gc
import json
import os
import time

import numpy as np
import torch

from .. import synth, training
from ..reference import augment as ref_augment
from ..reference import herding as ref_herding
from ..reference import resnet as ref
from .epochs import _data, _feed_mismatch


class _Boundaries:
    """The task boundaries of one trainer, observed at its herding call."""

    def __init__(self, trainer, out: list):
        self.trainer, self.out = trainer, out
        orig_update, mem = trainer._update_memory, trainer.memory
        orig_add = mem.add

        def update_memory(task_id, task_train):
            t = trainer
            rec = {"task": task_id, "known": t.known,
                   "nb_new": t.scenario_train.increments()[task_id],
                   "acc_row": list(t.matrix.rows[task_id]), "draws": [],
                   "state": {k: v.detach().cpu().clone()
                             for k, v in t.state.model.state_dict().items()}}
            self._rec = rec
            with training.recording_draws(rec["draws"]):
                orig_update(task_id, task_train)
            out.append(rec)

        def add(x, y, tt, features):
            orig_add(x, y, tt, features)
            y = np.asarray(y)
            sel = {int(c): mem._store[int(c)][0].copy() for c in np.unique(y)}
            self._rec.update(x=x, y=y, features=np.asarray(features).copy(), selected=sel,
                             quota=mem.quota(len(mem._store)))

        trainer._update_memory, mem.add = update_memory, add


def run(ctx) -> dict:
    cfg, wl = ctx.config, ctx.workload
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.prefetch import to_device

    ctx.phase("imports")
    root = _data(ctx)
    ctx.phase("data")
    ctx.reset_peak()
    base_argv = training.port_argv(cfg, root, ctx.seed, ctx.device) + [
        "--num_epochs", str(wl["epochs_per_task"])]
    tel = []

    def argv_for(k: int):
        argv = list(base_argv)
        argv[argv.index("--seed") + 1] = str((int(ctx.seed) + k) % (1 << 31))
        if ctx.trace:
            tel.append(ctx.path(f"tel{k}"))
            argv += ["--telemetry_dir", tel[-1]]
        return argv

    trainer = training.build(argv_for(0))
    ctx.phase("trainer")
    task_train, dataset_val = training.reach_task(trainer, 0, ctx.seed)
    w = training.load_weights(trainer, 0, ctx.seed, cfg)
    trainer.epoch_fn.reset()
    resident = to_device(trainer.device, task_train.x, task_train.y)
    gen = torch.Generator(device=trainer.device)
    f = training.follow_fused(trainer, 0, len(task_train), resident, gen, wl["check_steps"])
    ctx.phase("followed steps")
    trainer.evaluate(dataset_val)
    trainer._update_memory(0, task_train)  # the herding pass's shapes
    # fit() grows task 0 again from its key: the memory restarts empty.
    trainer.memory._store.clear()
    del resident
    training.sync(ctx.device)
    ctx.phase("warm-up")

    state = {"steps": 0, "base": None}
    boundaries: list = []
    spans: list = []

    def watch(t):
        orig = t._run_epoch_fused

        def epoch(task_id, n, res, ep, g, clock, *a):
            if ctx.tracer.active:
                ctx.tracer.tick(lambda: training.sync(ctx.device))
                if not ctx.tracer.active:
                    state["base"] = (training.now(), state["steps"], time.time())
            rows = orig(task_id, n, res, ep, g, clock, *a)
            state["steps"] += len(rows)
            return rows

        t._run_epoch_fused = epoch
        _Boundaries(t, boundaries)

    protocols = max(1, int(ctx.seconds // wl["protocol_s"]))
    ctx.window_start()
    t0 = training.now()
    for k in range(protocols):
        if k:
            trainer = training.build(argv_for(k))
        watch(trainer)
        trainer.fit()
        spans += trainer.telemetry.spans.completed
        trainer = None
    training.sync(ctx.device)
    t1 = training.now()
    ctx.window_end()
    peak = ctx.read_peak()
    batch = cfg["batch_size"]
    b0, s0, wall0 = state["base"] or (t0, 0, 0.0)
    counters = {"window_s": t1 - b0, "steps": state["steps"] - s0, "batch": batch,
                "spans": [s for s in spans if s["ts"] >= wall0], "compile_s": _compile_s(tel)}
    feed_bad = _feed_mismatch(ctx, f)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = training.reference_numbers(f, w, cfg, ctx.device)
    if wl.get("control"):
        numbers["_control"] = training.control_numbers(f, w, cfg, ctx.device)
    numbers.update(boundary_numbers(ctx, boundaries))
    if wl.get("control"):
        numbers["_control"]["herd_feat_gap"] = numbers.pop("_control_herd_feat_gap")
    numbers["feed_mismatch"] = feed_bad
    numbers["start_mismatch"] = w["start_mismatch"]
    return {
        "e2e": {"protocol_img_per_s": state["steps"] * batch / (t1 - t0)},
        "counters": counters, "numbers": numbers, "attempted": state["steps"], "failed": 0,
        "memory_peak_bytes": peak,
        "log": {"protocols": protocols, "tasks_checked": len(boundaries),
                "steps": state["steps"], "window_s": t1 - t0},
    }


def _compile_s(tel_dirs) -> list:
    """``compile_s`` of each ``compile_event`` the traced runs logged (the
    per-task capture with its eager step)."""
    out = []
    for d in tel_dirs:
        path = os.path.join(d, "run.jsonl")
        if os.path.exists(path):
            for line in open(path):
                rec = json.loads(line)
                if rec.get("type") == "compile_event":
                    out.append(float(rec.get("compile_s", 0.0)))
    return out


def boundary_numbers(ctx, boundaries) -> dict:
    """``align_gap``: the worst relative gap between the mean norm of the
    new head rows and of the old ones after alignment; ``eval_mismatch``:
    test images whose top-1 verdict the plain classifier counts otherwise
    than the trainer's accuracy row; ``herd_mismatch``: exemplars the plain
    greedy would not have kept."""
    cfg = ctx.config
    test_x, test_y = ctx.raw["test"]
    pos = np.empty(len(cfg["class_order"]), np.int64)
    pos[np.asarray(cfg["class_order"])] = np.arange(len(cfg["class_order"]))
    labels = pos[test_y]
    x_dev = torch.from_numpy(test_x).to(ctx.device)
    inc = cfg["increment"]
    align_gap, eval_bad, herd_bad, feat_gap, feat_gap_tf32 = 0.0, 0, 0, 0.0, 0.0
    for i, b in enumerate(boundaries):
        p = {k: v.to(ctx.device) for k, v in b["state"].items() if "running" not in k}
        buf = {k: v.to(ctx.device) for k, v in b["state"].items() if "running" in k}
        known, new = b["known"], b["nb_new"]
        if b["task"] > 0:
            norms = p["fc.weight"].double().norm(dim=1)
            old, cur = norms[:known].mean(), norms[known:known + new].mean()
            align_gap = max(align_gap, float(abs(cur - old) / old))
        with ref.numerics(False):
            for j, acc in enumerate(b["acc_row"]):
                sel = np.where((labels >= j * inc) & (labels < (j + 1) * inc))[0]
                out = ref.classify(p, buf, x_dev[sel], cfg["mean"], cfg["std"], known + new,
                                   cfg["depth"], block=500)
                got = int((out.argmax(1).cpu().numpy() == labels[sel]).sum())
                eval_bad += abs(got - int(round(acc * len(sel) / 100.0)))
        if "features" in b:
            gaps = _feature_gaps(ctx, b, p, buf, i)
            feat_gap = max(feat_gap, gaps[False])
            feat_gap_tf32 = max(feat_gap_tf32, gaps.get(True, 0.0))
            for c, kept in b["selected"].items():
                idx = np.where(b["y"] == c)[0]
                rank = ref_herding.barycenter(b["features"][idx], b["quota"])
                want = b["x"][idx[rank]]
                herd_bad += int(sum(not np.array_equal(a, k) for a, k in zip(want, kept)))
    out = {"align_gap": align_gap, "eval_mismatch": eval_bad, "herd_mismatch": herd_bad,
           "herd_feat_gap": feat_gap, "tasks_checked_missing": int(len(boundaries) == 0)}
    if ctx.workload.get("control"):
        out["_control_herd_feat_gap"] = feat_gap_tf32
    return out


def _feature_gaps(ctx, b, p, buf, i) -> dict:
    """The herding feature pass on one batch of the boundary, drawn from
    the seed: the worst row's gap between the port's features and the
    plain network's on the plain augmentation of the batch's rows with
    the pass's own draws, over the larger of that row's norm and the
    batch's median row norm; with the control, also the reference in
    TF32 against itself in float32 (``{tf32: gap}``)."""
    cfg = ctx.config
    rows = cfg["batch_size"]
    n = len(b["x"])
    if len(b["draws"]) != -(-n // rows):
        return {False: float("inf")}  # a feature pass of other batches than the loader's
    j = int(np.random.Generator(np.random.PCG64(synth.stream_seed(ctx.seed, 17, i)))
            .integers(n // rows))
    x = ref_augment.train_batch(torch.from_numpy(b["x"][j * rows:(j + 1) * rows]).to(ctx.device),
                                b["draws"][j], padding=cfg["crop_padding"], mean=cfg["mean"],
                                std=cfg["std"])
    prog = torch.from_numpy(b["features"][j * rows:(j + 1) * rows]).to(ctx.device).double()
    with ref.numerics(False):
        ref32 = ref.features(p, buf, x, False, cfg["depth"]).double()
    out = {False: _worst_row(prog, ref32)}
    if ctx.workload.get("control"):
        with ref.numerics(True):
            out[True] = _worst_row(ref.features(p, buf, x, False, cfg["depth"]).double(), ref32)
    return out


def _worst_row(a: torch.Tensor, r: torch.Tensor) -> float:
    rn = r.norm(dim=1)
    return float(((a - r).norm(dim=1) / torch.clamp(rn, min=float(rn.median()))).max())
