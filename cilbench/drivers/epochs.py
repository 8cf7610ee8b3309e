"""``epochs``: the trainer's own per-epoch loop on one task, back to back.

Set-up reaches the cell's task (``training.reach_task``), loads the
benchmark's weights, follows the first steps through the fused epoch
function (the eager step, the CUDA-graph capture, then replays) and
evaluates once.  Then it calls the trainer's ``_fit_task`` from epoch 1,
whose first epoch resets the fused function, puts the task's dataset on
the device and captures the step again: that epoch is set-up too.  The
window opens as the loop enters its second epoch and runs the loop as a
user's run does: the cosine lr, the reseeded augmentation generator, the
epoch span, ``_run_epoch_fused`` (a replay a step, one fetch an epoch),
the metric logger, the epoch record, the recompile check, the heartbeat,
the checkpoint hook and ``evaluate`` every ``eval_every_epoch`` epochs.  A
wrapper around ``_run_epoch_fused`` ends the loop (``StopSteps``) at the
first epoch due after ``--seconds``, so the window holds whole turns of
the loop.  The images of every step in the window over the window's
length is ``train_img_per_s``."""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import synth, training


def _data(ctx) -> str:
    cfg = ctx.config
    d = cfg["dataset"]
    (train, test) = synth.class_images(
        cfg["num_classes"], [d["train_per_class"], d["test_per_class"]], cfg["input_size"],
        ctx.seed, ctx.device, noise_std=d["noise_std"])
    ctx.raw = {"train": train, "test": test}
    return synth.write_cifar100(ctx.path("data"), train, test)


def _feed_mismatch(ctx, f) -> int:
    """Rows the followed steps gathered whose label is not their image's
    class in the benchmark's own data, remapped by the configuration's
    class order."""
    x, y = ctx.raw["train"]
    where = {x[i].tobytes(): int(y[i]) for i in range(len(y))}
    pos = {c: i for i, c in enumerate(ctx.config["class_order"])}
    bad = 0
    for rows, labels in zip(f.rows, f.y):
        for img, lab in zip(rows, labels.tolist()):
            raw = where.get(np.ascontiguousarray(img).tobytes())
            bad += raw is None or pos[raw] != lab
    return bad


def run(ctx) -> dict:
    cfg, wl = ctx.config, ctx.workload
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.prefetch import to_device

    ctx.phase("imports")
    root = _data(ctx)
    ctx.phase("data")
    ctx.reset_peak()
    trainer = training.build(training.port_argv(cfg, root, ctx.seed, ctx.device))
    task = wl["task"]
    ctx.phase("trainer")
    task_train, dataset_val = training.reach_task(trainer, task, ctx.seed)
    w = training.load_weights(trainer, task, ctx.seed, cfg)
    ctx.phase("task and weights")
    n = len(task_train)
    trainer.epoch_fn.reset()
    resident = to_device(trainer.device, task_train.x, task_train.y)
    trainer._lam.fill_(trainer._lambda_kd(task))
    gen = torch.Generator(device=trainer.device)
    f = training.follow_fused(trainer, task, n, resident, gen, wl["check_steps"])
    del resident, gen
    ctx.phase("followed steps")
    trainer.evaluate(dataset_val)  # warm the eval shapes
    training.sync(ctx.device)
    ctx.phase("eval warm-up")

    orig = trainer._run_epoch_fused
    st = {"calls": 0, "epochs": 0, "steps": 0, "nonfinite": 0, "t0": None, "base": None,
          "replay": []}

    def epoch(task_id, n_rows, res, ep, g, clock, *a):
        st["calls"] += 1
        if st["calls"] == 2:  # the capture epoch is behind: the window opens
            training.sync(ctx.device)
            ctx.phase("capture epoch")
            ctx.window_start()
            st["t0"] = training.now()
        elif st["t0"] is not None and training.now() >= st["t0"] + ctx.seconds:
            raise training.StopSteps
        if ctx.tracer.active:
            ctx.tracer.tick(lambda: training.sync(ctx.device))
            if not ctx.tracer.active:
                st["base"] = (training.now(), st["steps"], len(st["replay"]))
        ev = ctx.event_pair() if st["t0"] is not None else None
        if ev:
            ev[0].record()
        rows = orig(task_id, n_rows, res, ep, g, clock, *a)
        if ev:
            ev[1].record()
            st["replay"].append(ev)
        if st["t0"] is not None:
            st["epochs"] += 1
            st["steps"] += len(rows)
            st["nonfinite"] += sum(not np.isfinite(r["loss"]) for r in rows)
        return rows

    trainer._run_epoch_fused = epoch
    try:
        trainer._fit_task(task, task_train, dataset_val, trainer.scenario_train.increments()[task],
                          start_epoch=1)
    except training.StopSteps:
        pass
    training.sync(ctx.device)
    t1 = training.now()
    ctx.window_end()
    peak = ctx.read_peak()
    t0, steps, replay = st["t0"], st["steps"], st["replay"]
    if t0 is None:
        raise RuntimeError(f"the task's {cfg['num_epochs']} epochs ended before the window")

    b0, s0, r0 = st["base"] or (t0, 0, 0)
    replay_ms = sum(a.elapsed_time(b) for a, b in replay[r0:]) if replay else None
    counters = {
        "window_s": t1 - b0, "steps": steps - s0, "batch": trainer.global_batch_size,
        "teacher": True, "head_width": cfg["head_width"],
        "replay_ms": replay_ms, "replay_steps": steps - s0,
    }
    images = steps * trainer.global_batch_size
    feed_bad = _feed_mismatch(ctx, f)
    trainer._run_epoch_fused = orig
    del trainer
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = training.reference_numbers(f, w, cfg, ctx.device)
    if ctx.workload.get("control"):
        numbers["_control"] = training.control_numbers(f, w, cfg, ctx.device)
    numbers["feed_mismatch"] = feed_bad
    numbers["start_mismatch"] = w["start_mismatch"]
    numbers["window_loss_nonfinite"] = int(st["nonfinite"])
    return {
        "e2e": {"train_img_per_s": images / (t1 - t0)},
        "counters": counters, "numbers": numbers, "attempted": steps,
        "failed": numbers["window_loss_nonfinite"], "memory_peak_bytes": peak,
        "log": {"epochs": st["epochs"], "steps": steps, "window_s": t1 - t0},
    }
