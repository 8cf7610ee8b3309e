"""The WA task loop: per-task train, align, eval and herd.

Counterpart of the JAX package's ``engine/loop.py`` on its per-step path.
Per task: inject the rehearsal exemplars, grow the head and reset SGD, run
the epochs (with the reference's eval cadence), weight-align the new head
(tasks > 0), evaluate every seen task's slice, snapshot the teacher (a deep
copy), herd the next memory, and write the ``run/epoch/task/cil_metrics/
final`` JSONL records.  The fused epoch, prefetch, telemetry spans,
checkpoints, faults, lockstep and export arrive with later slices.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import CilConfig, check_supported
from ..data import (
    RehearsalMemory,
    build_scenario,
    eval_batches,
    sequential_batches,
    train_batches,
)
from ..data.augment import AugmentConfig
from ..models import align, create_model, grow
from ..telemetry import AccuracyMatrix, average_incremental_accuracy
from ..utils.logging import JsonlLogger, MetricLogger
from ..utils.platform import derive_seed, make_generator, resolve_device, use_full_f32
from .train import (
    Teacher,
    TrainState,
    cosine_lr,
    make_eval_step,
    make_feature_step,
    make_train_step,
    sgd_init,
)

# Generator streams: (seed, stream, task[, epoch]) coordinates.
_INIT_STREAM = 0xC11
_HERD_STREAM = 0xFEED
_AUG_STREAM = 0xA06


def _eval_line(totals) -> str:
    loss_sum, c1, c5, n = totals
    return (
        f" Acc@1 {100.0 * c1 / max(n, 1.0):.3f}"
        f"  Acc@5 {100.0 * c5 / max(n, 1.0):.3f}"
        f"  loss {loss_sum / max(n, 1.0):.3f}"
    )


class CilTrainer:
    """Builds the data, model and steps, and runs the class-incremental
    experiment on ``device`` (CUDA unless the caller asks for ``"cpu"``)."""

    def __init__(self, config: CilConfig, device: Optional[str] = None):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        use_full_f32()
        self.jsonl = JsonlLogger(config.log_file)
        self.scenario_train, self.nb_classes = build_scenario(config, train=True)
        self.scenario_val, _ = build_scenario(config, train=False)

        data_x = self.scenario_train._x
        if data_x.shape[1] != config.input_size:
            raise ValueError(
                f"data_set {config.data_set!r} images are {data_x.shape[1]}px "
                f"but --input_size is {config.input_size}"
            )
        self.aug_cfg = AugmentConfig.from_config(config)
        self.global_batch_size = config.batch_size  # one device

        model = create_model(
            config.backbone, self.nb_classes,
            seed=derive_seed(config.seed, _INIT_STREAM),
        ).to(self.device)
        self.state = TrainState(
            model=model,
            momentum=sgd_init(model.parameters()),
            num_active=self._count(0),
            known=self._count(0),
        )
        self.teacher: Optional[Teacher] = None
        self.memory = RehearsalMemory(
            memory_size=config.memory_size,
            herding_method=config.herding_method,
            fixed_memory=config.fixed_memory,
            nb_total_classes=self.nb_classes if config.fixed_memory else None,
        )
        self.train_step = make_train_step(
            self.aug_cfg,
            label_smoothing=config.smooth,
            kd_temperature=config.kd_temperature,
            momentum=config.momentum,
            weight_decay=config.weight_decay,
            use_pallas_loss=config.use_pallas_loss,
        )
        self.eval_step = make_eval_step(self.aug_cfg)
        self.feature_step = make_feature_step(
            self.aug_cfg, augmented=config.herding_augmented
        )
        self.global_step = 0
        self.jsonl.log(
            "run",
            data_set=config.data_set,
            backbone=config.backbone,
            num_bases=config.num_bases,
            increment=config.increment,
            batch_size=config.batch_size,
            global_batch=self.global_batch_size,
            num_epochs=config.num_epochs,
            lr=config.lr,
            seed=config.seed,
            aa=config.aa,
            memory_size=config.memory_size,
            compute_dtype=config.compute_dtype,
            precision="f32",
            backend=f"torch-{self.device.type}",
            device_name=(torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "cpu"),
            torch_version=torch.__version__,
            use_pallas_loss=config.use_pallas_loss,
            mesh={"data": 1, "model": 1},
            processes=1,
        )
        self.acc1s: List[float] = []
        self.matrix = AccuracyMatrix()
        self.known = 0

    def _count(self, n: int) -> torch.Tensor:
        return torch.tensor([n], dtype=torch.int32, device=self.device)

    def _to_device(self, *arrays: np.ndarray):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

    # ------------------------------------------------------------------ #
    # The experiment
    # ------------------------------------------------------------------ #

    def fit(self) -> Dict:
        """Run every task; returns the headline results."""
        increments = self.scenario_train.increments()
        for task_id, task_train in enumerate(self.scenario_train):
            nb_new = increments[task_id]
            dataset_val = self.scenario_val[: task_id + 1]
            if task_id > 0:
                task_train.add_samples(*self.memory.get())
            self._grow_state(task_id, self.known, nb_new)
            t0 = time.time()
            self._fit_task(task_id, task_train, dataset_val)

            gamma = None
            if task_id > 0:
                gamma = align(self.state.model, self.known, nb_new)
                print(f"old norm / new norm ={gamma}")
            # One accuracy-matrix row: each seen task's val slice evaluated
            # separately; the exact weighted totals sum to the cumulative
            # ones.  One device->host fetch for the whole row.
            slice_totals = torch.stack([
                self._eval_totals_device(self.scenario_val[j])
                for j in range(task_id + 1)
            ]).cpu().numpy()
            totals = slice_totals.sum(axis=0)
            print(_eval_line(totals))
            acc1 = float(100.0 * totals[1] / max(totals[3], 1.0))
            self.acc1s.append(acc1)
            acc_per_task = [
                round(float(100.0 * t[1] / max(t[3], 1.0)), 5) for t in slice_totals
            ]
            task_s = time.time() - t0
            print(
                f"task id = {task_id}  @Acc1 = {acc1:.5f}, "
                f"acc1s = {self.acc1s}  ({task_s:.1f}s)"
            )
            self.jsonl.log(
                "task",
                task_id=task_id,
                acc1=acc1,
                acc1s=list(self.acc1s),
                acc_per_task=acc_per_task,
                gamma=gamma,
                nb_new=nb_new,
                known_after=self.known + nb_new,
                seconds=round(task_s, 1),
            )
            self.matrix.add_row(task_id, acc_per_task)
            self.jsonl.log(
                "cil_metrics",
                task_id=task_id,
                avg_incremental_acc1=round(average_incremental_accuracy(self.acc1s), 5),
                **self.matrix.summary(),
            )
            # Teacher snapshot: a deep copy, so the student's in-place SGD
            # updates never reach it.
            teacher_model = copy.deepcopy(self.state.model).requires_grad_(False)
            self.teacher = Teacher(model=teacher_model, known=self._count(self.known + nb_new))
            self._update_memory(task_id, task_train)
            self.known += nb_new
        avg_inc = float(np.mean(self.acc1s)) if self.acc1s else 0.0
        print(f"avg incremental top-1 = {avg_inc:.3f}")
        summary = self.matrix.summary() if self.matrix.rows else {}
        self.jsonl.log(
            "final", acc1s=list(self.acc1s), avg_incremental_acc1=avg_inc, **summary
        )
        return {
            "acc1s": self.acc1s,
            "acc_matrix": self.matrix.as_list(),
            "avg_incremental_acc1": avg_inc,
            "forgetting": summary.get("forgetting"),
            "bwt": summary.get("bwt"),
            "nb_tasks": len(increments),
        }

    def _grow_state(self, task_id: int, known: int, nb_new: int) -> None:
        """Head growth, a fresh SGD momentum and the task's class counts."""
        gen = make_generator(torch.device("cpu"), self.config.seed, _INIT_STREAM, task_id)
        grow(self.state.model, gen, known, nb_new)
        self.state.momentum = sgd_init(self.state.model.parameters())
        self.state.num_active = self._count(known + nb_new)
        self.state.known = self._count(known)

    def _lambda_kd(self, task_id: int) -> float:
        """λ for the KD term; with ``dynamic_lambda_kd``, n/(n+m)."""
        cfg = self.config
        if not cfg.dynamic_lambda_kd or task_id == 0:
            return cfg.lambda_kd
        incs = self.scenario_train.increments()
        n = sum(incs[:task_id])
        m = incs[task_id]
        return n / (n + m)

    def _fit_task(self, task_id: int, task_train, dataset_val) -> None:
        cfg = self.config
        lam = self._lambda_kd(task_id)
        for epoch in range(cfg.num_epochs):
            t_epoch = time.perf_counter()
            lr = cosine_lr(cfg.lr, epoch, cfg.num_epochs)
            clock = {"host_s": 0.0, "device_s": 0.0}
            pending = self._run_epoch_steps(task_id, task_train, epoch, lr, lam, clock)
            logger = MetricLogger(delimiter="  ")
            for m in pending:
                logger.update(**m)
            print(f"train states: epoch :[{epoch + 1}/{cfg.num_epochs}] {logger}")
            busy = clock["host_s"] + clock["device_s"]
            self.jsonl.log(
                "epoch",
                task_id=task_id,
                epoch=epoch + 1,
                lr=lr,
                epoch_s=round(time.perf_counter() - t_epoch, 2),
                steps=len(pending),
                host_s=round(clock["host_s"], 4),
                device_s=round(clock["device_s"], 4),
                stall_frac=round(clock["host_s"] / busy, 4) if busy > 0 else 0.0,
                **{k: m.global_avg for k, m in logger.meters.items()},
            )
            # The reference's cadence: with num_epochs a multiple of
            # eval_every_epoch this also evaluates at the last epoch, before
            # alignment, besides the post-alignment eval in fit().
            if (epoch + 1) % cfg.eval_every_epoch == 0:
                self.evaluate(dataset_val)

    def _run_epoch_steps(self, task_id, task_train, epoch, lr, lam, clock) -> List[Dict]:
        """One train step per batch; the step metrics stay on the device and
        come back in one fetch at the end of the epoch.  ``clock`` splits the
        epoch into host batch production and time spent in (or waiting on)
        the device steps."""
        cfg = self.config
        shuffle_seed = hash((cfg.seed, task_id, epoch)) & 0x7FFFFFFF
        gen = make_generator(self.device, cfg.seed, _AUG_STREAM, task_id, epoch)
        rows = []
        keys = None
        batches = train_batches(task_train, self.global_batch_size, shuffle_seed)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            x, y = self._to_device(*batch)
            t1 = time.perf_counter()
            metrics = self.train_step(self.state, self.teacher, x, y, gen, lr, lam)
            if keys is None:
                keys = sorted(metrics)
            rows.append(torch.stack([metrics[k] for k in keys]))
            self.global_step += 1
            clock["host_s"] += t1 - t0
            clock["device_s"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        host = torch.stack(rows).cpu().numpy()  # waits for the epoch's steps
        clock["device_s"] += time.perf_counter() - t0
        return [dict(zip(keys, row)) for row in host]

    # ------------------------------------------------------------------ #
    # Eval
    # ------------------------------------------------------------------ #

    def _eval_totals_device(self, dataset_val) -> torch.Tensor:
        """``[loss_sum, correct1, correct5, n]`` over a val set, on device."""
        totals = None
        for xb, yb, wb in eval_batches(dataset_val, self.global_batch_size):
            x, y, w = self._to_device(xb, yb, wb)
            out = self.eval_step(self.state.model, x, y, w, self.state.num_active)
            totals = out if totals is None else totals + out
        return totals

    def evaluate(self, dataset_val) -> float:
        totals = self._eval_totals_device(dataset_val).cpu().numpy()
        print(_eval_line(totals))
        return float(100.0 * totals[1] / max(totals[3], 1.0))

    # ------------------------------------------------------------------ #
    # Herding pass
    # ------------------------------------------------------------------ #

    def _update_memory(self, task_id: int, task_train) -> None:
        """Features of every sample of the task (plus injected exemplars) in
        an unshuffled pass, then the herding selection on the host."""
        gen = make_generator(self.device, self.config.seed, _HERD_STREAM, task_id)
        feats = []
        for xb, _yb in sequential_batches(task_train, self.global_batch_size):
            (x,) = self._to_device(xb)
            feats.append(self.feature_step(self.state.model, x, gen))
        features = torch.cat(feats).cpu().numpy()[: len(task_train)]
        self.memory.add(*task_train.get_raw_samples(), features)

