"""The WA task loop: per-task train, align, eval and herd.

Counterpart of the JAX package's ``engine/loop.py``.  Per task: inject the
rehearsal exemplars, grow the head and reset SGD, run the epochs (with the
reference's eval cadence), weight-align the new head (tasks > 0), evaluate
every seen task's slice, snapshot the teacher (a deep copy), herd the next
memory, and write the ``run/epoch/task/cil_metrics/final`` JSONL records.

The fused epoch (``--fused_epochs``, the parser's default; JAX
``engine/loop.py:715``): when the task's pixels are uint8, its dataset goes
to the device once per task and every epoch runs through
:func:`~.train.make_epoch_fn`: the batches are gathered on the device, and
on CUDA at one rank each step is a replay of a CUDA graph captured once per
task.  ``--no_fused_epochs`` runs the per-step loop, one host batch and one
step dispatch at a time.  Both paths read the same epoch index table
(``data/loader.py:epoch_index_table``, the seeded permutation of
``hash((seed, task, epoch))`` wrap-padded to whole batches) and the same
augmentation generator, reseeded each epoch from ``(seed, stream, task,
epoch)``, so they train bitwise alike.  This departs from the JAX package,
whose fused epoch draws another permutation on the device
(``jax.random.permutation(fold_in(key, 0xC0FFEE), n)``) than its per-step
loop: the port keeps one order, so the two paths and an epoch-boundary
resume agree exactly, and needs no copy of threefry's shuffle.

``--prefetch_depth N > 0`` (``data/prefetch.py``) moves batch production
and the host-to-device copy of the per-batch paths (the per-step train
loop, evaluation and the herding pass) onto a producer thread with a ring
of N batches, on a side stream on CUDA; the stream of batches is the same
at every depth.  On the fused path it arms a warm ring instead: after the
herding of task t, the next task's dataset (its slice plus the new
exemplars) is copied to the device in the background, and task t+1 takes
it after checking the task id, the labels and every (N/8)-th row
(``prefetch_warm`` records a hit or a miss with its reason; a miss copies
synchronously).

Checkpoints and faults (``utils/checkpoint.py``, the stdlib-only
``faults/`` package): with ``--ckpt_dir`` a task checkpoint lands after
each task's herding, and with ``--epoch_ckpt_every E`` an epoch checkpoint
every E epochs; a transient save failure is logged (``ckpt_save_error``)
and the run goes on.  ``--resume`` restores the newest valid checkpoint and
skips the tasks (and, mid-task, the epochs and the head growth) it covers;
the log is appended to.  ``--fault_spec`` fires at ``engine.epoch`` (after
the epoch checkpoint), ``engine.step`` (after each step's dispatch on the
per-step path; settled by ``reconcile_steps`` after a fused epoch, before
its checkpoint), ``data.produce`` (as each host batch is placed, on the
producer thread at depth > 0) and ``ckpt.save``.  Every generator stream
is seeded from ``(seed, stream, task[, epoch])`` alone and every shuffle
hashes ``(seed, task, epoch)``, so no stream depends on the draws before it
and an epoch-boundary resume repeats the uninterrupted run.

Telemetry (``telemetry/``, JAX ``engine/loop.py:91-186``), at JAX's sites:
the ``fit`` > ``task`` > {``rehearsal_inject``, ``head_grow``, ``epoch``,
``epoch_checkpoint``, ``align``, ``eval_matrix``, ``teacher_snapshot``,
``herd``, ``checkpoint``} span tree (``build_scenario`` before it) with
``--telemetry_dir``; the heartbeat (phases ``train``, ``eval``, ``herd`` and
each epoch) with ``--heartbeat_path`` or a telemetry dir; the flight
recorder, which the fault injector's ``on_fatal`` and the lockstep
sentinel dump through; the metrics registry (``steps_total``,
``step_latency_ms``, ``epochs_total``, ``stall_frac``, ``recompiles_total``)
always, its ``metrics_snapshot`` pump when telemetry is on; and, under
every flag set, a ``compile_event`` at each task's first executed epoch, a
``recompile`` record when the train group's captured graphs grow (a
program is a CUDA graph: ``EpochFn._cache_size``; eager steps hold none),
and an ``hbm`` record a task on the card.  No telemetry runs between a
capture's begin and end: spans and ``record_function`` wrap the epoch,
and the telemetry threads never touch CUDA.  ``step_latency_ms`` is, per
step, the host's time to dispatch an eager step on the per-step path and,
on the fused path, one observation an epoch: the epoch's replays and its
one fetch over its steps (JAX: its scan's dispatch and fetch).
``--profile_dir`` runs each task's first executed epoch, its graph capture
included, under ``torch.profiler`` and logs ``profile_trace`` with the
trace's file.  ``--recompile_budget`` holds the captures to one per head
growth or restore; ``--check_threads`` and ``--check_contracts`` install
``analysis/threadcheck.py`` and ``analysis/contractcheck.py``;
``--check_lockstep`` fingerprints every train, eval and herding dispatch
with ``analysis/lockstep.py`` and compares ranks: once a fused epoch, with
a digest of the task's host arrays; once a step on the per-step path, with
a digest of the global batch (made on the producer thread), which every
rank holds and takes its stripe of.

Native herding (``utils/native.py``): the C++ greedy of
``csrc/cil_host.cpp``, built at startup, used only when every rank has it
(an all-reduce MIN of the ranks' availability).

The precision policy is resolved once from the config (``--precision``
wins over ``--compute_dtype``) and handed to the model, the teacher (a copy
of it) and the train step; TF32 stays off, so the f32 parts of every preset
are full f32.

Over a ``(data, model)`` mesh of ``d·m`` processes (``torchrun ...
--mesh_data d --mesh_model m``; ``parallel/mesh.py``): the global batch is
``batch_size × d`` and data index ``i`` trains on, and evaluates, the
stripe ``[i·b, (i+1)·b)`` of each global batch; the eval totals are
all-reduced over the data axis before their one host fetch.  The ``m``
ranks of a data index see the same stripe and augment it with the same
draws; each holds its rows of the head (``width_multiple=m`` pads the head
so that it shards), and the forward gathers the full head, so the logits,
the loss and ``γ`` are the unsharded ones on every rank.  Everything else
is replicated with no communication: the model is made from the same seed
and its backbone broadcast from rank 0 once, head growth and augmentation
draw from generators seeded alike on every rank, every rank holds the
whole task dataset on the fused path, and every rank herds the same memory
from the full, unsharded feature pass.  Files and agreements go by the
global rank: rank 0 writes the JSONL log and prints; rank ``r > 0`` writes
``<name>_p<r>.jsonl``.

Serving (``--export_dir``, ``serving/``; JAX ``engine/loop.py:606-610``):
after each task's ``cil_metrics`` record and before the teacher snapshot,
the aligned model is exported as a per-task artifact under the span
``export_artifact`` (``serve_export``); ``--serve_skew_check`` reloads it
and re-scores every seen slice through it (``serve_skew``).  The export
and reload capture graphs of their own, none of the ``train`` group's, so
the ``recompile`` records are unchanged.

MNIST and the 1-channel backbones (``--data_set mnist|synthetic_mnist``,
``--backbone resnet20mnist|resnet32mnist``): the channel count comes from
the backbone's name, and a channel or size mismatch with the data, or
RandAugment on one channel, raises at construction (JAX
``engine/loop.py:243-277``).

The image-folder dataset (``--data_set imagenet1000``, JAX
``engine/loop.py:249-270``): its ``x`` is an object array of file paths,
which must feed a 3-channel backbone.  Paths stay on the per-step loop
(the fused epoch and the warm ring need pixels) and decode on the host,
on the prefetcher's producer thread at ``--prefetch_depth > 0``, at JAX's
three sites with JAX's seeds: train with the epoch's shuffle seed plus the
step index, eval with ``train=False``, herding with
``train=--herding_augmented`` and the batch index.  A path batch's
lockstep digest is over its paths' UTF-8 bytes, since an object array's
bytes are pointers.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import CilConfig
from ..data import (
    RehearsalMemory,
    build_scenario,
    epoch_index_table,
    eval_batches,
    sequential_batches,
    train_batches,
)
from ..data.augment import AugmentConfig
from ..data.datasets import is_path_array, maybe_decode, path_digest_bytes
from ..data.prefetch import DevicePrefetcher, to_device
from ..models import align, create_model, group_span, grow, trainer_keys
from ..models.resnet import backbone_channels
from ..ops.precision import policy_from_config
from ..parallel import barrier, broadcast_module, make_mesh
from ..telemetry import (
    AccuracyMatrix,
    CompileWatch,
    StallClock,
    Telemetry,
    average_incremental_accuracy,
)
from ..utils import jax_random
from ..utils.logging import JsonlLogger, MetricLogger
from ..utils.profiling import task_trace
from ..utils.platform import derive_seed, make_generator, resolve_device, use_full_f32
from .train import (
    METRICS,
    Teacher,
    TrainState,
    cosine_lr,
    make_epoch_fn,
    make_eval_step,
    make_feature_step,
    make_train_step,
    sgd_init,
)

# Generator streams: (seed, stream, task[, epoch]) coordinates.  The
# initial network and the heads come from JAX's keys (``trainer_keys``).
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
        self.config = config
        self.device = resolve_device(device)
        self.mesh = make_mesh(config.mesh_shape)
        # The data axis: the stripe, the augmentation draws, the loss shares
        # and the eval totals.  The global rank (self.mesh.rank) names the
        # files and takes part in the agreements.
        self.axis = self.mesh.data
        if config.bn_group_size > 0:
            group_span(config.bn_group_size, config.batch_size, self.axis.size)
        use_full_f32()
        # --check_threads first, so the telemetry's locks are made
        # instrumented; --check_contracts wraps the log under the flight tee.
        self.threadcheck = None
        if config.check_threads:
            from analysis import threadcheck

            self.threadcheck = threadcheck.install()
        contracts = None
        if config.check_contracts:
            from analysis import contractcheck as contracts
        self.contractcheck = contracts.install() if contracts is not None else None
        log_path = config.log_file
        if log_path is None and config.telemetry_dir:
            log_path = os.path.join(config.telemetry_dir, "run.jsonl")
        # A resumed run appends, so the records before the crash stay.
        self.jsonl = JsonlLogger(log_path, append=config.resume,
                                 process_index=self.mesh.rank,
                                 process_count=self.mesh.size)
        if contracts is not None:
            self.jsonl = contracts.wrap_sink(self.jsonl)
        self.telemetry = Telemetry(
            telemetry_dir=config.telemetry_dir,
            heartbeat_path=config.heartbeat_path,
            heartbeat_interval_s=config.heartbeat_interval_s,
            sink=self.jsonl,
            flight_events=config.flight_events,
            process_index=self.mesh.rank,
            process_count=self.mesh.size,
            metrics=config.metrics,
            metrics_interval_s=config.metrics_interval_s,
            metrics_source="train",
            devices=[self.device],
        )
        # The flight tee, when there is a flight recorder.
        self.jsonl = self.telemetry.sink
        if self.threadcheck is not None:
            self.threadcheck.bind_sink(self.jsonl)
        if contracts is not None:
            self.contractcheck.bind_sink(self.jsonl)
            self.telemetry.metrics = contracts.wrap_registry(self.telemetry.metrics)
        reg = self.telemetry.metrics
        self._m_steps = reg.counter("steps_total")
        self._m_step_ms = reg.histogram("step_latency_ms", lowest=0.5, growth=2.0, buckets=18)
        self._m_epochs = reg.counter("epochs_total")
        self._m_stall = reg.gauge("stall_frac")
        self._m_recompiles = reg.gauge("recompiles_total")
        self.lockstep = self._lockstep_sentinel()
        self.faults = self._fault_injector()
        with self.telemetry.span("build_scenario"):
            self.scenario_train, self.nb_classes = build_scenario(config, train=True)
            self.scenario_val, _ = build_scenario(config, train=False)
        self._compile_watch = CompileWatch.install()

        channels = backbone_channels(config.backbone)
        data_x = self.scenario_train._x
        if is_path_array(data_x):
            # A lazy image-folder dataset decodes to RGB at --input_size.
            if channels != 3:
                raise ValueError(
                    f"backbone {config.backbone!r} expects {channels}-channel input but "
                    f"data_set {config.data_set!r} decodes to RGB"
                )
            # The decoder is built now (g++, or the cached library), so no
            # build lands mid-epoch; without a compiler this raises.
            from ..utils.image_native import load as load_image_decoder

            load_image_decoder()
        else:
            if data_x.shape[-1] != channels:
                raise ValueError(
                    f"backbone {config.backbone!r} expects {channels}-channel input but "
                    f"data_set {config.data_set!r} has {data_x.shape[-1]} channels"
                )
            if data_x.shape[1] != config.input_size:
                raise ValueError(
                    f"data_set {config.data_set!r} images are {data_x.shape[1]}px "
                    f"but --input_size is {config.input_size}: pass --input_size "
                    f"{data_x.shape[1]}"
                )
        self.aug_cfg = AugmentConfig.from_config(config)
        if channels == 1 and self.aug_cfg.rand_augment:
            # RandAugment's colour and histogram ops are defined on RGB; crop,
            # jitter and erasing take one channel.
            raise ValueError(
                f"backbone {config.backbone!r} is 1-channel; RandAugment requires "
                "RGB: pass --aa none"
            )
        self.policy = policy_from_config(config)
        # batch_size is per process, as the reference's per-GPU batch.
        self.global_batch_size = config.batch_size * self.axis.size

        # JAX's initial network for this seed; each task's head grows from
        # fold_in(grow_key, task) (``_grow_state``).
        _, self._grow_key = trainer_keys(config.seed)
        model = create_model(
            config.backbone, self.nb_classes, seed=config.seed,
            bn_group_size=config.bn_group_size, axis=self.axis, policy=self.policy,
            width_multiple=self.mesh.model.size, model_axis=self.mesh.model,
        ).to(self.device)
        if self.mesh.size > 1:
            # The backbone only: each rank keeps its own head shard.
            broadcast_module(model.backbone, dist.group.WORLD)
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
            prefer_native=self._native_everywhere(),
        )
        step_hp = dict(
            label_smoothing=config.smooth,
            kd_temperature=config.kd_temperature,
            momentum=config.momentum,
            weight_decay=config.weight_decay,
            use_pallas_loss=config.use_pallas_loss,
            axis=self.axis,
        )
        self.train_step = make_train_step(self.aug_cfg, self.policy, **step_hp)
        self.epoch_fn = make_epoch_fn(self.aug_cfg, self.policy, device=self.device,
                                      processes=self.mesh.size, **step_hp)
        # lr and λ as 0-d device tensors, as JAX traces them: a captured
        # step reads their values at each replay.
        self._lr = torch.zeros((), device=self.device)
        self._lam = torch.zeros((), device=self.device)
        # The next task's dataset, armed by the herding phase on the warm
        # ring (--prefetch_depth > 0 on the fused path); see _warm_next_task.
        self._task_warm = None
        self.eval_step = make_eval_step(self.aug_cfg)
        self.feature_step = make_feature_step(
            self.aug_cfg, augmented=config.herding_augmented
        )
        self.global_step = 0
        # Programs are the fused epoch's captured graphs; they are due at a
        # task's first executed epoch.  The budget is made before the
        # resume below, so that a restore grants one.
        self.telemetry.recompiles.track("epoch_fn", self.epoch_fn, group="train")
        self.recompile_sentinel = None
        if config.recompile_budget:
            from analysis.runtime import RecompileSentinel

            self.recompile_sentinel = RecompileSentinel(
                self.telemetry.recompiles, group="train", per_event=1, sink=self.jsonl)
        self.jsonl.log(
            "run",
            data_set=config.data_set,
            backbone=config.backbone,
            num_bases=config.num_bases,
            increment=config.increment,
            batch_size=config.batch_size,
            global_batch=self.global_batch_size,
            bn_group_size=config.bn_group_size,
            num_epochs=config.num_epochs,
            lr=config.lr,
            seed=config.seed,
            aa=config.aa,
            memory_size=config.memory_size,
            compute_dtype=config.compute_dtype,
            precision=self.policy.name,
            backend=f"torch-{self.device.type}",
            device_name=(torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "cpu"),
            torch_version=torch.__version__,
            use_pallas_loss=config.use_pallas_loss,
            mesh=self.mesh.shape,
            processes=self.mesh.size,
        )
        self.acc1s: List[float] = []
        self.matrix = AccuracyMatrix()
        self.known = 0
        self.start_task = 0
        self.start_epoch = 0  # > 0 only after an epoch-checkpoint restore
        self.resumed_from = None  # {"path", "kind": "task"|"epoch"} once resumed
        if config.resume and config.ckpt_dir:
            from ..utils.checkpoint import load_task_checkpoint

            load_task_checkpoint(self)
        if config.resume:
            # Segment marker: records after it replace those of the tasks
            # (and epochs) at or past the resume point.
            extra = {}
            if self.resumed_from is not None:
                extra = {"path": self.resumed_from["path"],
                         "kind": self.resumed_from["kind"]}
            self.jsonl.log("resume", start_task=self.start_task,
                           start_epoch=self.start_epoch, **extra)

    def _fault_injector(self):
        """The ``--fault_spec`` injector, or None.  Its ledger defaults to
        ``<ckpt_dir>/fault_ledger.jsonl``: a relaunch with the same spec
        finds the clause spent.  A fresh run archives an old ledger first
        (rank 0, before every rank reads it), so its spec fires again."""
        cfg = self.config
        if not cfg.fault_spec:
            return None
        from faults import injector_from, rotate_ledger

        ledger = cfg.fault_state
        if ledger is None and cfg.ckpt_dir:
            ledger = os.path.join(cfg.ckpt_dir, "fault_ledger.jsonl")
        if not cfg.resume and self.mesh.rank == 0:
            archived = rotate_ledger(ledger)
            if archived:
                self.jsonl.log("fault_ledger_rotated", path=ledger, archived=archived)
        barrier()
        flight = self.telemetry.flight
        return injector_from(cfg.fault_spec, ledger_path=ledger, sink=self.jsonl,
                             on_fatal=flight.fatal_dump if flight is not None else None)

    def _lockstep_sentinel(self):
        """The ``--check_lockstep`` sentinel, or None.  Its exchange
        directory defaults under the telemetry dir, then the checkpoint
        dir; each rank clears its own subdirectory at construction, so every
        rank waits for the others before the first check."""
        cfg = self.config
        if not cfg.check_lockstep:
            return None
        from analysis.lockstep import LockstepSentinel

        lockstep_dir = cfg.lockstep_dir
        if lockstep_dir is None and cfg.telemetry_dir:
            lockstep_dir = os.path.join(cfg.telemetry_dir, "lockstep")
        if lockstep_dir is None and cfg.ckpt_dir:
            lockstep_dir = os.path.join(cfg.ckpt_dir, "lockstep")
        flight = self.telemetry.flight
        sentinel = LockstepSentinel(
            lockstep_dir, process_index=self.mesh.rank, process_count=self.mesh.size,
            sink=self.jsonl, on_fatal=flight.fatal_dump if flight is not None else None,
            deadline_s=cfg.lockstep_deadline_s)
        barrier()
        return sentinel

    def _native_everywhere(self) -> bool:
        """Load (building if needed) the native herding library, at startup;
        True only if every rank of the world has it (an all-reduce MIN), so
        replicated memories never differ between ranks with and without it."""
        from ..utils.native import native_available

        have = native_available()
        if self.mesh.size > 1:
            flag = torch.tensor([int(have)], dtype=torch.int32, device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            have = bool(flag.item())
        return have

    def _decode(self, x: np.ndarray, train: bool, seed: int) -> np.ndarray:
        """A host batch's pixels: uint8 passes, paths decode."""
        return maybe_decode(x, self.config.input_size, train, seed)

    @staticmethod
    def _data_digest(x: np.ndarray, y: np.ndarray) -> str:
        """The lockstep digest of host data; a path array by its paths."""
        from analysis.lockstep import data_digest

        return data_digest(path_digest_bytes(x) if is_path_array(x) else x, y)

    def _count(self, n: int) -> torch.Tensor:
        return torch.tensor([n], dtype=torch.int32, device=self.device)

    def _card_mark(self, clock: Optional[StallClock]):
        """At ``--prefetch_depth 0`` on CUDA: ``clock``, the host time and an
        event recorded on the stream behind the queued steps, as a batch's
        production begins (:meth:`_to_device` reads them); else None."""
        if clock is None or self.config.prefetch_depth > 0 or self.device.type != "cuda":
            return None
        began = torch.cuda.Event(enable_timing=True)
        began.record(torch.cuda.current_stream(self.device))
        return clock, time.perf_counter(), began

    def _to_device(self, *arrays: np.ndarray, mark=None):
        """The host-to-device copy of a batch; through pinned memory,
        without blocking the host, when a prefetcher's producer makes it.
        At ``--prefetch_depth 0`` on CUDA the copy is pageable and blocking:
        it waits for the steps already queued on the card.  Given the
        ``mark`` of :meth:`_card_mark` taken as the batch's production
        began, only the card's idle time is charged to the clock's host
        bucket: the production the card's queued work overlapped (until
        the stream reached the mark's event) and the wait before the copy
        (the stream synchronized first) go to the device bucket.  The batch
        and the wall time are the same either way."""
        if mark is not None:
            clock, t0, began = mark
            stream = torch.cuda.current_stream(self.device)
            overlapped = time.perf_counter() - t0
            if began.query():  # the card ran dry during the production
                now = torch.cuda.Event(enable_timing=True)
                now.record(stream)
                now.synchronize()
                overlapped = max(0.0, overlapped - began.elapsed_time(now) / 1e3)
            clock.add_device(overlapped)
            with clock.device():
                stream.synchronize()
        return to_device(self.device, *arrays, pinned=self.config.prefetch_depth > 0)

    # ------------------------------------------------------------------ #
    # The experiment
    # ------------------------------------------------------------------ #

    def fit(self) -> Dict:
        """Run every task under the root ``fit`` span, with the heartbeat
        thread live; returns the headline results."""
        tel = self.telemetry
        tel.heartbeat.start()
        try:
            with tel.span("fit"):
                return self._fit_tasks()
        finally:
            # A warm ring armed for a task that never ran (the last task, a
            # crash) must still release its thread and device buffers.
            if self._task_warm is not None:
                self._task_warm["prefetcher"].close()
                self._task_warm = None
            tel.close()

    def _fit_tasks(self) -> Dict:
        tel = self.telemetry
        increments = self.scenario_train.increments()
        for task_id, task_train in enumerate(self.scenario_train):
            if task_id < self.start_task:
                continue  # restored past this task
            nb_new = increments[task_id]
            dataset_val = self.scenario_val[: task_id + 1]
            with tel.span("task", task=task_id):
                tel.heartbeat.update(force=True, task=task_id, phase="train")
                if task_id > 0:
                    with tel.span("rehearsal_inject", task=task_id):
                        task_train.add_samples(*self.memory.get())
                # Mid-task resume: the restored model has this task's head
                # already; growing it again would re-draw the new columns.
                resume_epoch = self.start_epoch if task_id == self.start_task else 0
                if resume_epoch == 0:
                    with tel.span("head_grow", task=task_id):
                        self._grow_state(task_id, self.known, nb_new)
                t0 = time.time()
                self._fit_task(task_id, task_train, dataset_val, nb_new, resume_epoch)
                if self.recompile_sentinel is not None:
                    # Every capture this task may make has been made.
                    self.recompile_sentinel.check(where=f"task{task_id}", task_id=task_id)

                gamma = None
                if task_id > 0:
                    with tel.span("align", task=task_id):
                        gamma = align(self.state.model, self.known, nb_new)
                    print(f"old norm / new norm ={gamma}")
                # One accuracy-matrix row: each seen task's val slice
                # evaluated separately; the exact weighted totals sum to the
                # cumulative ones.  One all-reduce and one device->host fetch
                # for the row.
                tel.heartbeat.update(force=True, task=task_id, phase="eval")
                with tel.span("eval_matrix", task=task_id):
                    slice_totals = self._sum_over_ranks(torch.stack([
                        self._eval_totals_device(self.scenario_val[j])
                        for j in range(task_id + 1)
                    ])).cpu().numpy()
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
                # The serving artifact: the just-aligned model, frozen before
                # the teacher snapshot (serving/artifact.py).  Every rank
                # calls it: the head's gather and the barrier are collective.
                if self.config.export_dir:
                    with tel.span("export_artifact", task=task_id):
                        self._export_artifact(task_id, nb_new, acc_per_task)
                # Teacher snapshot: a deep copy, so the student's in-place
                # SGD updates never reach it.
                with tel.span("teacher_snapshot", task=task_id):
                    teacher_model = copy.deepcopy(self.state.model).requires_grad_(False)
                    self.teacher = Teacher(model=teacher_model,
                                           known=self._count(self.known + nb_new))
                tel.heartbeat.update(force=True, task=task_id, phase="herd")
                with tel.span("herd", task=task_id):
                    self._update_memory(task_id, task_train)
                # The memory is final for the next task: start its dataset's
                # copy to the device, overlapping the checkpoint and the next
                # task's setup.
                self._warm_next_task(task_id)
                self.known += nb_new
                with tel.span("checkpoint", task=task_id):
                    self._save_checkpoint(task_id)
                # The card's memory at the task boundary: the grown head,
                # the resident dataset, the teacher and the graph all moved.
                tel.log_hbm(task_id=task_id)
        avg_inc = float(np.mean(self.acc1s)) if self.acc1s else 0.0
        print(f"avg incremental top-1 = {avg_inc:.3f}")
        summary = self.matrix.summary() if self.matrix.rows else {}
        self.jsonl.log(
            "final", acc1s=list(self.acc1s), avg_incremental_acc1=avg_inc, **summary
        )
        barrier()
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
        grow(self.state.model, jax_random.fold_in(self._grow_key, task_id), known, nb_new)
        self.state.momentum = sgd_init(self.state.model.parameters())
        self.state.num_active = self._count(known + nb_new)
        self.state.known = self._count(known)
        if self.recompile_sentinel is not None:
            self.recompile_sentinel.note_event("task_growth", task_id=task_id)

    def _lambda_kd(self, task_id: int) -> float:
        """λ for the KD term; with ``dynamic_lambda_kd``, n/(n+m)."""
        cfg = self.config
        if not cfg.dynamic_lambda_kd or task_id == 0:
            return cfg.lambda_kd
        incs = self.scenario_train.increments()
        n = sum(incs[:task_id])
        m = incs[task_id]
        return n / (n + m)

    def _save_checkpoint(self, task_id: int) -> None:
        if not self.config.ckpt_dir:
            return
        from ..utils.checkpoint import save_task_checkpoint

        try:
            save_task_checkpoint(self, task_id)
        except OSError as e:
            # A transient failure costs this boundary's durability, not the
            # run: a resume falls back to the newest checkpoint that landed.
            print(f"| task checkpoint save failed: {e!r}")
            self.jsonl.log("ckpt_save_error", error=repr(e), task_id=task_id)

    def _export_artifact(self, task_id: int, nb_new: int, acc_per_task) -> None:
        """Freeze the post-alignment model as a serving artifact (rank 0
        writes; a ``serve_export`` record).  As with checkpoint saves, a
        failed export costs this task's artifact, never the run.  With
        ``--serve_skew_check`` the artifact is reloaded and each seen task's
        validation slice re-scored through it (``serve_skew``).  The export
        works on a model of its own, so no tensor the captured train step
        reads is rebound."""
        from ..serving import export_from_trainer, load_artifact, measure_skew

        known = self.known + nb_new
        t0 = time.time()
        try:
            path = export_from_trainer(self, task_id, known_after=known,
                                       acc_per_task=acc_per_task)
        except OSError as e:
            print(f"| serving artifact export failed: {e!r}")
            self.jsonl.log("serve_export", task_id=task_id, error=repr(e))
            return
        if path is None:
            return  # another rank wrote it
        self.jsonl.log("serve_export", task_id=task_id, path=path, known=known,
                       buckets=list(self.config.serve_buckets),
                       seconds=round(time.time() - t0, 2))
        if self.config.serve_skew_check:
            try:
                artifact = load_artifact(path, self.device)
                measure_skew(artifact, self.scenario_val, sink=self.jsonl,
                             train_acc_per_task=acc_per_task)
            except OSError as e:
                # The skew check observes; a reload failure is itself the
                # signal worth logging.
                print(f"| serve skew check failed: {e!r}")
                self.jsonl.log("serve_export", task_id=task_id, error=repr(e))

    def _save_epoch_checkpoint(self, task_id: int, epoch: int, nb_new: int) -> None:
        cfg = self.config
        if not (cfg.ckpt_dir and cfg.epoch_ckpt_every > 0
                and epoch % cfg.epoch_ckpt_every == 0):
            return
        from ..utils.checkpoint import save_epoch_checkpoint

        try:
            with self.telemetry.span("epoch_checkpoint", task=task_id, epoch=epoch):
                save_epoch_checkpoint(self, task_id, epoch, nb_new)
        except OSError as e:
            print(f"| epoch checkpoint save failed: {e!r}")
            self.jsonl.log("ckpt_save_error", error=repr(e), task_id=task_id, epoch=epoch)

    def _fit_task(self, task_id: int, task_train, dataset_val, nb_new: int,
                  start_epoch: int = 0) -> None:
        cfg = self.config
        tel = self.telemetry
        # The fused epoch needs the pixels in memory as uint8.
        fused = cfg.fused_epochs and task_train.x.dtype == np.uint8
        task_digest = None
        if fused:
            # The last task's captured step read tensors that this task
            # rebinds: the grown head and fresh momentum, the teacher, and
            # the dataset and generator below.
            self.epoch_fn.reset()
            # The task's dataset lives on the device for the whole task: from
            # the warm ring on a verified hit, else by a synchronous copy.
            resident = self._consume_task_warm(task_id, task_train)
            if resident is None:
                resident = to_device(self.device, task_train.x, task_train.y)
            # One digest a task, of the host arrays the resident copy came
            # from: the finest grain the host sees on this path.
            if self.lockstep is not None:
                task_digest = self._data_digest(task_train.x, task_train.y)
        self._lam.fill_(self._lambda_kd(task_id))
        # One generator a task (a captured step binds it), reseeded each
        # epoch: the draws are a pure function of (seed, task, epoch).
        gen = torch.Generator(device=self.device)
        for epoch in range(start_epoch, cfg.num_epochs):
            # A task's first executed epoch holds its capture (and any
            # build): it is priced in a compile_event and, with
            # --profile_dir, traced, the capture included.
            first = epoch == start_epoch
            watch_before = self._compile_watch.snapshot() if first else None
            profile_here = cfg.profile_dir if first else None
            trace_name = f"task{task_id}_epoch{epoch}"
            t_epoch = time.perf_counter()
            lr = cosine_lr(cfg.lr, epoch, cfg.num_epochs)
            self._lr.fill_(lr)
            gen.manual_seed(derive_seed(cfg.seed, _AUG_STREAM, task_id, epoch))
            clock = StallClock()
            with tel.span("epoch", task=task_id, epoch=epoch + 1), \
                    task_trace(profile_here, trace_name) as trace_path:
                if fused:
                    pending = self._run_epoch_fused(task_id, len(task_train), resident, epoch,
                                                    gen, clock, task_digest)
                    # The fused epoch has no per-step fire site: settle the
                    # step-level clauses now that the step count is known,
                    # before the epoch-checkpoint hook, so a reconciled kill
                    # at step S resumes from the previous epoch's checkpoint,
                    # as a kill inside the epoch would.
                    if self.faults is not None:
                        self.faults.reconcile_steps("engine.step", task=task_id,
                                                    epoch=epoch + 1, steps=len(pending))
                else:
                    pending = self._run_epoch_steps(task_id, task_train, epoch, gen, clock)
                if trace_path and self.device.type == "cuda":
                    # The last steps' kernels land inside the trace window.
                    torch.cuda.synchronize(self.device)
            if trace_path:
                print(f"profiler trace captured under {trace_path}")
                self.jsonl.log("profile_trace", task_id=task_id, name=trace_name,
                               path=trace_path)
            logger = MetricLogger(delimiter="  ")
            for m in pending:
                logger.update(**m)
            print(f"train states: epoch :[{epoch + 1}/{cfg.num_epochs}] {logger}")
            # The first executed epoch captures the task's graph; a capture
            # at any later epoch is a rebinding leak and warns.
            tel.recompiles.check(where=f"task{task_id}/epoch{epoch + 1}", expected=first,
                                 group="train", task_id=task_id, epoch=epoch + 1)
            if watch_before is not None:
                self.jsonl.log(
                    "compile_event",
                    task_id=task_id,
                    epoch=epoch + 1,
                    resumed=bool(self.resumed_from is not None
                                 and task_id == self.start_task),
                    **CompileWatch.delta(watch_before, self._compile_watch.snapshot()),
                )
            clock_snap = clock.snapshot()
            self.jsonl.log(
                "epoch",
                task_id=task_id,
                epoch=epoch + 1,
                lr=lr,
                epoch_s=round(time.perf_counter() - t_epoch, 2),
                steps=len(pending),
                **clock_snap,
                fused=fused,
                graphed=fused and self.epoch_fn.graphed,
                **{k: m.global_avg for k, m in logger.meters.items()},
            )
            self._m_epochs.inc()
            self._m_stall.set(clock_snap.get("stall_frac", 0.0))
            self._m_recompiles.set(tel.recompiles.total())
            tel.heartbeat.update(force=True, task=task_id, epoch=epoch + 1)
            self._save_epoch_checkpoint(task_id, epoch + 1, nb_new)
            # After the checkpoint hook: kill@taskT.epochE leaves epoch E's
            # checkpoint on disk, and the relaunch resumes right there.
            if self.faults is not None:
                self.faults.fire("engine.epoch", task=task_id, epoch=epoch + 1)
            # The reference's cadence: with num_epochs a multiple of
            # eval_every_epoch this also evaluates at the last epoch, before
            # alignment, besides the post-alignment eval in fit().
            if (epoch + 1) % cfg.eval_every_epoch == 0:
                self.evaluate(dataset_val)

    def _shuffle_seed(self, task_id: int, epoch: int) -> int:
        """The epoch's shuffle, the same on every rank and on both paths."""
        return hash((self.config.seed, task_id, epoch)) & 0x7FFFFFFF

    def _run_epoch_fused(self, task_id, n, resident, epoch, gen, clock,
                         task_digest: Optional[str] = None) -> List[Dict]:
        """The epoch through the fused epoch function on the resident
        dataset; the table goes to the device once and the metrics come back
        in one fetch."""
        data_x, data_y = resident
        with clock.host():
            table = epoch_index_table(n, self.global_batch_size,
                                      self._shuffle_seed(task_id, epoch))
            table = to_device(self.device, table)[0]
        if self.lockstep is not None:
            self.lockstep.check(
                "train_epoch_fused",
                program="epoch_fn_kd" if self.teacher is not None else "epoch_fn",
                args=(data_x, data_y, table), digest=task_digest, rng=(task_id, epoch),
                step=self.global_step + 1, task=task_id, epoch=epoch + 1,
            )
        with clock.device():
            rows = self.epoch_fn(self.state, self.teacher, data_x, data_y, table, gen,
                                 self._lr, self._lam)
            host = rows.cpu().numpy()  # waits for the epoch's steps
        steps = len(host)
        self.global_step += steps
        # One observation an epoch: the host's wall a step (its replays and
        # its one fetch over its steps); the per-step times never reach it.
        avg_step_ms = clock.device_s / max(steps, 1) * 1e3
        self._m_steps.inc(steps)
        self._m_step_ms.observe(avg_step_ms)
        self.telemetry.heartbeat.update(step=self.global_step,
                                        last_step_ms=round(avg_step_ms, 2))
        return [dict(zip(METRICS, row)) for row in host]

    def _run_epoch_steps(self, task_id, task_train, epoch, gen, clock) -> List[Dict]:
        """One train step per host batch; the step metrics stay on the
        device and come back in one fetch at the end of the epoch.  At
        ``--prefetch_depth > 0`` the batches are made and copied on the
        prefetcher's thread and ``clock`` gets only the time the loop waits
        for them."""
        rows = []
        hb = self.telemetry.heartbeat
        seed = self._shuffle_seed(task_id, epoch)
        table = None
        if self.lockstep is not None:
            # The digest is of the global batch, which every rank holds on
            # the host and takes its stripe of: the ranks' digests agree
            # exactly when their pipelines do.  (A rank's own stripe differs
            # from its peers' by design, so JAX's digest of it, JAX
            # engine/loop.py:930, cannot match across processes.)
            table = epoch_index_table(len(task_train), self.global_batch_size, seed)

        def placed(item):
            step_idx, (xb, yb) = item
            mark = self._card_mark(clock)
            # data.produce: slow_batch stalls, producer_die raises here (on
            # the producer thread at depth > 0, which then degrades).
            if self.faults is not None:
                self.faults.fire("data.produce", task=task_id, epoch=epoch + 1,
                                 step=step_idx + 1)
            digest = None
            if table is not None:  # on the producer thread at depth > 0
                idx = table[step_idx]
                digest = self._data_digest(task_train.x[idx], task_train.y[idx])
            xb = self._decode(xb, train=True, seed=seed + step_idx)
            return (*self._to_device(xb, yb, mark=mark), digest)

        source = enumerate(train_batches(task_train, self.global_batch_size, seed,
                                         self.axis.rank, self.axis.size))
        with self._prefetcher(source, placed, clock, "train", task_id=task_id,
                              epoch=epoch + 1) as batches:
            for x, y, digest in batches:
                t_step = time.perf_counter()
                if self.lockstep is not None:
                    # Before the dispatch: a mismatch surfaces while every
                    # rank is still outside the step's collectives.
                    self.lockstep.check(
                        "train_step",
                        program="train_step_kd" if self.teacher is not None else "train_step",
                        args=(x, y), digest=digest, rng=(task_id, epoch, len(rows)),
                        step=self.global_step + 1, task=task_id, epoch=epoch + 1,
                    )
                with clock.device():
                    metrics = self.train_step(self.state, self.teacher, x, y, gen,
                                              self._lr, self._lam)
                rows.append(torch.stack([metrics[k] for k in METRICS]))
                self.global_step += 1
                step_ms = (time.perf_counter() - t_step) * 1e3
                self._m_steps.inc()
                self._m_step_ms.observe(step_ms)
                hb.update(step=self.global_step, task=task_id, epoch=epoch + 1,
                          last_step_ms=round(step_ms, 2))
                # After the step's dispatch: a kill at step S keeps steps < S.
                if self.faults is not None:
                    self.faults.fire("engine.step", task=task_id, epoch=epoch + 1,
                                     step=len(rows))
        with clock.device():
            host = torch.stack(rows).cpu().numpy()  # waits for the epoch's steps
        return [dict(zip(METRICS, row)) for row in host]

    def _prefetcher(self, source, place, clock, where: str, **coords) -> DevicePrefetcher:
        """A :class:`DevicePrefetcher` at ``--prefetch_depth`` on the
        trainer's device; a producer death logs ``prefetch_degraded``."""
        def degraded(exc):
            self.jsonl.log("prefetch_degraded", where=where, error=repr(exc), **coords)

        return DevicePrefetcher(source, place, self.config.prefetch_depth, clock=clock,
                                name=f"prefetch-{where}", on_degrade=degraded,
                                device=self.device, metrics=self.telemetry.metrics)

    # ------------------------------------------------------------------ #
    # Eval
    # ------------------------------------------------------------------ #

    def _sum_over_ranks(self, totals: torch.Tensor) -> torch.Tensor:
        if self.axis.sharded:
            dist.all_reduce(totals, group=self.axis.group)
        return totals

    def _eval_totals_device(self, dataset_val) -> torch.Tensor:
        """``[loss_sum, correct1, correct5, n]`` over this rank's stripes of
        a val set, on device; :meth:`_sum_over_ranks` adds up the ranks'."""
        totals = None
        source = eval_batches(dataset_val, self.global_batch_size, self.axis.rank,
                              self.axis.size)

        def placed(batch):
            xb, yb, wb = batch
            return self._to_device(self._decode(xb, train=False, seed=0), yb, wb)

        with self._prefetcher(source, placed, None, "eval") as batches:
            for x, y, w in batches:
                if self.lockstep is not None:
                    # Shapes and counts only: a digest would fetch the batch.
                    self.lockstep.check("eval_step", program=f"eval_step@known{self.known}",
                                        args=(x, y, w))
                out = self.eval_step(self.state.model, x, y, w, self.state.num_active)
                totals = out if totals is None else totals + out
        return totals

    def evaluate(self, dataset_val) -> float:
        totals = self._sum_over_ranks(self._eval_totals_device(dataset_val)).cpu().numpy()
        print(_eval_line(totals))
        return float(100.0 * totals[1] / max(totals[3], 1.0))

    # ------------------------------------------------------------------ #
    # Herding pass
    # ------------------------------------------------------------------ #

    def _update_memory(self, task_id: int, task_train) -> None:
        """Features of every sample of the task (plus injected exemplars) in
        an unshuffled pass, then the herding selection on the host.  The
        pass is unsharded and the same on every rank, so the memories are
        identical without communication."""
        gen = make_generator(self.device, self.config.seed, _HERD_STREAM, task_id)
        feats = []
        source = enumerate(sequential_batches(task_train, self.global_batch_size))

        def placed(item):
            i, (xb, _yb) = item
            return self._to_device(self._decode(xb, train=self.config.herding_augmented, seed=i))

        with self._prefetcher(source, placed, None, "herd", task_id=task_id) as batches:
            for (x,) in batches:
                if self.lockstep is not None:
                    self.lockstep.check("feature_step", program="feature_step", args=(x,),
                                        task=task_id)
                feats.append(self.feature_step(self.state.model, x, gen))
        features = torch.cat(feats).cpu().numpy()[: len(task_train)]
        self.memory.add(*task_train.get_raw_samples(), features)

    # ------------------------------------------------------------------ #
    # The next task's dataset on the warm ring
    # ------------------------------------------------------------------ #

    def _warm_next_task(self, task_id: int) -> None:
        """Arm a depth-1 ring with the next task's fused dataset (its slice
        plus the memory just herded), copied on the ring's producer thread
        while the checkpoint is written and the next task is set up.  Only
        on the fused path with ``--prefetch_depth > 0``; the per-step path
        streams its batches through its own ring."""
        cfg = self.config
        nxt = task_id + 1
        if (cfg.prefetch_depth <= 0 or not cfg.fused_epochs or nxt >= len(self.scenario_train)
                or is_path_array(self.scenario_train._x)):
            return  # a path dataset stays on the per-step loop
        warm_train = self.scenario_train[nxt]
        warm_train.add_samples(*self.memory.get())
        stride = max(1, len(warm_train.x) // 8)
        self._task_warm = {
            "task_id": nxt,
            "prefetcher": DevicePrefetcher(
                iter([(warm_train.x, warm_train.y)]), lambda b: self._to_device(*b),
                depth=1, name=f"prefetch-taskwarm-t{nxt}", device=self.device,
                metrics=self.telemetry.metrics),
            "t0": time.perf_counter(),
            "y": warm_train.y,
            "x_probe": warm_train.x[::stride].copy(),
            "probe_stride": stride,
            "nbytes": int(warm_train.x.nbytes + warm_train.y.nbytes),
        }

    def _consume_task_warm(self, task_id: int, task_train):
        """The warmed device dataset if it is ``task_train``'s, else None.
        It must be armed for this task and match its labels exactly and a
        probe of every (N/8)-th row; every outcome logs ``prefetch_warm``,
        and a miss (or any error on the warm path) never ends the run."""
        warm, self._task_warm = self._task_warm, None
        if warm is None:
            return None
        pf = warm["prefetcher"]

        def miss(reason):
            pf.close()
            self.jsonl.log("prefetch_warm", task_id=task_id, hit=False, reason=reason)

        try:
            if warm["task_id"] != task_id:
                return miss(f"armed_for_task{warm['task_id']}")
            stride = warm["probe_stride"]
            if not (np.array_equal(warm["y"], task_train.y)
                    and np.array_equal(warm["x_probe"], task_train.x[::stride])):
                return miss("content_mismatch")
            t_wait = time.perf_counter()
            placed = next(pf, None)
            pf.close()
            if placed is None:
                return miss("ring_empty")
            self.jsonl.log("prefetch_warm", task_id=task_id, hit=True, bytes=warm["nbytes"],
                           wait_s=round(time.perf_counter() - t_wait, 4),
                           warm_s=round(time.perf_counter() - warm["t0"], 4))
            return placed
        except Exception as e:  # noqa: BLE001 - the warm path must not end a run
            return miss(repr(e))
