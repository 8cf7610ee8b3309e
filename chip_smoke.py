#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py                  # every phase, on one card
    python3 chip_smoke.py launch2 <flags>  # the CLI at 2 data-parallel ranks
    python3 chip_smoke.py race <log.jsonl> [--init_state <state.pt>] <flags>
                                           # a race run under deterministic
                                           # cuDNN, timed (optionally from
                                           # given task-0 weights)
    python3 chip_smoke.py durable <out.pt> <flags>
                                           # one CLI run under deterministic
                                           # cuDNN (the durability phase's
                                           # child; results to out.pt)
    python3 chip_smoke.py serve            # the serve phase (7) alone
    python3 chip_smoke.py imagenet [depth ...]
                                           # the image-folder phase alone (with
                                           # the kernels' build and widths),
                                           # once at each --prefetch_depth
                                           # given (default 0)
    python3 chip_smoke.py gaps [reps]      # the main path's task spans: their
                                           # gaps, with the heartbeats and GC
                                           # pauses inside them
    python3 chip_smoke.py serve_child <export_dir> <out.json>
                                           # the serve phase's fresh-process
                                           # reload and server (its child)

Phases, in order; any failure exits non-zero before the result lines:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and Triton versions, the TF32 switches of the f32 preset, and
   ``nvcc --version``; then the build of ``csrc/fused_ce.cu`` for sm_90a into
   ``build/kernels/`` and its ``ptxas`` report (registers and spills of
   each kernel instance).
2. Each kernel against its plain PyTorch version on the card: the CUDA C++
   fused masked-CE forward and backward over the test grid, the train
   step's shape (B=128, W=100, 50 active), a wide head (B=64, W=5000,
   4321 active) that streams its rows, and the widths the model axis,
   MNIST and the image folder bring at their task boundaries' active
   counts (W=10: 5, 10; W=12: 5, 10; W=100: 100; W=102: 50, 60, 100;
   W=1000: 100, 1000), with smoothing 0 / 0.1 and f32 /
   bf16 logits.  f32 must agree to rtol 1e-5 / atol 1e-6 (expf/logf and the
   sum order differ from PyTorch's), bf16 outputs to rtol 1e-2 (one bf16
   ulp), masked-column gradients must be exactly 0, the forward's in-kernel
   ``out`` must equal ``scale · Σ per`` to rtol 1e-6 and be bitwise the same
   over 10 launches.  The Triton kernels of the first design (off every path
   of the port, kept for comparison) are held to the same tolerances.  Then,
   at the train step's shape, both designs in turns (Triton, CUDA, CUDA,
   Triton): each kernel's times, a CE round (forward and backward through
   the ``autograd.Function``) and its kernel count from ``torch.profiler``
   (2 for the CUDA design: a hard check), an empty kernel launched through
   the same C path (the floor), the plain versions, the PyTorch calls that
   compute the same functions, and the card's bound; then each CUDA kernel
   at the new widths' shapes (``WIDTH_SHAPES``) with its plain version, the
   library call and the bound.
   Then augmentation on the card: every RandAugment op (15) at magnitudes
   {0, 4.5, 9, 10}, sign ±1, bilinear and bicubic, on a seeded uint8 batch
   of 128 32x32 images, against the same port function on the CPU: within
   1 LSB, bitwise for the integer ops (equalize, invert, posterize,
   solarize, solarize-add) and the identity warp; colour jitter and random
   erasing (pixel, rand, const) with fixed draws to rtol 1e-6 after
   normalization.  ``train_augment`` at B=128 with the default policy and
   with ``--aa none`` must make no host sync (``set_sync_debug_mode``) and
   no host copy; its kernels a call (profiler), device ms, host µs and wall
   ms are printed.
3. The main path: first JAX's initial networks drawn on the card's host
   (``utils/jax_random.py``, numpy) against the digests of
   ``tests/fixtures/jax_init_digests.json`` (resnet32 at width 100 and
   resnet20mnist, seeds 0 and 5: the initial state, heads 0 and 1), and the
   main path's own initial network against its seed's; then the CLI's
   trainer on the race recipe at full width
   (``synthetic_hard128``, resnet32, 100-wide head, batch 128, B50-inc10, 6
   tasks) with the parser's defaults (RandAugment ``rand-m9-mstd0.5-inc1``
   and the fused epoch: the task's dataset on the card, the batches
   gathered there, each step a replay of a CUDA graph captured once a
   task) cut to 2 epochs a task, with ``--use_pallas_loss``.  Every
   parameter must live on the card, every loss be finite, every epoch
   record say ``fused`` and ``graphed``, 6 graphs be captured, each CUDA
   kernel run once per train step on the card (as the kernels count
   themselves, in device memory, every replay included; the wrappers are
   called twice a task, for the eager first step and the capture; over one
   replayed epoch ``torch.profiler`` must see one forward and one backward
   kernel a step, as many as the kernels counted) and no Triton kernel at
   all, the records come
   in the CLI's order, and the trained model's eval forward on the card
   agree with the same model on the CPU.  The median step (and that of the
   replay-only epochs), the profiled epoch's kernels a step and the card's
   busy share are printed.  The run has ``--telemetry_dir``,
   ``--heartbeat_path`` and ``--recompile_budget`` on: native herding must
   be in use (``csrc/cil_host.cpp`` built or found under ``build/host/``),
   each task must log one ``compile_event`` whose ``compiles`` is its
   capture, one expected ``recompile`` and one ``hbm`` record with memory
   in use, every ``recompile_budget`` must be ok, the spans one level below
   each ``task`` must cover 90% of it (each child's share is printed: the
   fit's breakdown), the heartbeat must be fresh, and ``spans.jsonl``,
   ``trace.json`` and a ``flight_0.json`` dumped at close must exist.
   Then herding: one class of task 0 (its real features) through the
   native and the numpy greedy on this host, at the memory's quota and at
   20: equal selections, and each call's median host time.
   Then the precision presets: for each of f32, bf16_all and
   bf16_selective, 30 train steps at full width (resnet32, 100-wide head,
   B=128, a teacher, RandAugment, the CUDA kernels): the median step ms,
   finite losses, one forward and one backward launch a step, f32 logits,
   parameters, momentum and BN statistics, conv outputs in the preset's
   compute dtype and BatchNorm inputs in its activation dtype; then the main
   path again under ``--precision bf16_selective``, 1 epoch a task.
   Then the fused phase: the main path's recipe under deterministic cuDNN,
   (a) fused and graphed, (b) ``--no_fused_epochs``, (c) ``--no_fused_epochs
   --prefetch_depth 2``, (d) fused with ``--prefetch_depth 1``, (e) fused
   with ``--telemetry_dir``, ``--heartbeat_path``, ``--profile_dir`` (each
   task's first epoch, its capture included, under ``torch.profiler``),
   ``--recompile_budget``, ``--check_threads`` and ``--check_contracts``:
   all five must end bitwise equal (every ``state_dict`` tensor, acc1s, γ,
   the matrix), (a), (d) and (e) capture 6 graphs, (d) logs 5
   ``prefetch_warm`` hits, (e) writes 6 traces and no violation or warning;
   each run's median step, fit wall and captures are printed, and (e)'s
   replayed step and fit beside (a)'s.
4. Data parallel: two ranks started with ``torch.multiprocessing``, on
   ``nccl`` with a card each where there are two cards, else on ``gloo``
   with both ranks on the one card (NCCL refuses two ranks on one device).
   (a) Step parity: resnet32, 100-wide head, 2 x 64 rows (global 128), 3
   steps of task 0 then 3 of task 1 with a teacher, each rank augmenting its
   stripe of the uint8 batch with RandAugment inside the step (the draws
   are the global batch's: a stripe's augmentation must equal the rows of
   the one-process augmentation bit for bit), through the sharded fused
   loss; each step is held against the 1-rank step on the 128-row batch,
   augmented with the same seed, from the same weights (loss rtol 1e-4;
   parameters and buffers
   rtol 1e-3 / atol 1e-4, since cuDNN's backward is not deterministic;
   the momentum, the raw gradient, is reported against a float64 step),
   the ranks must end bitwise equal, and on each rank each kernel must run
   once per step.  Then the sharded loss on a (64, 100,
   50) stripe against its plain version over the 128 rows, its times, and
   its kernel count per round (2 besides the collective's own copies or
   kernels: a hard check).
   (b) Protocol: the race recipe at 2 ranks x 64 rows, 1 epoch a task, 6
   tasks, through the CLI's trainer on the fused epoch, run eagerly (gloo's
   collectives cannot be captured), under ``--check_lockstep``: the record
   sequence, finite losses, γ > 0 after task 0, kernel runs per rank equal
   to the train steps, the same memory on both ranks, native herding on
   both, and every lockstep fingerprint (one a fused epoch, one a val and a
   herding batch) equal across the ranks: no violation.
5. Model axis: the main path's recipe at 1 epoch a task (6 tasks) at mesh
   ``(1, 2)`` (``--mesh_data 1 --mesh_model 2``): two ranks started as in
   phase 4 (gloo with both ranks on card 0 where there is one card), each
   holding 50 of the 100 head rows, with ``--ckpt_backend orbax``, against
   one rank of the same seed, both under deterministic cuDNN: each step's
   loss rtol 1e-4, the concatenated head shards and the backbone rtol 1e-3 /
   atol 1e-4, γ within 1e-5, acc1 within 1e-4 (their deltas and whether all
   are 0 printed), the kernels counting one run a step on each rank, the
   ``run`` record's mesh ``{"data": 1, "model": 2}``; an ``orbax`` task and
   epoch checkpoint saved at ``(1, 2)`` and restored into new trainers
   there bitwise (one ``.distcp`` file a rank), and the pickle payload
   saved at ``(1, 2)`` restored at ``(1, 1)`` to the full state.  The step
   ms (two gloo ranks sharing one card: nothing of NCCL), the payload
   bytes and the save and restore ms are printed.
   Then MNIST, under deterministic cuDNN: ``synthetic_mnist`` on
   resnet20mnist (28 px, 1 channel, ``--aa none``, 2 tasks of 5 classes, 6
   epochs, batch 32) on the fused, graphed epoch and on the per-step loop,
   and ``--data_set mnist`` on IDX files this phase writes from the same
   images: the three bitwise equal, task 0 learned (acc1 above 50);
   resnet32mnist for one task; each run's kernels one run a step (W=10).
   Then the image folder (``--data_set imagenet1000``): the 20 committed
   fixtures (``tests/fixtures/images``) decoded on this host, where there
   is no Pillow, whole and at 224 px (train at seed 0, eval), must give
   the sha256 digests Pillow and the JAX package gave (``digests.json``);
   a 128-image batch's decode is timed, train and eval; then
   ``IMAGENET_ARGV`` on an ImageNet-100 tree of symlinks to them (100
   classes, 26 train and 5 val images each) through the CLI's trainer:
   resnet32 at 224 px, B0 Inc10, the parser's RandAugment and memory, 1
   epoch a task, telemetry on: every epoch per-step, every loss finite,
   each CE kernel one run a step on the card, a memory of paths, 10 task
   records in the CLI's order; per epoch ``host_s`` / ``device_s`` /
   ``stall_frac``, the median step, peak HBM and the phase's wall are
   printed.  At ``--prefetch_depth 0`` the profiled epoch's ``stall_frac``
   must be within 0.10 of the card's idle share under the profiler.
6. Durability: the main path's recipe (``synthetic_hard128``, resnet32,
   100-wide head, batch 128, B50-inc10, 6 tasks, memory 256, RandAugment,
   the CUDA kernels, the fused and graphed epoch) at 2 epochs a task with
   ``--epoch_ckpt_every 1``, in three legs.  (a) Twin: one uninterrupted CLI child.  (b) Chaos: the same
   flags plus ``--fault_spec kill@task2.epoch1`` under
   ``scripts/supervise.py``: the child dies by SIGKILL right after
   ``task_002_epoch_001.ckpt`` lands, the supervisor relaunches it with
   ``--resume``, and the relaunch must resume from that epoch checkpoint
   (task 2, epoch 2) and finish.  Both children run under deterministic
   cuDNN (``cudnn.deterministic``, no ``benchmark``), set by this script's
   ``durable`` launcher, not by a flag of the port.  (b) must equal (a)
   bitwise: acc1s, the accuracy matrix, γ at every alignment and the final
   ``state_dict``; its log must be the twin's plus ``fault_injected`` and
   the relaunch's ``run`` and ``resume``; in the resumed child each CUDA
   kernel must run once per train step it runs.  The chaos leg runs with
   ``--telemetry_dir``: the killed child's ``flight_0.json``, dumped by the
   fault injector's ``on_fatal`` just before the SIGKILL (reason
   ``fatal``, the ``fault_injected`` record in its ring), must reach the
   supervisor's ``crash_report.json``.  (c) Round trip, in this
   process: an epoch checkpoint (task 1, epoch 1: momentum, teacher, memory)
   and a task checkpoint are saved and restored into a new trainer, and
   every state tensor, the memory and the counters must come back bitwise.
   (d) The chaos leg again on ``--ckpt_backend orbax``: it must resume from
   ``task_002_epoch_001.orbax`` and end bitwise equal to (a).
   Each leg's wall time, the payload bytes and the save and restore times
   are printed beside the card.
7. Serving.  (a) The main path's recipe at 1 epoch a task (6 tasks) with
   ``--export_dir --serve_skew_check --serve_buckets 1,8,32,64``, the
   kernels' counts zeroed just before the fit and read just after (one run
   a step each): 6 ``serve_export`` and 6 ``serve_skew`` records (each
   task's ``skew_abs_max`` printed; a nonzero one is a finding, not a
   failure), the train group's ``recompile`` records as without export.
   (b) In a fresh process (``serve_child``): every artifact reloaded on
   the card, its probe replayed bitwise; per bucket the replayed graph's
   device ms (CUDA events) against the loaded module run eagerly, the
   host ms of ``predict_padded``, the capture ms and the program's bytes;
   each artifact's load ms and bytes; its served logits of every seen
   validation slice against the trainer's eval of the same weights (batch
   128, the trainer's cuDNN settings): max |dlogit| and argmax
   disagreements.  (c) In that process, one ``InferenceServer`` over a
   staging directory with task 0 and ``swap_ioerror@task1`` armed: 8
   closed-loop workers for 6 s, task 1 published 2 s in, then 100 req/s
   open loop for 5 s, ``max_wait_ms`` 5: exactly one
   ``serve_swap_failed`` before the swap to task 1, no failed request,
   responses switching from task 0 to 1, ``trace_count() == 0``; p50 /
   p95 / p99, throughput and bucket occupancy of each loop printed.
   (d) Two replica subprocesses on card 0 under ``scripts/supervise.py``
   behind the port's ``Frontend`` (``replica_die@task0`` on replica 0,
   ``swap_ioerror@task1`` on replica 1), 4 clients: replica 0 dies at its
   first request, is ejected, relaunched and readmitted; task 1 is then
   published and the rollout refuses once on replica 1 and converges: no
   failed client request, the breaker's eject and readmit, one
   ``serve_rollback``, both replicas on task 1 with ``trace_count`` 0;
   every process the phase started is stopped.
8. A ``{"ce_round": ...}`` line, an ``{"augment": ..., "precision": ...}``
   line, a ``{"durability": ...}`` line, a ``{"fused": ..., "main_path":
   ..., "herding": ...}`` line, a ``{"model_axis": ..., "mnist": ...}``
   line, a ``{"serve": ...}`` line, an ``{"imagenet": ...}`` line, the
   card's name and power limit, a
   ``{"kernels": [...]}`` line, then the card line ``{"ok": true,
   "device": {...}}`` last.

Times: ``ms`` is the device-side spacing between back-to-back calls queued
behind a sleep kernel, each bracketed by CUDA events (the event records
included; not the host's cost); ``device_ms`` the kernels' own time from
``torch.profiler`` over 100 calls (null where the profiler shows none);
``host_us`` the host clock over 100 calls queued behind a sleep kernel,
divided by 100: what one call costs the host to enqueue.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet rates at the 700 W limit: HBM bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

MAIN_SHAPE = (128, 100, 50)  # the train step's (B, W, active) on task 0
GRID = [(32, 100, 60), (64, 128, 128), (16, 7, 5), (13, 100, 60), (320, 100, 60),
        (384, 100, 60), MAIN_SHAPE, (64, 5000, 4321)]
# The widths the model axis, MNIST and the image folder bring, at their task
# boundaries' active counts: W=10 (MNIST, 5 + 5 classes; a 40-byte row), W=12
# (10 classes at --mesh_model 4), W=102 (100 classes at --mesh_model 3), W=100
# full, and W=1000 (the imagenet1000 head: its first task of 100, and all).
NEW_WIDTHS = [(128, 10, 5), (128, 10, 10), (128, 12, 5), (128, 12, 10), (128, 100, 100),
              (128, 102, 50), (128, 102, 60), (128, 102, 100), (128, 1000, 100),
              (128, 1000, 1000)]
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
CUDA_SOURCE = f"{PORT}/csrc/fused_ce.cu"
TRITON_SOURCE = f"{PORT}/ops/triton_fused_loss.py"
SHARDED_SOURCE = f"{PORT}/ops/fused_loss.py"
JAX_KERNELS = "a_pytorch_tutorial_to_class_incremental_learning_tpu/ops/fused_loss.py"

DP_RANKS = 2
DP_STRIPE = (64, 100, 50)  # one rank's (B, W, active) in the data-parallel step
DP_STEPS = 6               # 3 of task 0, then 3 of task 1 with a teacher
DP_HP = dict(lr=0.1, lambda_kd=0.5, label_smoothing=0.0, kd_temperature=2.0,
             momentum=0.9, weight_decay=5e-4)
# The race recipe with the parser's default augmentation (RandAugment
# rand-m9-mstd0.5-inc1, bilinear) through the CUDA kernels.
RACE_ARGV = ["--data_set", "synthetic_hard128", "--backbone", "resnet32",
             "--num_bases", "50", "--increment", "10", "--memory_size", "256",
             "--use_pallas_loss"]
# The durability phase: the main path's recipe with epoch checkpoints.
DURABLE_ARGV = [*RACE_ARGV, "--batch_size", "128", "--num_epochs", "2",
                "--epoch_ckpt_every", "1"]
DURABLE_KILL = "kill@task2.epoch1"
# The model-axis phase: the main path's recipe at one epoch a task.
MA_ARGV = [*RACE_ARGV, "--batch_size", "128", "--num_epochs", "1"]
# The MNIST phase: synthetic_mnist on resnet20mnist, 2 tasks (5 + 5 classes),
# crop without flip (RandAugment takes RGB), the CUDA kernels at W=10; batch
# 32 and 6 epochs, so that a task of 320 images takes 60 steps and learns.
MNIST_ARGV = ["--data_set", "synthetic_mnist", "--backbone", "resnet20mnist",
              "--input_size", "28", "--aa", "none", "--num_bases", "5", "--increment", "5",
              "--batch_size", "32", "--num_epochs", "6", "--memory_size", "50",
              "--use_pallas_loss"]
MNIST_LEARNED = 50.0       # task 0's acc1 after its epochs (5 classes: chance is 20)
# The imagenet phase: BASELINE.json config #4's protocol (WA, ImageNet-100,
# B0 Inc10) on an image-folder tree of symlinks to the committed fixtures:
# 100 class folders of 26 train and 5 val images (cut images a class first,
# never the input size or the width), resnet32 at 224 px with the parser's
# default augmentation and memory, 1 epoch a task, telemetry on.
IMAGENET_FIXTURES = "tests/fixtures/images"
IMAGENET_CLASSES = 100
IMAGENET_TRAIN, IMAGENET_VAL = 26, 5
IMAGENET_ARGV = ["--data_set", "imagenet1000", "--input_size", "224", "--num_bases", "0",
                 "--increment", "10", "--backbone", "resnet32", "--batch_size", "128",
                 "--use_pallas_loss", "--num_epochs", "1"]
DECODE_REPS = 5            # timed decodes of a 128-image batch, each mode
# The race gate's reference log (PERF.md §2), and the train CE at or above
# which a task-0 epoch counts as on the plateau of the uniform prediction
# (ln 50 = 3.912).
RACE_REFERENCE = "experiments/b50_inc10_synthetic_hard128_aa35_mem256.jsonl"
PLATEAU_CE = 3.85
DURABLE_LEG_S = 420        # a leg's time limit
AUG_SEED = 100             # parity step i augments with a generator seeded AUG_SEED + i
AUG_B = 128                # the augment phase's batch (the train step's)
INTEGER_OPS = (1, 2, 4, 5, 6)  # Equalize, Invert, Posterize, Solarize, SolarizeAdd
PRECISION_STEPS = 30
# The fused phase's five runs of the main path's recipe ("{tmp}": the run's
# own directory).
TELEMETRY_FLAGS = ["--telemetry_dir", "{tmp}/tel", "--heartbeat_path", "{tmp}/hb/heartbeat.json",
                   "--profile_dir", "{tmp}/prof", "--recompile_budget", "--check_threads",
                   "--check_contracts"]
FUSED_RUNS = {"fused": [], "per_step": ["--no_fused_epochs"],
              "per_step_prefetch2": ["--no_fused_epochs", "--prefetch_depth", "2"],
              "fused_prefetch1": ["--prefetch_depth", "1"],
              "fused_telemetry": TELEMETRY_FLAGS}
HERD_REPEATS = 20          # timed calls of each herding path
# The serve phase: the main path's recipe at 1 epoch a task, exporting.
SERVE_ARGV = [*RACE_ARGV, "--batch_size", "128", "--num_epochs", "1"]
SERVE_BUCKETS = (1, 8, 32, 64)
SERVE_MAX_WAIT_MS = 5.0    # the batcher's deadline
SERVE_WORKERS = 8          # closed-loop clients (the JAX package's bench.py)
SERVE_CLOSED_S = 6.0       # closed-loop traffic; task 1 is published 2 s in
SERVE_AFTER_SWAP_S = 1.0   # closed-loop traffic kept up after the swap lands
SERVE_OPEN_RPS = 100       # open-loop arrival rate
SERVE_OPEN_S = 5.0
SERVE_TIMED = 50           # replays (or eager runs) a timing
SERVE_CHILD_S = 420        # the reload-and-serve child's time limit
FLEET_FAULTS = ("replica_die@task0", "swap_ioerror@task1")  # replica i's clause
FLEET_CLIENTS = 4
SPAN_COVERAGE = 0.90       # the share of a task span its children must cover
# The SHA-256 of the initial networks (and heads 0 and 1) that the JAX
# trainer draws for a few seeds and backbones: the port draws them on the
# host with numpy (``utils/jax_random.py``), and another host's numpy must
# draw the same bits.  ``tests/test_torch_jax_random.py`` holds the file to
# the port's draws, and those to JAX's, on the CPU.
INIT_DIGESTS = "tests/fixtures/jax_init_digests.json"


CARD = ""  # the card's name and power limit (nvidia-smi), printed beside every time


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def state_digest(tensors) -> str:
    """SHA-256 over ``(name, tensor)`` pairs: each name, dtype, shape and
    bytes (CPU, contiguous)."""
    h = hashlib.sha256()
    for name, t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def init_digests(backbone: str, width: int, increments, seed: int) -> dict:
    """The digests of the model ``create_model`` builds for ``--seed seed``
    (``state``: the backbone, BN and the zero head) and of each head the
    trainer grows in turn from ``fold_in(grow_key, t)`` (``head{t}``: its
    weight rows and bias)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (
        create_model, grow, trainer_keys,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random

    model = create_model(backbone, width, seed=seed)
    out = {"state": state_digest(model.state_dict().items())}
    grow_key, known = trainer_keys(seed)[1], 0
    for t, n in enumerate(increments):
        grow(model, jax_random.fold_in(grow_key, t), known, n)
        out[f"head{t}"] = state_digest([("fc.weight", model.fc.weight[known:known + n]),
                                        ("fc.bias", model.fc.bias[known:known + n])])
        known += n
    return out


def check_init_digests() -> list:
    """Every recipe of ``INIT_DIGESTS`` drawn on this host against the file."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), INIT_DIGESTS)
    recipes = json.load(open(path))["recipes"]
    for r in recipes:
        got = init_digests(r["backbone"], r["width"], r["increments"], r["seed"])
        check(got == r["digests"], f"the initial draws of {r['backbone']} at seed {r['seed']} "
              f"differ on this host: {got} against {r['digests']}")
    return recipes


# --------------------------------------------------------------------------- #
# Phase 1
# --------------------------------------------------------------------------- #


def phase_environment(torch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import cuda_build
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
        use_full_f32,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    import triton

    use_full_f32()
    print(f"[env] {smi}")
    print(f"[env] torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"triton {triton.__version__}  python {sys.version.split()[0]}")
    print(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}  "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "the f32 preset left TF32 on")
    t0 = time.perf_counter()
    try:
        nvcc = cuda_build.find_nvcc()
        lib = cuda_build.build("fused_ce", nvcc=nvcc)
    except (cuda_build.NvccNotFound, cuda_build.BuildError) as exc:
        raise SmokeFailure(str(exc)) from exc
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60,
                             check=True).stdout.strip().splitlines()
    print(f"[env] {nvcc}: {' | '.join(version[-2:])}")
    print(f"[env] {lib.relative_to(os.getcwd()) if lib.is_relative_to(os.getcwd()) else lib} "
          f"ready in {time.perf_counter() - t0:.1f} s (flags: {' '.join(cuda_build.NVCC_FLAGS)})")
    ptxas = _ptxas_summary(cuda_build.report_path("fused_ce").read_text())
    check(bool(ptxas), "the ptxas report names no kernel")
    for name, r in ptxas.items():
        print(f"[ptxas] {name}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    return smi, ptxas


def _ptxas_summary(report: str):
    """{kernel instance: registers, stack frame and spill bytes} from
    ``nvcc -Xptxas -v``, each instance named ``<kernel>[<dtype>,<vector>]``."""
    import re

    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None:
            continue
        kern = re.search(r"fused_ce_(fwd|bwd|empty)_sm90", current)
        if not kern:
            continue
        inst = re.search(r"(F32|BF16)ELi(\d+)E", current)
        name = kern.group(0) + (f"[{inst.group(1).lower()},{inst.group(2)}]" if inst else "")
        r = out.setdefault(name, {"registers": None, "stack": None, "spill_stores": None,
                                  "spill_loads": None})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            r["stack"], r["spill_stores"], r["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = int(m.group(1))
    return out


# --------------------------------------------------------------------------- #
# Phase 2
# --------------------------------------------------------------------------- #


def _inputs(torch, b, w, active, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, w, generator=g, device="cuda") * 3
    x[:, active:] = -1e9
    y = torch.randint(0, active, (b,), generator=g, device="cuda")
    na = torch.tensor([active], dtype=torch.int32, device="cuda")
    return x.to(dtype), y, na


def _triton_design(torch):
    """The first design, called as the port called it before the CUDA
    kernels: the same input checks, then the Triton launch; its
    ``autograd.Function`` launches the forward kernel, takes ``per.mean()``
    in a separate kernel, and launches the backward."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import (
        triton_fused_loss as tfl,
    )

    def fwd(x, y, na, s):
        fl._check(x, y, na)
        return tfl.launch_fwd(x, y, na, s)

    def bwd(x, y, na, lse, g, s):
        fl._check(x, y, na)
        return tfl.launch_bwd(x, y, na, lse, g.float().contiguous(), s)

    class TritonCE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, logits, labels, num_active, smoothing):
            logits = logits.contiguous()
            per, lse = fwd(logits, labels, num_active, smoothing)
            ctx.save_for_backward(logits, labels, num_active, lse)
            ctx.smoothing = smoothing
            return per.mean()

        @staticmethod
        def backward(ctx, grad):
            logits, labels, num_active, lse = ctx.saved_tensors
            return bwd(logits, labels, num_active, lse, grad, ctx.smoothing), None, None, None

    return fwd, bwd, TritonCE.apply


def _agree(torch, got, ref, tol, what) -> float:
    diff = (got.float() - ref.float()).abs().max().item()
    check(torch.allclose(got.float(), ref.float(), **tol),
          f"{what} disagrees with its plain version: max |diff| {diff}")
    return diff


def phase_kernels(torch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import (
        triton_fused_loss as tfl,
    )

    t_fwd, t_bwd, _ = _triton_design(torch)
    err = {"fwd": 0.0, "bwd": 0.0, "triton_fwd": 0.0, "triton_bwd": 0.0}
    for b, w, active in GRID + NEW_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            for s in (0.0, 0.1):
                x, y, na = _inputs(torch, b, w, active, dtype)
                g = torch.tensor(1.0, device="cuda")
                scale = 1.0 / b
                ref_per, ref_lse, ref_out = fl.fused_ce_fwd_plain(x, y, na, s, scale)
                ref_dx = fl.fused_ce_bwd_plain(x, y, na, ref_lse, g, s, scale)
                tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
                       else dict(rtol=1e-2, atol=1e-5))
                case = f"B={b} W={w} active={active} {str(dtype)[6:]} s={s}"
                main = dtype == torch.float32 and (b, w, active) == MAIN_SHAPE

                launches = (fl.FWD_LAUNCHES, fl.BWD_LAUNCHES)
                ran = fl.device_launches()
                per, lse, out = fl.fused_ce_fwd(x, y, na, s, scale)
                torch.cuda.synchronize()
                dx = fl.fused_ce_bwd(x, y, na, lse, g, s, scale)
                torch.cuda.synchronize()
                check((fl.FWD_LAUNCHES, fl.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1),
                      "a CUDA call did not launch its kernel")
                check(fl.device_launches() == (ran[0] + 1, ran[1] + 1),
                      f"a CUDA kernel did not count its run: {ran} -> {fl.device_launches()}")
                diffs = {"fwd": max(_agree(torch, per, ref_per, tol, f"fused_ce_fwd per at {case}"),
                                    _agree(torch, lse, ref_lse, tol, f"fused_ce_fwd lse at {case}"),
                                    _agree(torch, out, ref_out, tol, f"fused_ce_fwd out at {case}")),
                         "bwd": _agree(torch, dx, ref_dx, tol, f"fused_ce_bwd at {case}")}
                check(torch.allclose(out, per.sum() * scale, rtol=1e-6, atol=0.0),
                      f"in-kernel batch sum {out.item()} vs scale * sum(per) "
                      f"{(per.sum() * scale).item()} at {case}")
                outs = [fl.fused_ce_fwd(x, y, na, s, scale)[2] for _ in range(10)]
                check(all(torch.equal(o, out) for o in outs),
                      f"the forward's out is not bitwise the same over 10 launches at {case}: "
                      f"{sorted({o.item() for o in outs})}")
                check(bool(torch.all(dx[:, active:] == 0)),
                      f"masked-column gradient is not exactly 0 at {case}")
                check(bool(torch.isfinite(per).all()), f"non-finite loss at {case}")

                launches = (tfl.FWD_LAUNCHES, tfl.BWD_LAUNCHES)
                tper, tlse = t_fwd(x, y, na, s)
                tdx = t_bwd(x, y, na, tlse, g, s)
                torch.cuda.synchronize()
                check((tfl.FWD_LAUNCHES, tfl.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1),
                      "a Triton call did not launch its kernel")
                diffs["triton_fwd"] = max(_agree(torch, tper, ref_per, tol, f"Triton fwd at {case}"),
                                          _agree(torch, tlse, ref_lse, tol, f"Triton lse at {case}"))
                diffs["triton_bwd"] = _agree(torch, tdx, ref_dx, tol, f"Triton bwd at {case}")
                check(bool(torch.all(tdx[:, active:] == 0)),
                      f"Triton masked-column gradient is not exactly 0 at {case}")
                if main:
                    for k, v in diffs.items():
                        err[k] = max(err[k], v)
        print(f"[kernels] B={b} W={w} active={active}: CUDA and Triton, f32+bf16, s=0/0.1 agree; "
              f"out = scale * sum(per), bitwise the same over 10 launches")
    return err


def _device_ms(torch, fn, n=100, reps=5):
    """Median device-side spacing of one ``fn()`` call in ms: ``n`` calls
    queued behind a sleep kernel so they run back to back on the card, each
    bracketed by CUDA events; the median over ``reps * n`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        torch.cuda._sleep(100_000_000)  # keeps the card busy while the host queues
        events[0].record()
        for i in range(n):
            fn()
            events[i + 1].record()
        torch.cuda.synchronize()
        times += [events[i].elapsed_time(events[i + 1]) for i in range(n)]
    return statistics.median(times)


def _host_us(torch, fn, n=100, reps=5):
    """Median host time of one ``fn()`` call in µs: the host clock over ``n``
    calls queued behind a sleep kernel (so no call waits on the card),
    divided by ``n``; the median of ``reps`` such runs."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def _profile(torch, fn, n=100):
    """Device activity of ``n`` calls of ``fn`` (after one warm-up call) from
    ``torch.profiler``: {kernel or copy name: [count, device µs]}."""
    from torch.profiler import ProfilerActivity, profile

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.profiling import (
        kernel_table,
    )

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return kernel_table(prof)


def _profiled_ms(torch, fn, kernel: str, n=100):
    """The kernel's own device time per launch in ms, from ``torch.profiler``
    over ``n`` launches (its events matched by name); None when the profiler
    records no device time."""
    total_us = sum(us for name, (_, us) in _profile(torch, fn, n).items() if kernel in name)
    if total_us <= 0:
        print(f"[timing] torch.profiler shows no device time for {kernel}; "
              "device_ms left null")
        return None
    return total_us / n / 1e3


def _launches_per_call(prof, n):
    """Kernel launches per call from a ``_profile`` result, with the copies
    (``Memcpy``/``Memset``) and the collective's own device records
    (``gloo:...``, NCCL's kernels) counted apart."""
    kinds = {"kernels": {}, "copies": {}, "collective": {}}
    for name, (count, _) in prof.items():
        kind = ("copies" if name.startswith(("Memcpy", "Memset"))
                else "collective" if name.startswith("gloo:") or "nccl" in name.lower()
                else "kernels")
        kinds[kind][name] = count / n
    return {"launches": sum(kinds["kernels"].values()), **kinds,
            "device_ms": sum(us for _, us in prof.values()) / n / 1e3}


def _host_ms(torch, fn, n=100):
    """Median host time of one synchronized ``fn()`` call in ms (for calls
    that wait on the host, such as a gloo collective)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _bound(t) -> None:
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = t["ops"] / F32_FLOP_PER_S * 1e3
    t["bound_ms"] = max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def _fwd_bytes(b, w, esize=4):
    return b * w * esize + b * 8 + 4 + 2 * b * 4 + 4  # logits, labels, na -> per, lse, out


def _mean(xs):
    return sum(xs) / len(xs)


def phase_timing(torch):
    """Both designs at the train step's shape, in turns (Triton, CUDA, CUDA,
    Triton): per kernel ``ms``, ``device_ms`` and ``host_us``; per CE round
    (value and gradient through the ``autograd.Function``) the same and its
    kernel count; then the empty kernel (the floor), the plain versions and
    the library calls."""
    import torch.nn.functional as F

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import cuda_build
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    b, w, active = MAIN_SHAPE
    scale = 1.0 / b
    x, y, na = _inputs(torch, b, w, active, torch.float32, seed=1)
    xg = x.clone().requires_grad_(True)
    g = torch.tensor(1.0, device="cuda")
    one = torch.ones((), device="cuda")  # the upstream gradient, made once
    lse = fl.fused_ce_fwd(x, y, na, 0.0, scale)[1]
    t_fwd, t_bwd, t_ce = _triton_design(torch)

    def round_of(ce):
        return lambda: torch.autograd.grad(ce(xg, y, na, 0.0), xg, grad_outputs=one)

    calls = {
        "cuda": {"fwd": (lambda: fl.fused_ce_fwd(x, y, na, 0.0, scale), "fused_ce_fwd_sm90"),
                 "bwd": (lambda: fl.fused_ce_bwd(x, y, na, lse, g, 0.0, scale),
                         "fused_ce_bwd_sm90"),
                 "round": (round_of(fl.fused_masked_cross_entropy), None)},
        "triton": {"fwd": (lambda: t_fwd(x, y, na, 0.0), "fwd_kernel"),
                   "bwd": (lambda: t_bwd(x, y, na, lse, g, 0.0), "bwd_kernel"),
                   "round": (round_of(t_ce), None)},
    }
    turns = {d: {op: {"ms": [], "device_ms": [], "host_us": []} for op in calls[d]}
             for d in calls}
    kernels = {}
    for design in ("triton", "cuda", "cuda", "triton"):
        for op, (fn, kernel) in calls[design].items():
            t = turns[design][op]
            t["ms"].append(_device_ms(torch, fn))
            t["host_us"].append(_host_us(torch, fn))
            if kernel is None:  # a round: every kernel it launches
                n = 50
                counted = _launches_per_call(_profile(torch, fn, n), n)
                t["device_ms"].append(counted["device_ms"])
                kernels[design] = counted
            else:
                t["device_ms"].append(_profiled_ms(torch, fn, kernel))
    for design, c in kernels.items():
        print(f"[timing] {design} CE round: {c['launches']:g} kernel launches "
              f"{c['kernels']}, copies {c['copies']}")
    check(kernels["cuda"]["launches"] == 2 and not kernels["cuda"]["copies"],
          f"a CUDA CE round launched {kernels['cuda']} (want the forward and the backward)")

    lib = cuda_build.load("fused_ce")
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    dev = torch.cuda.current_device()

    def empty():
        check(lib.fused_ce_empty_launch(dev, stream) == 0, "the empty kernel did not launch")

    floor = {"ms": _device_ms(torch, empty), "host_us": _host_us(torch, empty),
             "device_ms": _profiled_ms(torch, empty, "fused_ce_empty_sm90")}
    print(f"[timing] floor (empty kernel through the C path): ms={floor['ms']:.5f} "
          f"device_ms={floor['device_ms']} host_us={floor['host_us']:.2f} [{CARD}]")

    def plain_round():
        _, plse, _ = fl.fused_ce_fwd_plain(x, y, na, 0.0, scale)
        return fl.fused_ce_bwd_plain(x, y, na, plse, g, 0.0, scale)

    library_round = _device_ms(torch, lambda: torch.autograd.grad(
        F.cross_entropy(xg[:, :active], y, label_smoothing=0.0), xg, grad_outputs=one))
    library_round_host = _host_us(torch, lambda: torch.autograd.grad(
        F.cross_entropy(xg[:, :active], y, label_smoothing=0.0), xg, grad_outputs=one))
    extra = {
        "fwd": {"plain_ms": _device_ms(torch, lambda: fl.fused_ce_fwd_plain(x, y, na, 0.0, scale)),
                "library_ms": _device_ms(torch, lambda: F.cross_entropy(x[:, :active], y)),
                "library_host_us": _host_us(torch, lambda: F.cross_entropy(x[:, :active], y)),
                "library_call": "F.cross_entropy(logits[:, :50], labels)",
                "bytes": _fwd_bytes(b, w), "ops": 6 * b * w},
        # No one PyTorch call computes the gradient alone: the yardstick is
        # the library's round, which computes the value and the gradient.
        "bwd": {"plain_ms": _device_ms(torch, lambda: fl.fused_ce_bwd_plain(
                    x, y, na, lse, g, 0.0, scale)),
                "library_ms": library_round, "library_host_us": library_round_host,
                "library_call": "F.cross_entropy(logits[:, :50], labels) and its backward",
                "bytes": 2 * b * w * 4 + b * 8 + 4 + b * 4 + 4, "ops": 7 * b * w},
        "round": {"plain_ms": _device_ms(torch, plain_round),
                  "library_ms": library_round, "library_host_us": library_round_host,
                  "library_call": "F.cross_entropy(logits[:, :50], labels) and its backward",
                  # logits, labels, na, g -> out, dlogits
                  "bytes": 2 * b * w * 4 + b * 8 + 4 + 4 + 4, "ops": 13 * b * w},
    }
    out = {}
    for op in ("fwd", "bwd", "round"):
        t = dict(extra[op])
        _bound(t)
        for design in ("cuda", "triton"):
            tt = turns[design][op]
            dev_ms = [v for v in tt["device_ms"] if v is not None]
            t[design] = {"ms": _mean(tt["ms"]), "device_ms": _mean(dev_ms) if dev_ms else None,
                         "host_us": _mean(tt["host_us"]), "turns": tt}
        if op == "round":
            t["launches"] = {d: kernels[d]["launches"] for d in kernels}
        t["floor"] = floor
        out[op] = t
        c, tr = t["cuda"], t["triton"]
        print(f"[timing] {op} B={b} W={w}: CUDA ms={c['ms']:.5f} device_ms={c['device_ms']} "
              f"host_us={c['host_us']:.2f} | Triton ms={tr['ms']:.5f} "
              f"device_ms={tr['device_ms']} host_us={tr['host_us']:.2f} | "
              f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
              f"library_host_us={t['library_host_us']:.2f} "
              f"bound_ms={t['bound_ms']:.7f} ({t['bound_by']}) [{CARD}]")
    return out


# The new widths' shapes on their paths, timed: MNIST's step (B=32, W=10,
# 10 active in task 1), 10 classes at --mesh_model 4 (W=12), 100 classes at
# --mesh_model 3 (W=102) and the full imagenet1000 head (W=1000; its first
# task and all of it, f32 and bf16 logits), each at the train step's batch
# where it is not MNIST's.
WIDTH_SHAPES = [(32, 10, 10, "f32"), (128, 12, 10, "f32"), (128, 102, 100, "f32"),
                (128, 1000, 100, "f32"), (128, 1000, 100, "bf16"), (128, 1000, 1000, "f32"),
                (128, 1000, 1000, "bf16")]


def phase_widths(torch):
    """Each CUDA kernel at the new widths' shapes: ``ms`` (device-side
    spacing), the plain version's, the library call's and the byte bound,
    as ``phase_timing`` takes them at the main shape."""
    import torch.nn.functional as F

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    out = {}
    one = torch.ones((), device="cuda")
    g = torch.tensor(1.0, device="cuda")
    for b, w, active, dname in WIDTH_SHAPES:
        scale = 1.0 / b
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        esize = 4 if dname == "f32" else 2
        x, y, na = _inputs(torch, b, w, active, dtype, seed=3)
        xg = x.clone().requires_grad_(True)
        lse = fl.fused_ce_fwd(x, y, na, 0.0, scale)[1]
        library_round = _device_ms(torch, lambda: torch.autograd.grad(
            F.cross_entropy(xg[:, :active], y), xg, grad_outputs=one))
        rows = {
            "fwd": {"ms": _device_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0, scale)),
                    "plain_ms": _device_ms(torch, lambda: fl.fused_ce_fwd_plain(
                        x, y, na, 0.0, scale)),
                    "library_ms": _device_ms(torch, lambda: F.cross_entropy(x[:, :active], y)),
                    "bytes": _fwd_bytes(b, w, esize), "ops": 6 * b * w},
            "bwd": {"ms": _device_ms(torch, lambda: fl.fused_ce_bwd(x, y, na, lse, g, 0.0,
                                                                     scale)),
                    "plain_ms": _device_ms(torch, lambda: fl.fused_ce_bwd_plain(
                        x, y, na, lse, g, 0.0, scale)),
                    "library_ms": library_round,
                    "bytes": 2 * b * w * esize + b * 8 + 4 + b * 4 + 4, "ops": 7 * b * w},
        }
        for op, t in rows.items():
            _bound(t)
            print(f"[widths] {op} B={b} W={w} active={active} {dname}: ms={t['ms']:.5f} "
                  f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
                  f"bound_ms={t['bound_ms']:.7f} ({t['bound_by']}) [{CARD}]")
        out[f"B{b}_W{w}_a{active}" + ("" if dname == "f32" else f"_{dname}")] = rows
    return out


# --------------------------------------------------------------------------- #
# Phase 3
# --------------------------------------------------------------------------- #


def _counts(fl) -> dict:
    """The fused-CE counts since ``fl.reset_launches()``: ``ran``, how often
    each kernel ran on the card as the kernels count themselves (every
    replay of a captured step included), and ``calls``, the wrappers'
    launches on the host (a captured step calls them once, at its
    capture)."""
    return {"ran": list(fl.device_launches()), "calls": [fl.FWD_LAUNCHES, fl.BWD_LAUNCHES]}


def _check_counts(what: str, counts: dict, steps: int, captures: int) -> None:
    """Each kernel ran once a train step on the card.  The wrappers were
    called once a step, but on the graphed path once for each task's eager
    first step and once at its capture."""
    calls = 2 * captures if captures else steps
    check(steps > 0 and counts["ran"] == [steps, steps] and counts["calls"] == [calls, calls],
          f"{what}: the fused-CE kernels ran {counts['ran']} times (wrapper calls "
          f"{counts['calls']}) for {steps} train steps and {captures} graph captures")


def _profile_epoch(torch, trainer, task_id, epoch, method="_run_epoch_fused"):
    """Wrap the trainer's fused epoch (or, with ``method`` set to
    ``"_run_epoch_steps"``, its per-step epoch) so that epoch ``epoch`` of
    task ``task_id`` runs under ``torch.profiler``; the returned dict gets that
    epoch's kernels (``{name: [count, device µs]}``), its steps, the card's
    busy ms a step (``utils/profiling.device_step_ms``), its synchronized
    wall ms and the fused-CE kernels' own counts of their runs in it
    (``ran``)."""
    from torch.profiler import ProfilerActivity, profile

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.profiling import (
        device_step_ms,
        kernel_table,
    )

    seen = {}
    run = getattr(trainer, method)
    epoch_at = {"_run_epoch_fused": 2, "_run_epoch_steps": 1}[method]

    def profiled(t, *args):
        if (t, args[epoch_at]) != (task_id, epoch):
            return run(t, *args)
        ran = fl.device_launches()  # waits for the queued work
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rows = run(t, *args)
            torch.cuda.synchronize()
            seen["wall_ms"] = 1e3 * (time.perf_counter() - t0)
        seen["ran"] = [b - a for a, b in zip(ran, fl.device_launches())]
        seen["kernels"] = kernel_table(prof)
        seen["steps"] = len(rows)
        seen["busy_ms_per_step"] = device_step_ms(prof, len(rows))["trace_step_ms"]
        return rows

    setattr(trainer, method, profiled)
    return seen


def _named(kernels: dict, name: str):
    """Count and device µs of the kernels whose name holds ``name``."""
    hits = [v for k, v in kernels.items() if name in k]
    return sum(c for c, _ in hits), sum(us for _, us in hits)


# The records the CLI writes under every flag set, in order; the telemetry's
# own (compile_event, recompile, hbm, metrics_snapshot, ...) come between.
CORE_RECORDS = ("run", "resume", "fault_injected", "epoch", "task", "cil_metrics", "final")


def _check_telemetry(records, spans, nb_tasks: int, captures: int) -> dict:
    """The main path's telemetry: one ``compile_event`` a task whose
    ``compiles`` are its capture, every ``recompile_budget`` ok, one ``hbm``
    record a task with memory in use, and the spans one level below each
    ``task`` covering ``SPAN_COVERAGE`` of it.  Returns each task's wall and
    its children's shares (the fit's breakdown)."""
    of = lambda kind: [r for r in records if r["type"] == kind]  # noqa: E731
    events, budgets, hbm = of("compile_event"), of("recompile_budget"), of("hbm")
    check([r["task_id"] for r in events] == list(range(nb_tasks))
          and [r["compiles"] for r in events] == [1] * nb_tasks
          and sum(r["compiles"] for r in events) == captures,
          f"compile_event records {[(r['task_id'], r['compiles']) for r in events]} "
          f"for {captures} captures")
    check(len(budgets) == nb_tasks and all(r["ok"] for r in budgets),
          f"recompile_budget records {budgets}")
    check([r["task_id"] for r in of("recompile")] == list(range(nb_tasks))
          and all(r["expected"] for r in of("recompile")) and not of("recompile_warning"),
          f"recompile records {of('recompile')}")
    in_use = [dev["bytes_in_use"] for r in hbm for dev in r["devices"].values()]
    check(len(hbm) == nb_tasks and len(in_use) == nb_tasks and all(b > 0 for b in in_use),
          f"hbm records {hbm}")
    tasks = [sp for sp in spans if sp["name"] == "task"]
    check(len(tasks) == nb_tasks and all(sp["depth"] == 1 for sp in tasks),
          f"task spans {[(sp['name'], sp['depth']) for sp in tasks]}")
    shares, task_s = [], []
    for t in tasks:
        kids = {}
        for sp in spans:
            if sp["parent"] == t["span_id"]:
                kids[sp["name"]] = kids.get(sp["name"], 0.0) + sp["dur_s"] / t["dur_s"]
        check(sum(kids.values()) >= SPAN_COVERAGE,
              f"task {t['task']}'s children cover {100 * sum(kids.values()):.1f}% of its "
              f"{t['dur_s']:.3f} s: " + ", ".join(f"{k} {100 * v:.1f}%" for k, v in kids.items()))
        shares.append(kids)
        task_s.append(t["dur_s"])
    return {"shares": shares, "task_s": task_s, "compiles": [r["compiles"] for r in events],
            "compile_s": [r["compile_s"] for r in events], "hbm": in_use}


def phase_main_path(torch):
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import (
        triton_fused_loss as tfl,
    )

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import (
        read_heartbeat,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import native

    epochs = 2
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "smoke.jsonl")
        tel, hb_path = os.path.join(tmp, "tel"), os.path.join(tmp, "hb", "heartbeat.json")
        # JAX's initial networks, drawn on this host: the fixture's recipes,
        # and the main path's own (resnet32, 100 wide, --seed 0).
        t0 = time.perf_counter()
        recipes = check_init_digests()
        draw_s = time.perf_counter() - t0
        trainer = build_trainer([
            *RACE_ARGV, "--batch_size", "128", "--num_epochs", str(epochs), "--log_file", log,
            "--telemetry_dir", tel, "--heartbeat_path", hb_path, "--recompile_budget",
        ])
        main_recipe = next(r for r in recipes if (r["backbone"], r["width"], r["seed"])
                           == ("resnet32", 100, trainer.config.seed))
        check(state_digest(trainer.state.model.state_dict().items())
              == main_recipe["digests"]["state"],
              "the main path's initial network is not JAX's for its seed")
        print(f"[main] JAX's initial draws on this host: {len(recipes)} recipes' digests equal "
              f"{INIT_DIGESTS} ({draw_s:.2f} s), and the main path's initial network "
              f"(--seed {trainer.config.seed})")
        # Native herding on this host: the library built (or found built)
        # under build/host/ and the memory set to use it.
        lib = native.load_native()
        check(lib is not None and trainer.memory.prefer_native
              and os.path.dirname(os.path.dirname(lib._name)) == str(native.BUILD_ROOT),
              f"native herding is off on the card's host (library {lib}, prefer_native "
              f"{trainer.memory.prefer_native})")
        # Task 0's herding input, for the herding phase.
        herd_input = {}
        add = trainer.memory.add

        def keep_first(x, y, t, features):
            herd_input.setdefault("y", np.array(y))
            herd_input.setdefault("features", np.array(features))
            return add(x, y, t, features)

        trainer.memory.add = keep_first
        check(trainer.aug_cfg.rand_augment and trainer.aug_cfg.ra_num_ops == 2,
              f"the main path does not run the parser's RandAugment: {trainer.aug_cfg}")
        check(trainer.config.fused_epochs and trainer.epoch_fn.graphed,
              "the parser's defaults do not run the fused, graphed epoch")
        model = trainer.state.model
        check(model.fc.weight.shape == (100, 64), "the head is not 100 wide")
        off = [n for n, p in model.named_parameters() if p.device.type != "cuda"]
        off += [n for n, t in model.named_buffers() if t.device.type != "cuda"]
        check(not off, f"tensors off the card: {off[:5]}")
        # Task 1's second epoch: every step a replay of task 1's graph.
        profiled = _profile_epoch(torch, trainer, 1, 1)

        torch.cuda.synchronize()
        fl.reset_launches()
        tfl.FWD_LAUNCHES = tfl.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _counts(fl)
        launches = {"fwd": counts["ran"][0], "bwd": counts["ran"][1], "calls": counts["calls"],
                    "triton_fwd": tfl.FWD_LAUNCHES, "triton_bwd": tfl.BWD_LAUNCHES}
        records = [json.loads(ln) for ln in open(log)]
        beat = read_heartbeat(hb_path, max_age_s=2 * trainer.config.heartbeat_interval_s)
        files = sorted(os.listdir(tel))
        spans = [json.loads(ln) for ln in open(os.path.join(tel, "spans.jsonl"))]
        flight = json.load(open(os.path.join(tel, "flight_0.json")))

    steps = trainer.global_step
    # Counted where the kernels run: every replay of a captured step.
    _check_counts("main path", counts, steps, trainer.epoch_fn.captures)
    check(launches["triton_fwd"] == launches["triton_bwd"] == 0,
          f"the main path launched Triton kernels: {launches}")
    types = [r["type"] for r in records if r["type"] in CORE_RECORDS]
    nb_tasks = result["nb_tasks"]
    want = ["run"] + (["epoch"] * epochs + ["task", "cil_metrics"]) * nb_tasks + ["final"]
    check(nb_tasks == 6 and types == want, f"record sequence {types}")
    telemetry = _check_telemetry(records, spans, nb_tasks, trainer.epoch_fn.captures)
    check(beat.get("fresh") is True and beat.get("task") == nb_tasks - 1,
          f"the heartbeat is stale or behind: {beat}")
    check({"spans.jsonl", "trace.json", "flight_0.json"} <= set(files)
          and flight["reason"] == "close", f"telemetry files {files}, flight {flight['reason']}")
    epochs_rec = [r for r in records if r["type"] == "epoch"]
    check(all(r["fused"] is True and r["graphed"] is True for r in epochs_rec),
          "the main path's epochs are not fused and graphed")
    check(trainer.epoch_fn.captures == nb_tasks,
          f"{trainer.epoch_fn.captures} graph captures for {nb_tasks} tasks")
    check(sum(r["steps"] for r in epochs_rec) == steps, "epoch records miss steps")
    for r in epochs_rec:
        check(all(math.isfinite(r[k]) for k in ("loss", "ce", "kd", "acc1")),
              f"non-finite metrics in {r}")
    # The kernels on the card, counted by the profiler over one replayed
    # epoch: one forward and one backward a step.
    fwd_n, fwd_us = _named(profiled["kernels"], "fused_ce_fwd_sm90")
    bwd_n, bwd_us = _named(profiled["kernels"], "fused_ce_bwd_sm90")
    check(fwd_n == bwd_n == profiled["steps"] > 0 and profiled["ran"] == [fwd_n, bwd_n],
          f"the profiler saw {fwd_n} forward and {bwd_n} backward kernels in an epoch of "
          f"{profiled['steps']} replayed steps, the kernels counted {profiled['ran']}")
    busy_ms = profiled["busy_ms_per_step"]
    kernels_per_step = sum(c for c, _ in profiled["kernels"].values()) / profiled["steps"]
    tasks = [r for r in records if r["type"] == "task"]
    check(tasks[0]["gamma"] is None and all(t["gamma"] > 0 for t in tasks[1:]),
          "weight alignment gammas")
    # The model learns: task 0's mean train CE falls from epoch 1 to epoch 2
    # (by ~1.0 in every run so far).  Eval top-1 after two epochs is no
    # gate: same-seed runs differ on the card (cuDNN's nondeterministic
    # backward), and that early it has ranged from 3% to 17%.
    ce = [r["ce"] for r in epochs_rec if r["task_id"] == 0]
    check(ce[1] < ce[0] - 0.3, f"task 0 train CE did not fall: {ce}")

    # The trained model on the card against the same model on the CPU.
    x = torch.from_numpy(trainer.scenario_val[0].x[:16]).float().cuda()
    with torch.no_grad():
        got, _ = model(x, trainer.state.num_active)
        cpu = copy.deepcopy(model).cpu()
        ref, _ = cpu(x.cpu(), trainer.state.num_active.cpu())
    check(got.shape == (16, 100) and bool(torch.isfinite(got).all()), "eval logits")
    check(torch.allclose(got.cpu(), ref, rtol=1e-3, atol=1e-3),
          f"card vs CPU eval logits differ by {(got.cpu() - ref).abs().max().item()}")

    # The median over the epochs the profiler did not slow.
    unprofiled = [r for r in epochs_rec if (r["task_id"], r["epoch"]) != (1, 2)]
    step_ms = _step_ms(unprofiled)
    replay_ms = _step_ms(r for r in unprofiled if r["epoch"] == 2)
    # Where a replayed step's device time goes: the kernels by total time.
    top = sorted(profiled["kernels"].items(), key=lambda kv: -kv[1][1])[:8]
    top = [(name[:70], count / profiled["steps"], us / 1e3 / profiled["steps"])
           for name, (count, us) in top]
    print(f"[main] {steps} train steps in {nb_tasks} tasks, fused and graphed "
          f"({trainer.epoch_fn.captures} captures), {wall_s:.1f} s wall; median step "
          f"{step_ms:.3f} ms, {replay_ms:.3f} ms in the replay-only epochs [{CARD}]; "
          f"fused-CE kernels ran {counts['ran']} times on the card, wrapper calls "
          f"{counts['calls']}")
    print(f"[main] profiler over task 1 epoch 2 ({profiled['steps']} replayed steps, "
          f"{profiled['wall_ms']:.1f} ms synchronized wall): fused_ce_fwd_sm90 x{fwd_n} "
          f"({fwd_us / max(fwd_n, 1) / 1e3:.7f} ms each), fused_ce_bwd_sm90 x{bwd_n} "
          f"({bwd_us / max(bwd_n, 1) / 1e3:.7f} ms each); {kernels_per_step:.1f} kernels "
          f"a step, device busy {busy_ms:.3f} ms a step, "
          f"{100 * busy_ms * profiled['steps'] / profiled['wall_ms']:.1f}% of the wall [{CARD}]")
    for name, per_step, ms in top:
        print(f"[main]   {ms:.4f} ms a step in {per_step:g} launches of {name}")
    print(f"[main] acc1 per task: {[round(a, 3) for a in result['acc1s']]}")
    print(f"[main] gammas: {[t['gamma'] for t in tasks]}")
    for t, shares in enumerate(telemetry["shares"]):
        print(f"[main] task {t} {telemetry['task_s'][t]:.3f} s: "
              + ", ".join(f"{name} {100 * v:.1f}%" for name, v in shares.items())
              + f" [{CARD}]")
    print(f"[main] telemetry: {nb_tasks} compile_event (compiles {telemetry['compiles']}, "
          f"compile_s {telemetry['compile_s']}), recompile_budget ok, hbm bytes_in_use "
          f"{telemetry['hbm']}, heartbeat seq {beat['seq']} fresh, flight_0.json at close; "
          f"native herding {lib._name}")
    launches.update(step_ms=step_ms, replay_step_ms=replay_ms, fit_s=wall_s,
                    captures=trainer.epoch_fn.captures, telemetry=telemetry,
                    herd_input=herd_input, quota=trainer.memory.quota(50),
                    profiled={"steps": profiled["steps"], "wall_ms": profiled["wall_ms"],
                              "fwd": fwd_n, "bwd": bwd_n,
                              "fwd_device_ms": fwd_us / max(fwd_n, 1) / 1e3,
                              "bwd_device_ms": bwd_us / max(bwd_n, 1) / 1e3,
                              "kernels_per_step": kernels_per_step,
                              "busy_ms_per_step": busy_ms,
                              "busy_share": busy_ms * profiled["steps"] / profiled["wall_ms"],
                              "top_kernels": top})
    return launches


def phase_herding(main) -> dict:
    """One class's herding call of the main path's task 0 (its real
    features, the memory's quota, and 20 for the JAX package's bench) on
    this host, native against numpy, timed in turns: equal selections."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.memory import (
        herd_barycenter,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.native import (
        herd_barycenter_native,
    )

    y, feats = main["herd_input"]["y"], main["herd_input"]["features"]
    cls = int(np.unique(y)[0])
    f = np.ascontiguousarray(feats[y == cls], dtype=np.float32)
    out = {"n": int(f.shape[0]), "d": int(f.shape[1])}
    for nb in (main["quota"], 20):
        native = herd_barycenter_native(f, nb)
        plain = herd_barycenter(f, nb, allow_native=False)
        check(native is not None and np.array_equal(native, plain),
              f"native herding selects {native} where numpy selects {plain} (nb={nb})")
        times = {"native": [], "numpy": []}
        for _ in range(HERD_REPEATS):
            for name, fn in (("native", lambda: herd_barycenter_native(f, nb)),
                             ("numpy", lambda: herd_barycenter(f, nb, allow_native=False))):
                t0 = time.perf_counter()
                fn()
                times[name].append(1e3 * (time.perf_counter() - t0))
        row = {k: statistics.median(v) for k, v in times.items()}
        out[f"nb{nb}"] = {"native_ms": row["native"], "numpy_ms": row["numpy"],
                          "selections_equal": True}
        print(f"[herd] class {cls} of task 0: n={f.shape[0]} d={f.shape[1]} nb={nb}: native "
              f"{row['native']:.4f} ms, numpy {row['numpy']:.4f} ms a call (median of "
              f"{HERD_REPEATS}, host clock); selections equal [{CARD}]")
    return out


# --------------------------------------------------------------------------- #
# Augmentation on the card
# --------------------------------------------------------------------------- #


def phase_augment(torch):
    """RandAugment, colour jitter and erasing on the card against the same
    port functions on the CPU; then ``train_augment``'s times at B=128."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug

    rng = np.random.RandomState(7)
    imgs_cpu = torch.from_numpy(rng.randint(0, 256, (AUG_B, 32, 32, 3)).astype(np.float32))
    imgs = imgs_cpu.cuda()
    worst, combos = {}, 0
    for interp in ("bilinear", "bicubic"):
        for op in range(taug.NUM_RA_OPS):
            for mag in (0.0, 4.5, 9.0, 10.0):
                for sign in (1.0, -1.0):
                    args = [torch.full((AUG_B,), v) for v in (op, mag, sign)]
                    ref = taug.ra_apply(imgs_cpu, *args, 32, interp)
                    got = taug.ra_apply(imgs, *(a.cuda() for a in args), 32, interp).cpu()
                    diff = (got - ref).abs().max().item()
                    exact = op in INTEGER_OPS or (op in taug.GEOMETRIC_OPS and mag == 0.0)
                    check(diff == 0.0 if exact else diff <= 1.0,
                          f"{taug.RA_OPS[op]} m={mag} sign={sign} {interp}: card vs CPU "
                          f"max |diff| {diff} (allowed {0 if exact else 1} LSB)")
                    key = f"{taug.RA_OPS[op]}/{interp}"
                    worst[key] = max(worst.get(key, 0.0), diff)
                    combos += 1
    print(f"[augment] {combos} RandAugment cases (15 ops x 4 magnitudes x 2 signs x 2 kernels, "
          f"B={AUG_B}): card = CPU within 1 LSB, bitwise for the integer ops and the identity "
          f"warp; cases off by 1 LSB: {sorted(k for k, v in worst.items() if v > 0)}")

    u8 = torch.from_numpy(rng.randint(0, 256, (AUG_B, 32, 32, 3)).astype(np.uint8))
    pipelines = {
        "color_jitter": dict(rand_augment=False, color_jitter=0.4),
        "erasing_pixel": dict(rand_augment=False, color_jitter=0.0, reprob=0.5, recount=2),
        "erasing_rand": dict(rand_augment=False, color_jitter=0.0, reprob=0.5, remode="rand"),
        "erasing_const_randaugment": dict(reprob=0.5, remode="const",
                                          ra_interpolation="random"),
    }
    for name, recipe in pipelines.items():
        cfg = taug.AugmentConfig(**recipe)
        draws = taug.draw_params(AUG_B, cfg, torch.Generator().manual_seed(4), (32, 32, 3))
        ref = taug.augment(u8, draws, cfg)
        on_card = taug.Draws(**{k: None if v is None else v.cuda()
                                for k, v in vars(draws).items()})
        got = taug.augment(u8.cuda(), on_card, cfg).cpu()
        levels = (got - ref).mul(torch.tensor(cfg.std) * 255).abs()
        same = levels < 1e-3
        check(levels.max().item() <= 1.0 + 1e-3 and same.float().mean().item() > 0.99
              and torch.allclose(got[same], ref[same], rtol=1e-6, atol=1e-6),
              f"{name}: card vs CPU after normalization differ by "
              f"{(got - ref).abs().max().item()} (levels {levels.max().item()})")
    print(f"[augment] {', '.join(pipelines)} with fixed draws: card = CPU to rtol 1e-6 "
          "after normalization")

    batch = torch.randint(0, 256, (AUG_B, 32, 32, 3), dtype=torch.uint8, device="cuda")
    out = {"combos": combos, "off_by_one": sorted(k for k, v in worst.items() if v > 0)}
    for name, cfg in (("randaugment", taug.AugmentConfig()),
                      ("aa_none", taug.AugmentConfig(rand_augment=False, color_jitter=0.4))):
        gen = torch.Generator(device="cuda").manual_seed(0)

        def call():
            return taug.train_augment(batch, cfg, gen)

        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # any host sync in the call raises
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        prof = _launches_per_call(_profile(torch, call, 20), 20)
        check(not any(k.startswith("Memcpy") for k in prof["copies"]),
              f"train_augment ({name}) copies between host and card: {prof['copies']}")
        t = {"kernels_per_call": prof["launches"], "device_ms": prof["device_ms"],
             "host_us": _host_us(torch, call, n=2, reps=20),
             "wall_ms": _host_ms(torch, call, n=20)}
        out[name] = t
        print(f"[augment] train_augment B={AUG_B} {name}: {t['kernels_per_call']:g} kernels a "
              f"call, device {t['device_ms']:.4f} ms (profiler sum), host {t['host_us']:.1f} us "
              f"to enqueue, {t['wall_ms']:.3f} ms synchronized wall; no host sync "
              f"[{CARD}]")
    return out


# --------------------------------------------------------------------------- #
# Precision presets
# --------------------------------------------------------------------------- #


def phase_precision(torch):
    """Each preset at full width (resnet32, 100-wide head, B=128, a teacher,
    RandAugment, the CUDA kernels): ~30 steps, their median time, finite
    losses, 2 kernel launches a step, the dtype contract; then a short
    ``--precision bf16_selective`` run of the main path."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import (
        build_raw_dataset,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
        AugmentConfig, eval_preprocess,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (
        BatchNorm, create_model, grow,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models.resnet import Conv2d
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import PRESETS
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random

    (x, y), _ = build_raw_dataset("synthetic_hard128", "", True)
    idx = np.random.RandomState(0).choice(np.flatnonzero(y < 60), (PRECISION_STEPS, 128))
    xs, ys = torch.from_numpy(x[idx]).cuda(), torch.from_numpy(y[idx]).cuda()
    out = {}
    for preset, policy in PRESETS.items():
        model = create_model("resnet32", 100, seed=3, policy=policy).cuda()
        grow(model, jax_random.key(1), 0, 50)
        teacher = tt.Teacher(copy.deepcopy(model).requires_grad_(False), _count(torch, 50))
        grow(model, jax_random.key(2), 50, 10)
        state = tt.TrainState(model, tt.sgd_init(model.parameters()), _count(torch, 60),
                              _count(torch, 50))
        step = tt.make_train_step(AugmentConfig(), policy, 0.0, 2.0, 0.9, 5e-4,
                                  use_pallas_loss=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        fl.reset_launches()
        times, losses = [], []
        for i in range(PRECISION_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, teacher, xs[i], ys[i], gen, 0.1, 0.5)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(m["loss"])
        losses = torch.stack(losses).cpu()
        counts = _counts(fl)
        launches = tuple(counts["ran"])
        check(bool(torch.isfinite(losses).all()), f"{preset}: non-finite loss {losses}")
        _check_counts(preset, counts, PRECISION_STEPS, 0)
        # The dtype contract, on one more (untimed) step with hooks.
        seen = {"conv": set(), "bn_in": set()}

        def record(key, get):
            def hook(_module, inputs, output):
                seen[key].add(get(inputs, output).dtype)
            return hook

        handles = []
        for mod in model.modules():
            if isinstance(mod, Conv2d):
                handles.append(mod.register_forward_hook(record("conv", lambda i, o: o)))
            elif isinstance(mod, BatchNorm):
                handles.append(mod.register_forward_hook(record("bn_in", lambda i, o: i[0])))
        step(state, teacher, xs[0], ys[0], gen, 0.1, 0.5)
        with torch.no_grad():
            logits, feats = model(eval_preprocess(xs[0], AugmentConfig()), state.num_active)
        for h in handles:
            h.remove()
        check(logits.dtype == torch.float32 and feats.dtype == torch.float32,
              f"{preset}: logits {logits.dtype}, features {feats.dtype}")
        off = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
               if t.dtype != torch.float32]
        off += [f"momentum[{i}]" for i, t in enumerate(state.momentum) if t.dtype != torch.float32]
        check(not off, f"{preset}: state off f32: {off[:5]}")
        check(seen["conv"] == {policy.compute_dtype},
              f"{preset}: conv outputs {seen['conv']}, want {policy.compute_dtype}")
        check(seen["bn_in"] == {policy.act_dtype},
              f"{preset}: BatchNorm inputs {seen['bn_in']}, want {policy.act_dtype}")
        step_ms = statistics.median(times[5:])
        out[preset] = {"step_ms": step_ms, "steps": PRECISION_STEPS, "launches": list(launches),
                       "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                       "conv_out": str(seen["conv"].pop()).removeprefix("torch."),
                       "bn_in": str(seen["bn_in"].pop()).removeprefix("torch.")}
        print(f"[precision] {preset}: median step {step_ms:.3f} ms over {PRECISION_STEPS - 5} "
              f"steps (B=128, resnet32, teacher, RandAugment, CUDA kernels) [{CARD}]; loss "
              f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}; launches {launches}; conv "
              f"out {out[preset]['conv_out']}, BN in {out[preset]['bn_in']}; logits, params, "
              "momentum and BN stats f32")

    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "bf16.jsonl")
        trainer = build_trainer([*RACE_ARGV, "--batch_size", "128", "--num_epochs", "1",
                                 "--precision", "bf16_selective", "--log_file", log])
        torch.cuda.synchronize()
        fl.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        records = [json.loads(ln) for ln in open(log)]
    steps = trainer.global_step
    counts = _counts(fl)
    types = [r["type"] for r in records if r["type"] in CORE_RECORDS]
    check(types == ["run"] + ["epoch", "task", "cil_metrics"] * 6 + ["final"],
          f"bf16_selective run: record sequence {types}")
    check(records[0]["precision"] == "bf16_selective", f"run record {records[0]}")
    _check_counts("bf16_selective run", counts, steps, trainer.epoch_fn.captures)
    epochs = [r for r in records if r["type"] == "epoch"]
    check(all(math.isfinite(r[k]) for r in epochs for k in ("loss", "ce", "kd")),
          "bf16_selective run: non-finite metrics")
    step_ms = _step_ms(epochs)
    out["main_bf16_selective"] = {"steps": steps, "wall_s": wall_s, "step_ms": step_ms,
                                  "acc1s": result["acc1s"]}
    print(f"[precision] main path --precision bf16_selective, 1 epoch a task: {steps} steps, "
          f"{wall_s:.1f} s, median step {step_ms:.3f} ms [{CARD}]; acc1 per task "
          f"{[round(a, 3) for a in result['acc1s']]}")
    return out


# --------------------------------------------------------------------------- #
# The fused epoch against the per-step loop
# --------------------------------------------------------------------------- #


def _step_ms(epochs) -> float:
    """The median train step in ms over epoch records (host clock)."""
    return statistics.median(1e3 * (r["host_s"] + r["device_s"]) / r["steps"] for r in epochs)


def _deterministic_cudnn(torch, on: bool) -> None:
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def phase_fused(torch):
    """The main path's recipe under deterministic cuDNN, five ways: (a) the
    fused, graphed epoch, (b) ``--no_fused_epochs``, (c) ``--no_fused_epochs
    --prefetch_depth 2``, (d) fused with ``--prefetch_depth 1`` (the warm
    ring), (e) fused with every telemetry flag on (``TELEMETRY_FLAGS``); all
    five must end bitwise equal."""
    from analysis import contractcheck, threadcheck

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    runs = {}
    _deterministic_cudnn(torch, True)
    try:
        for name, flags in FUSED_RUNS.items():
            with tempfile.TemporaryDirectory() as tmp:
                log = os.path.join(tmp, "run.jsonl")
                flags = [f.replace("{tmp}", tmp) for f in flags]
                try:
                    trainer = build_trainer([*RACE_ARGV, "--batch_size", "128",
                                             "--num_epochs", "2", *flags, "--log_file", log])
                    torch.cuda.synchronize()
                    fl.reset_launches()
                    t0 = time.perf_counter()
                    result = trainer.fit()
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                    violations = [v for mod in (contractcheck, threadcheck) if mod.active()
                                  for v in mod.active().violations]
                finally:
                    threadcheck.uninstall()
                    contractcheck.uninstall()
                records = [json.loads(ln) for ln in open(log)]
                traces = [r for r in records if r["type"] == "profile_trace"]
                check(all(os.path.getsize(r["path"]) > 0 for r in traces),
                      f"{name}: a profile trace is missing")
            epochs = [r for r in records if r["type"] == "epoch"]
            runs[name] = {
                "result": result, "wall_s": wall_s, "steps": trainer.global_step,
                "counts": _counts(fl),
                "captures": trainer.epoch_fn.captures,
                "fused": sorted({r["fused"] for r in epochs}),
                "graphed": sorted({r["graphed"] for r in epochs}),
                "gammas": [r["gamma"] for r in records if r["type"] == "task"],
                "warm_hits": sum(1 for r in records if r["type"] == "prefetch_warm"
                                 and r["hit"]),
                "step_ms": _step_ms(epochs),
                # Each task's first epoch carries its capture (or, per step,
                # nothing extra); the later epochs are replays only.
                "first_epoch_step_ms": _step_ms(r for r in epochs if r["epoch"] == 1),
                "later_epoch_step_ms": _step_ms(r for r in epochs if r["epoch"] > 1),
                "violations": violations + [r for r in records if r["type"].endswith(
                    "_violation") or r["type"] == "recompile_warning"],
                "traces": len(traces),
                "state": {k: v.detach().cpu().clone()
                          for k, v in trainer.state.model.state_dict().items()},
            }
            del trainer
            torch.cuda.empty_cache()
    finally:
        _deterministic_cudnn(torch, False)

    ref = runs["fused"]
    want = {"fused": ([True], [True], 6), "per_step": ([False], [False], 0),
            "per_step_prefetch2": ([False], [False], 0), "fused_prefetch1": ([True], [True], 6),
            "fused_telemetry": ([True], [True], 6)}
    for name, run in runs.items():
        fused, graphed, captures = want[name]
        check(run["fused"] == fused and run["graphed"] == graphed and run["captures"] == captures,
              f"{name}: fused {run['fused']}, graphed {run['graphed']}, captures "
              f"{run['captures']}")
        _check_counts(name, run["counts"], run["steps"], run["captures"])
        same = (run["result"]["acc1s"] == ref["result"]["acc1s"]
                and run["result"]["acc_matrix"] == ref["result"]["acc_matrix"]
                and run["gammas"] == ref["gammas"] and run["steps"] == ref["steps"]
                and _state_equal(torch, run["state"], ref["state"]))
        check(same, f"{name} is not bitwise the fused run: acc1s {run['result']['acc1s']} vs "
                    f"{ref['result']['acc1s']}, state delta "
                    f"{_state_delta(torch, run['state'], ref['state'])[0]:.3g}")
    check(runs["fused_prefetch1"]["warm_hits"] == 5,
          f"{runs['fused_prefetch1']['warm_hits']} prefetch_warm hits (want 5)")
    tel = runs["fused_telemetry"]
    check(tel["violations"] == [] and tel["traces"] == 6,
          f"the telemetry run: violations {tel['violations'][:3]}, {tel['traces']} traces")
    for name, run in runs.items():
        print(f"[fused] {name}: median step {run['step_ms']:.3f} ms (first epochs "
              f"{run['first_epoch_step_ms']:.3f}, later epochs {run['later_epoch_step_ms']:.3f}), "
              f"fit {run['wall_s']:.2f} s, {run['captures']} graph captures, {run['steps']} "
              f"steps, kernels ran {run['counts']['ran']} (wrapper calls "
              f"{run['counts']['calls']}), warm hits {run['warm_hits']} [{CARD}]")
    print(f"[fused] telemetry on against off (graphed, deterministic): replayed step "
          f"{tel['later_epoch_step_ms']:.3f} against {ref['later_epoch_step_ms']:.3f} ms, fit "
          f"{tel['wall_s']:.2f} against {ref['wall_s']:.2f} s (its first epochs profiled) "
          f"[{CARD}]")
    print(f"[fused] all five runs bitwise equal under deterministic cuDNN (every state_dict "
          f"tensor, acc1s, gamma, the matrix); acc1s {[round(a, 3) for a in ref['result']['acc1s']]}")
    return {name: {k: v for k, v in run.items() if k not in ("state", "result")}
            for name, run in runs.items()}


# --------------------------------------------------------------------------- #
# Phase 4: data parallel
# --------------------------------------------------------------------------- #


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_backend(torch) -> str:
    """``nccl`` with a card per rank; with fewer cards, ``gloo`` with every
    rank on card 0 (NCCL refuses two ranks on one device)."""
    return "nccl" if torch.cuda.device_count() >= DP_RANKS else "gloo"


def _count(torch, n):
    return torch.tensor([n], dtype=torch.int32, device="cuda")


def _snapshot(state):
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "momentum": [m.detach().cpu().clone() for m in state.momentum]}


def _step_batches(torch):
    """The parity steps' global uint8 batches of 128 rows, the same in every
    process: ``synthetic_hard128`` images, labels among the 50 classes of
    task 0 for the first 3 steps, then among 60.  Real images, not noise:
    on noise the first conv's weight gradient is a sum of terms with random
    signs, which a coherent 1e-6 change in a BN statistic moves by ~1e-3 of
    its size."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import (
        build_raw_dataset,
    )

    (x, y), _ = build_raw_dataset("synthetic_hard128", "", True)
    rows = DP_STRIPE[0] * DP_RANKS
    half = DP_STEPS // 2 * rows
    idx = np.concatenate([np.flatnonzero(y < 50)[:half], np.flatnonzero(y < 60)[-half:]])
    xs = torch.from_numpy(x[idx]).cuda()
    ys = torch.from_numpy(y[idx]).cuda()
    return xs.reshape(DP_STEPS, rows, *xs.shape[1:]), ys.reshape(DP_STEPS, rows)


def _aug_generator(torch, i):
    """Step ``i``'s augmentation generator, seeded alike in every process."""
    return torch.Generator(device="cuda").manual_seed(AUG_SEED + i)


def _parity_model(torch, axis=None, dtype=None):
    """The parity model; ``dtype`` float64 gives the float64 reference (a
    policy that computes in float64 throughout)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import create_model
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import (
        PRESETS, Policy,
    )

    policy = (PRESETS["f32"] if dtype in (None, torch.float32)
              else Policy("f64", torch.float64, torch.float64, torch.float64))
    return create_model("resnet32", 100, seed=5, axis=axis, policy=policy).cuda().to(
        dtype or torch.float32)


def _job_step(torch, rank, out_dir, argv):
    """Six train steps at 2 ranks x 64 rows, each augmenting its stripe of
    the uint8 global batch with RandAugment inside the step, through the
    sharded fused loss, with rank 0's state before and after each step;
    then the sharded loss on one stripe against its plain version, and its
    times."""
    import torch.distributed as dist

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
        AugmentConfig, train_augment,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import grow
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import PRESETS
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
        broadcast_module, data_axis,
    )

    axis = data_axis((DP_RANKS, 1))
    model = _parity_model(torch, axis)
    broadcast_module(model, axis.group)
    xs, ys = _step_batches(torch)
    b = DP_STRIPE[0]
    rows = slice(rank * b, (rank + 1) * b)
    cfg = AugmentConfig()
    # The stripe's draws are the global batch's: this rank's rows of the
    # one-process augmentation, bit for bit.
    check(torch.equal(train_augment(xs[0][rows], cfg, _aug_generator(torch, 0), rank, DP_RANKS),
                      train_augment(xs[0], cfg, _aug_generator(torch, 0))[rows]),
          f"rank {rank}: the stripe's augmentation is not the global batch's rows")
    step = tt.make_train_step(cfg, PRESETS["f32"], DP_HP["label_smoothing"],
                              DP_HP["kd_temperature"], DP_HP["momentum"], DP_HP["weight_decay"],
                              use_pallas_loss=True, axis=axis)
    state = tt.TrainState(model, tt.sgd_init(model.parameters()), _count(torch, 50),
                          _count(torch, 0))
    teacher = None
    out = {"before": [], "after": [], "loss": []}
    fl.reset_launches()
    for i in range(DP_STEPS):
        if i == DP_STEPS // 2:  # task 1: teacher snapshot, head growth, fresh SGD
            teacher = tt.Teacher(copy.deepcopy(model).requires_grad_(False), _count(torch, 50))
            grow(model, jax_random.key(12), 50, 10)
            state.momentum = tt.sgd_init(model.parameters())
            state.num_active, state.known = _count(torch, 60), _count(torch, 50)
        if rank == 0:
            out["before"].append(_snapshot(state))
        m = step(state, teacher, xs[i][rows], ys[i][rows], _aug_generator(torch, i),
                 DP_HP["lr"], DP_HP["lambda_kd"])
        out["loss"].append(float(m["loss"]))
        if rank == 0:
            out["after"].append(_snapshot(state))
    torch.cuda.synchronize()
    out["counts"] = _counts(fl)
    out["final"] = torch.cat([t.detach().reshape(-1).cpu() for t in
                              list(model.parameters()) + list(model.buffers()) + state.momentum])
    out["sharded"] = _sharded_stripe(torch, dist, fl, axis)
    return out


def _sharded_stripe(torch, dist, fl, axis):
    """The sharded loss on this rank's (64, 100, 50) stripe: value and
    stripe gradient against the plain version over all 128 rows, then the
    call's times (rank 0 alone for device times, both ranks for those with
    the collective)."""
    import torch.nn.functional as F

    b, w, active = DP_STRIPE
    full_x, full_y, na = _inputs(torch, b * axis.size, w, active, torch.float32, seed=2)
    rows = slice(axis.rank * b, (axis.rank + 1) * b)
    x, y = full_x[rows].contiguous(), full_y[rows].contiguous()
    xg = x.clone().requires_grad_(True)
    loss = fl.sharded_fused_masked_cross_entropy(axis.group, xg, y, na, 0.0)
    (dx,) = torch.autograd.grad(loss, xg)
    scale = 1.0 / (b * axis.size)
    _, lse, ref = fl.fused_ce_fwd_plain(full_x, full_y, na, 0.0, scale)
    ref_dx = fl.fused_ce_bwd_plain(full_x, full_y, na, lse, torch.tensor(1.0, device="cuda"),
                                   0.0, scale)[rows]
    err = max((loss - ref).abs().item(), (dx - ref_dx).abs().max().item())
    ok = (torch.allclose(loss, ref, rtol=1e-5, atol=1e-6)
          and torch.allclose(dx, ref_dx, rtol=1e-5, atol=1e-6)
          and bool(torch.all(dx[:, active:] == 0)))
    t = {"max_abs_err": err, "ok": ok, "bytes": _fwd_bytes(b, w), "ops": 6 * b * w}
    if axis.rank == 0:
        t["kernel_ms"] = _device_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0, scale))
        t["device_ms"] = _profiled_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0, scale),
                                      "fused_ce_fwd_sm90")
        t["library_ms"] = _device_ms(torch, lambda: F.cross_entropy(x[:, :active], y))
    dist.barrier()
    # One sharded round (value and stripe gradient) a call; rank 0 profiles
    # its calls while rank 1 makes as many, since each call all-reduces.
    xr = x.clone().requires_grad_(True)
    one = torch.ones((), device="cuda")

    def sharded_round():
        loss = fl.sharded_fused_masked_cross_entropy(axis.group, xr, y, na, 0.0)
        return torch.autograd.grad(loss, xr, grad_outputs=one)

    n = 20
    if axis.rank == 0:
        t["round"] = _launches_per_call(_profile(torch, sharded_round, n), n)
    else:
        for _ in range(n + 1):
            sharded_round()
    torch.cuda.synchronize()
    dist.barrier()
    scalar = torch.zeros((), device="cuda")

    def plain():
        out = fl.fused_ce_fwd_plain(x, y, na, 0.0, scale)[2]
        dist.all_reduce(out, group=axis.group)
        return out

    t["allreduce_ms"] = _host_ms(torch, lambda: dist.all_reduce(scalar, group=axis.group))
    t["ms"] = _host_ms(torch, lambda: fl.sharded_fused_masked_cross_entropy(
        axis.group, x, y, na, 0.0))
    t["plain_ms"] = _host_ms(torch, plain)
    _bound(t)
    return t


def _job_protocol(torch, rank, out_dir, argv):
    """The race recipe at 2 ranks x 64 rows, 1 epoch a task, through the
    CLI's trainer; the kernel counts are zeroed just before ``fit``."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    trainer = build_trainer([
        *RACE_ARGV, "--batch_size", str(DP_STRIPE[0]), "--num_epochs", "1",
        "--mesh_data", str(DP_RANKS), "--log_file", os.path.join(out_dir, "dp.jsonl"),
        "--check_lockstep", "--lockstep_dir", os.path.join(out_dir, "lockstep"),
    ])
    torch.cuda.synchronize()
    fl.reset_launches()
    t0 = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    mx, my = trainer.memory.get()[:2]
    return {
        "counts": _counts(fl), "steps": trainer.global_step,
        "captures": trainer.epoch_fn.captures,
        "wall_s": time.perf_counter() - t0, "acc1s": result["acc1s"],
        "device": str(trainer.device),
        "memory": hashlib.sha256(mx.tobytes() + my.tobytes()).hexdigest(),
        "lockstep_checks": trainer.lockstep._seq,
        "lockstep_violations": trainer.lockstep.violations,
        "prefer_native": trainer.memory.prefer_native,
    }


def _job_cli(torch, rank, out_dir, argv):
    """The CLI with the caller's flags (``launch2``)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import main

    t0 = time.perf_counter()
    result = main(argv)
    return {"wall_s": time.perf_counter() - t0, "acc1s": result["acc1s"]}


def _step_losses(trainer) -> list:
    """Wrap the trainer's fused epoch so that every train step's loss lands
    in the returned list (host values, as the epoch fetches them)."""
    losses = []
    run = trainer._run_epoch_fused

    def recorded(*args, **kwargs):
        rows = run(*args, **kwargs)
        losses.extend(float(r["loss"]) for r in rows)
        return rows

    trainer._run_epoch_fused = recorded
    return losses


def _timed(torch, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _tree_bytes(path: str) -> int:
    """A checkpoint's bytes: the file, or a directory's files and its
    ``.meta`` sidecar."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return (sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
            + os.path.getsize(path + ".meta"))


def _job_model_axis(torch, rank, out_dir, argv):
    """The model-axis run at mesh (1, 2) under deterministic cuDNN, with the
    ``orbax`` backend's task checkpoints; then the sharded round trips (an
    ``orbax`` task and epoch checkpoint restored into new trainers at (1,
    2)) and a pickle payload for the 1-rank restore.  The kernel counts are
    zeroed just before ``fit`` and read just after."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import (
        checkpoint as ck,
    )

    _deterministic_cudnn(torch, True)
    ckpt = os.path.join(out_dir, "ma_orbax")
    argv = [*MA_ARGV, "--mesh_data", "1", "--mesh_model", str(DP_RANKS),
            "--ckpt_dir", ckpt, "--ckpt_backend", "orbax"]
    trainer = build_trainer([*argv, "--log_file", os.path.join(out_dir, "ma.jsonl")])
    losses = _step_losses(trainer)
    torch.cuda.synchronize()
    fl.reset_launches()
    t0 = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    out = {"counts": _counts(fl), "steps": trainer.global_step, "losses": losses,
           "captures": trainer.epoch_fn.captures, "wall_s": time.perf_counter() - t0,
           "acc1s": result["acc1s"], "fc_rows": trainer.state.model.fc.weight.shape[0],
           "state": {k: v.detach().cpu().clone()
                     for k, v in trainer.state.model.state_dict().items()}}

    def state(t, teacher=True):
        sd = lambda m: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}  # noqa: E731
        return {"model": sd(t.state.model), "momentum": [m.cpu() for m in t.state.momentum],
                "teacher": sd(t.teacher.model) if teacher else None}

    last = len(result["acc1s"]) - 1
    again = [*argv, "--log_file", os.path.join(out_dir, "again.jsonl")]
    live = state(trainer)
    trips = {}
    for kind in ("task", "epoch"):
        if kind == "task":
            path, save_ms = _timed(torch, ck.save_task_checkpoint, trainer, last)
        else:
            path, save_ms = _timed(torch, ck.save_epoch_checkpoint, trainer, last, 1, 10)
        fresh = build_trainer(again)
        _, restore_ms = _timed(torch, ck.load_task_checkpoint, fresh, path)
        got = state(fresh)
        want = dict(live, momentum=[torch.zeros_like(m) for m in live["momentum"]],
                    teacher=live["model"]) if kind == "task" else live
        equal = (_state_equal(torch, got["model"], want["model"])
                 and _state_equal(torch, got["teacher"], want["teacher"])
                 and all(torch.equal(a, b) for a, b in zip(got["momentum"], want["momentum"])))
        trips[kind] = {"equal": equal, "bytes": _tree_bytes(path), "save_ms": save_ms,
                       "restore_ms": restore_ms, "files": sorted(os.listdir(path))}
        del fresh
    out["orbax"] = trips
    trainer.config = trainer.config.replace(ckpt_backend="pickle",
                                            ckpt_dir=os.path.join(out_dir, "ma_pickle"))
    path, save_ms = _timed(torch, ck.save_task_checkpoint, trainer, last)
    out["pickle"] = {"path": path, "bytes": _tree_bytes(path), "save_ms": save_ms}
    _deterministic_cudnn(torch, False)
    return out


RANK_JOBS = {"step": _job_step, "protocol": _job_protocol, "cli": _job_cli,
             "model_axis": _job_model_axis}


def _rank_main(rank, backend, port, jobs, out_dir, argv):
    """One rank, in a process of its own: join the group, run ``jobs`` in
    order, save each result as ``<job><rank>.pt``."""
    import torch
    import torch.distributed as dist

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
        use_full_f32,
    )

    local = rank if backend == "nccl" else 0
    os.environ.update(WORLD_SIZE=str(DP_RANKS), RANK=str(rank), LOCAL_RANK=str(local))
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(local)
    use_full_f32()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_RANKS, rank=rank)
    try:
        for job in jobs:
            result = RANK_JOBS[job](torch, rank, out_dir, argv)
            torch.save(result, os.path.join(out_dir, f"{job}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch_ranks(torch, jobs, out_dir, argv=()) -> str:
    """Run ``jobs`` at ``DP_RANKS`` ranks, one spawned process each; returns
    the backend.  A rank that fails ends the others and raises here."""
    import torch.multiprocessing as mp

    backend = _dp_backend(torch)
    print(f"[dp] {DP_RANKS} ranks on {min(DP_RANKS, torch.cuda.device_count())} card(s), "
          f"backend {backend}")
    mp.start_processes(_rank_main, args=(backend, _free_port(), list(jobs), out_dir, list(argv)),
                       nprocs=DP_RANKS, join=True, start_method="spawn")
    return backend


def phase_model_axis(torch):
    """The model axis at mesh (1, 2): two ranks (gloo on card 0 with one
    card) each holding 50 of the 100 head rows, against one rank of the same
    seed, both under deterministic cuDNN; then the sharded checkpoints."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import (
        checkpoint as ck,
    )

    with tempfile.TemporaryDirectory() as tmp:
        _deterministic_cudnn(torch, True)
        try:
            one = build_trainer([*MA_ARGV, "--log_file", os.path.join(tmp, "one.jsonl")])
            one_losses = _step_losses(one)
            torch.cuda.synchronize()
            fl.reset_launches()
            one_result = one.fit()
            torch.cuda.synchronize()
            one_counts = _counts(fl)
            one_state = {k: v.detach().cpu().clone()
                         for k, v in one.state.model.state_dict().items()}
        finally:
            _deterministic_cudnn(torch, False)
        _check_counts("the 1-rank model-axis twin", one_counts, one.global_step,
                      one.epoch_fn.captures)
        one_log = [json.loads(ln) for ln in open(os.path.join(tmp, "one.jsonl"))]
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            backend = launch_ranks(torch, ["model_axis"], tmp)
        except Exception as exc:  # noqa: BLE001 - a rank's error, re-raised by spawn
            raise SmokeFailure(f"a model-axis rank failed: {exc}") from exc
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"model_axis{r}.pt")) for r in range(DP_RANKS)]
        logs = [[json.loads(ln) for ln in open(os.path.join(tmp, name))]
                for name in ("ma.jsonl", "ma_p1.jsonl")]
        # The pickle payload written at (1, 2), restored at (1, 1).
        restored = build_trainer([*MA_ARGV, "--log_file", os.path.join(tmp, "restore.jsonl")])
        payload_path = ranks[0]["pickle"]["path"]
        _, restore_ms = _timed(torch, ck.load_task_checkpoint, restored, payload_path)
        ranks[0]["pickle"]["restore_ms"] = restore_ms
        restored_state = {k: v.detach().cpu() for k, v in
                          restored.state.model.state_dict().items()}
        del restored

    run = logs[0][0]
    check(run["mesh"] == {"data": 1, "model": DP_RANKS} and run["processes"] == DP_RANKS
          and run["global_batch"] == 128, f"the model-axis run record {run}")
    for r, out in enumerate(ranks):
        check(out["fc_rows"] == 100 // DP_RANKS, f"rank {r} holds {out['fc_rows']} head rows")
        _check_counts(f"model-axis rank {r}", out["counts"], out["steps"], out["captures"])
        check(out["captures"] == 0 and all(x["graphed"] is False and x["fused"] is True
                                           for x in logs[r] if x["type"] == "epoch"),
              f"model-axis rank {r}: the fused epoch did not run eagerly")
        check(len(out["losses"]) == len(one_losses) and all(
            math.isclose(a, b, rel_tol=1e-4) for a, b in zip(out["losses"], one_losses)),
              f"model-axis rank {r}: step losses off the 1-rank run's by "
              f"{max(abs(a / b - 1) for a, b in zip(out['losses'], one_losses)):.3g}")
    # The two shards are the head; the backbone is replicated.
    full = dict(ranks[0]["state"])
    for name in ("fc.weight", "fc.bias"):
        full[name] = torch.cat([out["state"][name] for out in ranks])
    for name in full:
        if not name.startswith("fc."):
            check(torch.equal(ranks[0]["state"][name], ranks[1]["state"][name]),
                  f"the ranks' {name} differ")
    state_abs, state_over = _state_delta(torch, full, one_state)
    check(state_over <= 0, f"the (1, 2) state is off the 1-rank state by {state_abs:.3g}")
    gammas = [[x["gamma"] for x in log if x["type"] == "task"] for log in logs + [one_log]]
    gamma_delta = max(abs(a - b) for a, b in zip(gammas[0][1:], gammas[2][1:]))
    acc_delta = max(abs(a - b) for a, b in zip(ranks[0]["acc1s"], one_result["acc1s"]))
    check(gammas[0] == gammas[1] and gamma_delta <= 1e-5 and acc_delta <= 1e-4,
          f"gamma {gammas[0]} vs {gammas[2]}, acc1s {ranks[0]['acc1s']} vs "
          f"{one_result['acc1s']}")
    loss_rel = max(abs(a / b - 1) for a, b in zip(ranks[0]["losses"], one_losses))
    bitwise = (loss_rel == 0 and state_abs == 0 and gamma_delta == 0 and acc_delta == 0)
    for r, out in enumerate(ranks):
        for kind, trip in out["orbax"].items():
            check(trip["equal"], f"rank {r}: the orbax {kind} round trip at (1, 2) differs")
    check(ranks[0]["orbax"]["task"]["files"] == [".metadata"] + [
        f"__{r}_0.distcp" for r in range(DP_RANKS)],
          f"the orbax directory holds {ranks[0]['orbax']['task']['files']}")
    check(_state_equal(torch, restored_state, full),
          "the pickle payload saved at (1, 2) did not restore at (1, 1) to the full state")
    epochs = [x for x in logs[0] if x["type"] == "epoch"]
    step_ms = _step_ms(epochs)
    one_step_ms = _step_ms(x for x in one_log if x["type"] == "epoch")
    print(f"[model_axis] mesh (1, {DP_RANKS}) on {backend}, {DP_RANKS} ranks sharing "
          f"{min(DP_RANKS, torch.cuda.device_count())} card(s), {ranks[0]['steps']} eager steps a "
          f"rank: median step {step_ms:.3f} ms (two gloo ranks sharing one card says nothing "
          f"of NCCL), 1-rank graphed twin {one_step_ms:.3f} ms; fit {ranks[0]['wall_s']:.1f} s, "
          f"phase {wall_s:.1f} s [{CARD}]")
    print(f"[model_axis] against the 1-rank run (deterministic cuDNN): step loss rel "
          f"{loss_rel:.3g}, state {state_abs:.3g}, gamma {gamma_delta:.3g}, acc1 "
          f"{acc_delta:.3g}; bitwise {bitwise}; kernels ran {ranks[0]['counts']['ran']} / "
          f"{ranks[1]['counts']['ran']}")
    for kind, trip in ranks[0]["orbax"].items():
        print(f"[model_axis] orbax {kind} checkpoint at (1, {DP_RANKS}): {trip['bytes']} bytes, "
              f"save {trip['save_ms']:.3f} ms, restore {trip['restore_ms']:.3f} ms, bitwise "
              f"[{CARD}]")
    pk = ranks[0]["pickle"]
    print(f"[model_axis] pickle task payload at (1, {DP_RANKS}): {pk['bytes']} bytes, save "
          f"{pk['save_ms']:.3f} ms (the head gathered first), restore at (1, 1) "
          f"{pk['restore_ms']:.3f} ms, equal [{CARD}]")
    return {"backend": backend, "step_ms": step_ms, "one_rank_step_ms": one_step_ms,
            "steps": ranks[0]["steps"], "launches_per_rank": [o["counts"]["ran"] for o in ranks],
            "loss_rel": loss_rel, "state_abs": state_abs, "gamma_delta": gamma_delta,
            "acc1_delta": acc_delta, "bitwise": bitwise,
            "orbax": {k: {x: v[x] for x in ("bytes", "save_ms", "restore_ms")}
                      for k, v in ranks[0]["orbax"].items()},
            "pickle": {x: pk[x] for x in ("bytes", "save_ms", "restore_ms")},
            "wall_s": wall_s, "fit_s": ranks[0]["wall_s"]}


def _write_idx(root, train: bool, x, y) -> None:
    """``x`` uint8 ``[N, 28, 28, 1]`` and ``y`` as the MNIST IDX files."""
    import gzip
    import struct

    import numpy as np

    prefix = "train" if train else "t10k"
    os.makedirs(root, exist_ok=True)
    images = struct.pack(">iiii", 0x803, len(x), 28, 28) + np.ascontiguousarray(x).tobytes()
    labels = struct.pack(">ii", 0x801, len(y)) + np.asarray(y, np.uint8).tobytes()
    for kind, blob in (("images-idx3-ubyte", images), ("labels-idx1-ubyte", labels)):
        with gzip.open(os.path.join(root, f"{prefix}-{kind}.gz"), "wb") as f:
            f.write(blob)


def phase_mnist(torch):
    """The 1-channel family on the card under deterministic cuDNN:
    ``synthetic_mnist`` on resnet20mnist (2 tasks, 5 + 5 classes) fused and
    graphed, and per step: bitwise equal; ``resnet32mnist`` for one task;
    ``--data_set mnist`` on IDX files this phase writes from the same
    images: bitwise the ``synthetic_mnist`` run."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import (
        build_raw_dataset,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        idx = os.path.join(tmp, "MNIST", "raw")
        for train in (True, False):
            (x, y), _ = build_raw_dataset("synthetic_mnist", "", train, 28)
            _write_idx(idx, train, x, y)
        flavours = {
            "fused": MNIST_ARGV, "per_step": [*MNIST_ARGV, "--no_fused_epochs"],
            "resnet32mnist": [*MNIST_ARGV, "--backbone", "resnet32mnist", "--num_bases", "10"],
            "idx": [*MNIST_ARGV, "--data_set", "mnist", "--data_path", tmp],
        }
        _deterministic_cudnn(torch, True)
        try:
            for name, argv in flavours.items():
                log = os.path.join(tmp, f"{name}.jsonl")
                trainer = build_trainer([*argv, "--log_file", log])
                torch.cuda.synchronize()
                fl.reset_launches()
                t0 = time.perf_counter()
                result = trainer.fit()
                torch.cuda.synchronize()
                records = [json.loads(ln) for ln in open(log)]
                epochs = [r for r in records if r["type"] == "epoch"]
                runs[name] = {
                    "result": result, "fit_s": time.perf_counter() - t0,
                    "steps": trainer.global_step, "counts": _counts(fl),
                    "captures": trainer.epoch_fn.captures, "step_ms": _step_ms(epochs),
                    "later_epoch_step_ms": _step_ms(r for r in epochs if r["epoch"] > 1),
                    "graphed": sorted({r["graphed"] for r in epochs}),
                    "gammas": [r["gamma"] for r in records if r["type"] == "task"],
                    "finite": all(math.isfinite(r["loss"]) for r in epochs),
                    "state": {k: v.detach().cpu().clone()
                              for k, v in trainer.state.model.state_dict().items()},
                }
                del trainer
        finally:
            _deterministic_cudnn(torch, False)
    for name, run in runs.items():
        _check_counts(f"mnist {name}", run["counts"], run["steps"], run["captures"])
        check(run["finite"] and run["graphed"] == ([False] if name == "per_step" else [True]),
              f"mnist {name}: finite {run['finite']}, graphed {run['graphed']}")
        check(run["state"]["backbone.conv_1_3x3.weight"].shape[1] == 1,
              f"mnist {name}: the stem does not take one channel")
    ref = runs["fused"]
    for name in ("per_step", "idx"):
        run = runs[name]
        check(run["result"]["acc1s"] == ref["result"]["acc1s"] and run["gammas"] == ref["gammas"]
              and _state_equal(torch, run["state"], ref["state"]),
              f"mnist {name} is not bitwise the fused synthetic_mnist run: acc1s "
              f"{run['result']['acc1s']} vs {ref['result']['acc1s']}")
    check(len(runs["resnet32mnist"]["result"]["acc1s"]) == 1, "resnet32mnist: not one task")
    check(ref["result"]["acc1s"][0] > MNIST_LEARNED,
          f"synthetic_mnist task 0 did not learn: acc1 {ref['result']['acc1s'][0]}")
    for name, run in runs.items():
        print(f"[mnist] {name}: {run['steps']} steps, median step {run['step_ms']:.3f} ms "
              f"(later epochs {run['later_epoch_step_ms']:.3f}), fit "
              f"{run['fit_s']:.2f} s, {run['captures']} captures, kernels ran "
              f"{run['counts']['ran']}, acc1s {[round(a, 3) for a in run['result']['acc1s']]} "
              f"[{CARD}]")
    print("[mnist] fused = per step = the IDX run, bitwise under deterministic cuDNN")
    return {name: {k: run[k] for k in ("steps", "step_ms", "later_epoch_step_ms", "fit_s",
                                       "captures", "counts")}
            for name, run in runs.items()}


def _imagenet_tree(root: str, fixtures: str) -> int:
    """An ImageNet-100 tree under ``root``: ``IMAGENET_CLASSES`` class
    folders of symlinks to the fixtures under distinct names, the fixtures
    taken in turn; returns the number of links."""
    names = sorted(f for f in os.listdir(fixtures) if f.lower().endswith((".jpg", ".jpeg", ".png")))
    k = 0
    for split, per in (("train", IMAGENET_TRAIN), ("val", IMAGENET_VAL)):
        for c in range(IMAGENET_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(per):
                src = names[k % len(names)]
                os.symlink(os.path.join(fixtures, src), os.path.join(d, f"{c:03d}_{i:02d}_{src}"))
                k += 1
    return k


def phase_imagenet(torch, depth: int = 0):
    """The image-folder dataset on the card (``--data_set imagenet1000``):
    the fixtures' decodes on this host (no Pillow here) against the digests
    Pillow and the JAX package gave; a 128-image batch's decode time, train
    and eval at 224 px; then ``IMAGENET_ARGV`` at ``--prefetch_depth
    depth`` on an ImageNet-100 tree through the CLI's trainer: per-step
    epochs, finite losses, each CE kernel one run a step on the card, a
    memory of paths, 10 task records in the CLI's order."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import datasets
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import image_native

    t_phase = time.perf_counter()
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), IMAGENET_FIXTURES)
    want = json.load(open(os.path.join(fixtures, "digests.json")))
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    for name, ref in sorted(want.items()):
        path = os.path.join(fixtures, name)
        one = np.asarray([path], object)
        got = {"full": sha(image_native.decode_full(path)),
               "train_seed0_224": sha(datasets.decode_image_batch(one, 224, True, 0)),
               "eval_224": sha(datasets.decode_image_batch(one, 224, False, 0))}
        check(got == {k: ref[k] for k in got},
              f"the port's decode of {name} on this host differs from Pillow's digests: "
              + ", ".join(k for k in got if got[k] != ref[k]))
    print(f"[imagenet] {len(want)} fixtures: full, train (seed 0) and eval decodes at 224 px "
          "equal Pillow's digests (digests.json)")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "imagenet100")
        links = _imagenet_tree(root, fixtures)
        batch = datasets.load_image_folder(root, True)[0][:128]
        decode = {}
        for mode, train in (("train", True), ("eval", False)):
            times = []
            for rep in range(DECODE_REPS):
                t0 = time.perf_counter()
                out = datasets.decode_image_batch(batch, 224, train, rep)
                times.append(1e3 * (time.perf_counter() - t0))
            check(out.shape == (128, 224, 224, 3), f"decoded batch {out.shape}")
            ms = statistics.median(times)
            decode[mode] = {"ms": ms, "images_per_s": 128 / ms * 1e3, "all_ms": times}
            print(f"[imagenet] decode {mode}: 128 images at 224 px in {ms:.2f} ms (median of "
                  f"{DECODE_REPS}), {128 / ms * 1e3:.0f} images/s on "
                  f"{image_native.THREADS} threads, {os.cpu_count()} cores [{CARD}]")
        log, tel = os.path.join(tmp, "imagenet.jsonl"), os.path.join(tmp, "tel")
        trainer = build_trainer([*IMAGENET_ARGV, "--data_path", root, "--log_file", log,
                                 "--telemetry_dir", tel, "--prefetch_depth", str(depth)])
        torch.cuda.synchronize()
        # The last task's epoch under the profiler: the card's busy ms a
        # step, against the step's wall, says which side bounds the step.
        last = _profile_epoch(torch, trainer, IMAGENET_CLASSES // 10 - 1, 0, "_run_epoch_steps")
        torch.cuda.reset_peak_memory_stats()
        fl.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(fl)
        peak = torch.cuda.max_memory_allocated()
        records = [json.loads(ln) for ln in open(log)]
        files = sorted(os.listdir(tel))
        memory_x = trainer.memory.get()[0]
    steps = trainer.global_step
    _check_counts("imagenet", counts, steps, 0)
    check(last.get("ran") == [last.get("steps")] * 2,
          f"imagenet: the profiled epoch's kernels ran {last.get('ran')} for "
          f"{last.get('steps')} steps")
    busy_ms = last["busy_ms_per_step"]
    wall_ms = last["wall_ms"] / last["steps"]
    epochs = [r for r in records if r["type"] == "epoch"]
    nb_tasks = result["nb_tasks"]
    types = [r["type"] for r in records if r["type"] in CORE_RECORDS]
    want_types = ["run"] + ["epoch", "task", "cil_metrics"] * (IMAGENET_CLASSES // 10) + ["final"]
    check(nb_tasks == 10 and types == want_types, f"imagenet record sequence {types}")
    check(all(r["fused"] is False and r["graphed"] is False for r in epochs),
          "the imagenet epochs are not per-step")
    check(sum(r["steps"] for r in epochs) == steps, "imagenet epoch records miss steps")
    check(all(r.get("prefetch_depth", 0) == depth for r in epochs),
          f"imagenet epochs not at prefetch depth {depth}")
    for r in epochs:
        check(all(math.isfinite(r[k]) for k in ("loss", "ce", "kd", "acc1")),
              f"non-finite metrics in {r}")
    check(memory_x.dtype == object and len(memory_x) > 0
          and all(str(p).startswith(root) for p in memory_x),
          f"the memory does not hold the tree's paths: {memory_x.dtype} {memory_x[:2]}")
    check({"spans.jsonl", "trace.json"} <= set(files), f"imagenet telemetry files {files}")
    step_ms = _step_ms(epochs)
    wall_s = time.perf_counter() - t_phase
    idle = 1.0 - busy_ms / wall_ms
    if depth == 0:
        # The blocking copy's wait for the queued step is the card's: the
        # profiled epoch's stall_frac reads the card's idle share.
        stall = epochs[-1]["stall_frac"]
        check(abs(stall - idle) < 0.10,
              f"imagenet: task 9's stall_frac {stall} against the card's idle share {idle:.4f}")
    for r in epochs:
        print(f"[imagenet depth {depth}] task {r['task_id']}: {r['steps']} steps, host_s "
              f"{r['host_s']:.4f} "
              f"device_s {r['device_s']:.4f} stall_frac {r['stall_frac']:.4f}, loss "
              f"{r['loss']:.4f}")
    print(f"[imagenet depth {depth}] task 9 under the profiler: the card busy {busy_ms:.3f} ms "
          f"a step of {wall_ms:.3f} ms wall ({last['steps']} steps), idle share {idle:.4f}, "
          f"stall_frac {epochs[-1]['stall_frac']:.4f} [{CARD}]")
    print(f"[imagenet depth {depth}] {links} links, {steps} steps, median step {step_ms:.3f} ms at 224 px, "
          f"fit {fit_s:.2f} s, peak HBM {peak} bytes, kernels ran {counts['ran']}, memory "
          f"{len(memory_x)} paths, acc1s {[round(a, 3) for a in result['acc1s']]}, phase "
          f"{wall_s:.1f} s [{CARD}]")
    return {"prefetch_depth": depth,
            "decode": {k: {"ms": v["ms"], "images_per_s": v["images_per_s"]}
                       for k, v in decode.items()},
            "epochs": [{k: r[k] for k in ("task_id", "steps", "host_s", "device_s",
                                          "stall_frac", "epoch_s")} for r in epochs],
            "steps": steps, "step_ms": step_ms, "fit_s": fit_s, "peak_hbm_bytes": peak,
            "last_task_busy_ms": busy_ms, "last_task_wall_ms": wall_ms, "last_task_idle": idle,
            "launches": counts["ran"], "memory": len(memory_x), "wall_s": wall_s,
            "acc1s": result["acc1s"]}


def _step_at(torch, batches, snap, teacher_sd, i, dtype, use_pallas_loss):
    """One 1-rank step on the 128-row batch ``i``, augmented in one process
    with step ``i``'s generator, from the state ``snap`` (in ``dtype``);
    returns the loss and the new state."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
        AugmentConfig, train_augment,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt

    xs, ys = batches
    x = train_augment(xs[i], AugmentConfig(), _aug_generator(torch, i))
    task1 = i >= DP_STEPS // 2
    model = _parity_model(torch, dtype=dtype)
    model.load_state_dict(snap["model"])
    state = tt.TrainState(model, [m.to("cuda", dtype, copy=True) for m in snap["momentum"]],
                          _count(torch, 60 if task1 else 50), _count(torch, 50 if task1 else 0))
    teacher = None
    if task1:
        t_model = _parity_model(torch, dtype=dtype)
        t_model.load_state_dict(teacher_sd)
        teacher = tt.Teacher(t_model.requires_grad_(False), _count(torch, 50))
    m = tt.train_step_on_batch(
        state, teacher, x.to(dtype), ys[i], DP_HP["lr"], DP_HP["lambda_kd"],
        label_smoothing=DP_HP["label_smoothing"], kd_temperature=DP_HP["kd_temperature"],
        momentum=DP_HP["momentum"], weight_decay=DP_HP["weight_decay"],
        use_pallas_loss=use_pallas_loss,
    )
    return float(m["loss"]), state


def _reference_steps(torch, ranks):
    """Each parity step again, at 1 rank on the 128-row batch, from rank 0's
    state before it; returns the largest differences.

    The momentum after a step holds the raw gradient, which f32 rounding
    moves by a few 1e-3 of its norm in the first conv's weights, at 1 rank
    as at 2.  So it is reported, not gated: each f32 step's distance from
    a float64 step from the same state (the kernels take no float64, so
    that one runs the plain loss)."""
    snaps = ranks[0]
    batches = _step_batches(torch)
    worst = {"loss_rel": 0.0, "state_abs": 0.0, "momentum_rel_dp": 0.0,
             "momentum_rel_1rank": 0.0}
    teacher_sd = snaps["after"][DP_STEPS // 2 - 1]["model"]
    for i in range(DP_STEPS):
        before = snaps["before"][i]
        ref_loss, state = _step_at(torch, batches, before, teacher_sd, i, torch.float32, True)
        got = snaps["after"][i]
        for r in ranks:
            check(math.isclose(r["loss"][i], ref_loss, rel_tol=1e-4),
                  f"step {i}: 2-rank loss {r['loss'][i]} vs 1-rank {ref_loss}")
            worst["loss_rel"] = max(worst["loss_rel"], abs(r["loss"][i] / ref_loss - 1))
        for name, ref in state.model.state_dict().items():
            # cuDNN's backward is not deterministic (PERF.md): rtol 1e-3 / atol 1e-4.
            dp, ref = got["model"][name].float(), ref.cpu().float()
            check(torch.allclose(dp, ref, rtol=1e-3, atol=1e-4),
                  f"step {i}: {name} differs by {(dp - ref).abs().max().item()}")
            worst["state_abs"] = max(worst["state_abs"], (dp - ref).abs().max().item())
        _, exact = _step_at(torch, batches, before, teacher_sd, i, torch.float64, False)
        for j, want in enumerate(exact.momentum):
            want = want.cpu()
            for key, m in (("momentum_rel_dp", got["momentum"][j]),
                           ("momentum_rel_1rank", state.momentum[j].cpu())):
                rel = ((m.double() - want).norm() / want.norm()).item()
                worst[key] = max(worst[key], rel)
    return worst


def phase_data_parallel(torch):
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            backend = launch_ranks(torch, ["step", "protocol"], tmp)
        except Exception as exc:  # noqa: BLE001 - a rank's error, re-raised by spawn
            raise SmokeFailure(f"a data-parallel rank failed: {exc}") from exc
        wall_s = time.perf_counter() - t0
        step = [torch.load(os.path.join(tmp, f"step{r}.pt")) for r in range(DP_RANKS)]
        proto = [torch.load(os.path.join(tmp, f"protocol{r}.pt")) for r in range(DP_RANKS)]
        logs = [[json.loads(ln) for ln in open(os.path.join(tmp, name))]
                for name in ("dp.jsonl", "dp_p1.jsonl")]

    # (a) Step parity.
    for r, out in enumerate(step):
        _check_counts(f"rank {r}'s steps", out["counts"], DP_STEPS, 0)
    check(torch.equal(step[0]["final"], step[1]["final"]),
          "the ranks' parameters, buffers and momentum are not bitwise equal")
    worst = _reference_steps(torch, step)
    print(f"[dp] step parity: {DP_STEPS} steps at {DP_RANKS} x {DP_STRIPE[0]} rows vs 1 x "
          f"{DP_STRIPE[0] * DP_RANKS}: max loss rel diff {worst['loss_rel']:.3g}, "
          f"max state abs diff {worst['state_abs']:.3g}; ranks bitwise equal; "
          f"kernels ran {step[0]['counts']['ran']} / {step[1]['counts']['ran']}")
    print(f"[dp] momentum (the raw gradient) against a float64 step, largest relative "
          f"norm of the difference: 2-rank {worst['momentum_rel_dp']:.3g}, 1-rank "
          f"{worst['momentum_rel_1rank']:.3g}")
    sharded = step[0]["sharded"]
    check(all(out["sharded"]["ok"] for out in step),
          f"sharded loss disagrees with its plain version: max |diff| "
          f"{max(out['sharded']['max_abs_err'] for out in step)}")
    sharded["max_abs_err"] = max(out["sharded"]["max_abs_err"] for out in step)
    print(f"[timing] sharded_fused_ce stripe B={DP_STRIPE[0]} W={DP_STRIPE[1]} ({backend}): "
          f"ms={sharded['ms']:.5f} kernel_ms={sharded['kernel_ms']:.5f} "
          f"device_ms={sharded['device_ms']} allreduce_ms={sharded['allreduce_ms']:.5f} "
          f"plain_ms={sharded['plain_ms']:.5f} library_ms={sharded['library_ms']:.5f} "
          f"bound_ms={sharded['bound_ms']:.6f} ({sharded['bound_by']}) [{CARD}]")
    rnd = sharded["round"]
    print(f"[timing] sharded CE round ({backend}): {rnd['launches']:g} kernel launches "
          f"{rnd['kernels']}; collective {rnd['collective']}; copies {rnd['copies']}")
    check(rnd["launches"] == 2,
          f"a sharded CE round launched {rnd['kernels']} (want the forward and the backward)")

    # (b) Protocol, under the lockstep sentinel.
    nb_tasks = 6
    want = ["run"] + ["epoch", "task", "cil_metrics"] * nb_tasks + ["final"]
    for r, recs in enumerate(logs):
        check([x["type"] for x in recs if x["type"] in CORE_RECORDS] == want,
              f"rank {r} record sequence {[x['type'] for x in recs]}")
        check({x["process_index"] for x in recs} == {r}, f"rank {r} log tags")
        units = [x["unit"] for x in recs if x["type"] == "lockstep_fingerprint"]
        check(units.count("train_epoch_fused") == nb_tasks and "eval_step" in units
              and "feature_step" in units
              and not [x for x in recs if x["type"] == "lockstep_violation"],
              f"rank {r}: lockstep fingerprints {len(units)}, or a violation")
    check(proto[0]["lockstep_violations"] == proto[1]["lockstep_violations"] == []
          and proto[0]["lockstep_checks"] == proto[1]["lockstep_checks"] > 0
          and proto[0]["prefer_native"] and proto[1]["prefer_native"],
          f"lockstep {[(p['lockstep_checks'], p['lockstep_violations']) for p in proto]}, "
          f"native {[p['prefer_native'] for p in proto]}")
    recs = logs[0]
    check(recs[0]["mesh"] == {"data": DP_RANKS, "model": 1}
          and recs[0]["global_batch"] == DP_STRIPE[0] * DP_RANKS, f"run record {recs[0]}")
    epochs = [x for x in recs if x["type"] == "epoch"]
    for x in epochs:
        check(all(math.isfinite(x[k]) for k in ("loss", "ce", "kd", "acc1")),
              f"non-finite metrics in {x}")
        check(x["fused"] is True and x["graphed"] is False,
              f"the 2-rank protocol did not run the fused epoch eagerly: {x}")
    gammas = [x["gamma"] for x in recs if x["type"] == "task"]
    check(gammas[0] is None and all(g > 0 for g in gammas[1:]), f"gammas {gammas}")
    for r, out in enumerate(proto):
        _check_counts(f"rank {r}'s protocol", out["counts"], out["steps"], out["captures"])
    check(proto[0]["steps"] == sum(x["steps"] for x in epochs), "epoch records miss steps")
    check(proto[0]["memory"] == proto[1]["memory"], "the ranks herded different memories")
    check(proto[0]["acc1s"] == proto[1]["acc1s"], "the ranks' accuracies differ")
    step_ms = _step_ms(epochs)
    print(f"[dp] protocol: {proto[0]['steps']} train steps a rank in {nb_tasks} tasks on "
          f"{proto[0]['device']} / {proto[1]['device']}, fit {proto[0]['wall_s']:.1f} s, "
          f"phase {wall_s:.1f} s; median step {step_ms:.3f} ms [{CARD}]; kernels ran "
          f"{proto[0]['counts']['ran']} / {proto[1]['counts']['ran']}; memories equal; "
          f"{proto[0]['lockstep_checks']} lockstep checks a rank, no violation")
    print(f"[dp] acc1 per task: {[round(a, 3) for a in proto[0]['acc1s']]}; gammas {gammas}")
    return {"backend": backend, "sharded": sharded, "launches": proto[0]["counts"]["ran"][0],
            "launches_per_rank": [out["counts"]["ran"] for out in proto]}


# --------------------------------------------------------------------------- #
# Durability: checkpoint, kill, resume
# --------------------------------------------------------------------------- #


def durable_child(out: str, argv) -> int:
    """``durable``: one CLI run on the card under deterministic cuDNN; the
    kernel counts are zeroed just before ``fit`` and read just after, and
    the results land in ``out`` only if the run finishes."""
    import torch

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    _deterministic_cudnn(torch, True)
    trainer = build_trainer(argv)
    step0 = trainer.global_step
    torch.cuda.synchronize()
    fl.reset_launches()
    t0 = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    torch.save({
        "counts": _counts(fl), "captures": trainer.epoch_fn.captures, "step0": step0,
        "steps": trainer.global_step - step0, "fit_s": time.perf_counter() - t0,
        "start": [trainer.start_task, trainer.start_epoch],
        "resumed_from": trainer.resumed_from, "result": result,
        "state": {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()},
    }, out)
    return 0


def _run_leg(cmd, cwd, supervisor_log=None):
    """Run one leg to its end within ``DURABLE_LEG_S``; on the deadline,
    kill it and every child the supervisor launched.  Returns the exit code,
    the wall seconds and the output's tail."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DURABLE_LEG_S)
    except subprocess.TimeoutExpired:
        pids = [proc.pid]
        if supervisor_log and os.path.exists(supervisor_log):
            pids += [json.loads(ln).get("pid") for ln in open(supervisor_log)]
        for pid in {p for p in pids if p}:
            try:
                os.killpg(pid, 9)
            except OSError:
                pass
        out, _ = proc.communicate()
        raise SmokeFailure(f"durability leg {cmd[-1]} passed {DURABLE_LEG_S} s: {out[-2000:]}")
    return proc.returncode, time.perf_counter() - t0, out[-3000:]


def _state_equal(torch, a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _state_delta(torch, a, b):
    """The largest |a - b| and the largest violation of rtol 1e-3 / atol 1e-4."""
    worst, over = 0.0, 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        d = (x - y).abs()
        worst = max(worst, d.max().item() if d.numel() else 0.0)
        over = max(over, (d - (1e-4 + 1e-3 * y.abs())).max().item() if d.numel() else -1.0)
    return worst, over


def _round_trip(torch, tmp):
    """(c): save an epoch and a task checkpoint of a trained trainer and
    restore each into a new one; every tensor must come back bitwise."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import StallClock
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import (
        checkpoint as ck,
    )

    ckpt = os.path.join(tmp, "round_trip")
    tr = build_trainer([*DURABLE_ARGV, "--ckpt_dir", ckpt])
    clock = StallClock()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr._lr.fill_(0.1)
    tr._lam.fill_(0.5)
    task0, task1 = tr.scenario_train[0], tr.scenario_train[1]
    tr._grow_state(0, 0, 50)
    tr._run_epoch_steps(0, task0, 0, gen, clock)
    tr.teacher = ck._new_teacher(tr, 50)
    tr._update_memory(0, task0)
    tr.known, tr.acc1s = 50, [12.5]
    tr.matrix.add_row(0, [12.5])
    task1.add_samples(*tr.memory.get())
    tr._grow_state(1, 50, 10)
    tr._run_epoch_steps(1, task1, 0, gen, clock)
    torch.cuda.synchronize()

    def same_memory(a, b):
        return a.keys() == b.keys() and all(
            all(np.array_equal(x, y) for x, y in zip(a[c], b[c])) for c in a)

    new = build_trainer([*DURABLE_ARGV, "--ckpt_dir", ckpt])
    report = {}
    path, save_ms = _timed(torch, ck.save_epoch_checkpoint, tr, 1, 1, 10)
    ok, load_ms = _timed(torch, ck.load_task_checkpoint, new, path)
    report["epoch"] = {"bytes": os.path.getsize(path), "save_ms": save_ms, "restore_ms": load_ms}
    sd = lambda m: m.state_dict()  # noqa: E731
    check(ok and new.resumed_from["kind"] == "epoch"
          and [new.start_task, new.start_epoch] == [1, 1], "epoch restore point")
    check(_state_equal(torch, sd(new.state.model), sd(tr.state.model)),
          "epoch round trip: the model's parameters or buffers differ")
    check(all(torch.equal(a, b) for a, b in zip(new.state.momentum, tr.state.momentum)),
          "epoch round trip: the momentum differs")
    check(_state_equal(torch, sd(new.teacher.model), sd(tr.teacher.model)),
          "epoch round trip: the teacher differs")
    check(same_memory(new.memory._store, tr.memory._store), "epoch round trip: the memory")
    check((new.global_step, new.known, new.acc1s, new.matrix.rows)
          == (tr.global_step, tr.known, tr.acc1s, tr.matrix.rows)
          and torch.equal(new.state.num_active, tr.state.num_active)
          and torch.equal(new.state.known, tr.state.known)
          and torch.equal(new.teacher.known, tr.teacher.known),
          "epoch round trip: the counters differ")
    tr.known = 60
    path, save_ms = _timed(torch, ck.save_task_checkpoint, tr, 1)
    ok, load_ms = _timed(torch, ck.load_task_checkpoint, new, path)
    report["task"] = {"bytes": os.path.getsize(path), "save_ms": save_ms, "restore_ms": load_ms}
    check(ok and new.resumed_from["kind"] == "task" and new.start_task == 2, "task restore point")
    check(_state_equal(torch, sd(new.state.model), sd(tr.state.model))
          and _state_equal(torch, sd(new.teacher.model), sd(tr.state.model)),
          "task round trip: the model or its teacher differs")
    check(all(not m.any() for m in new.state.momentum), "task round trip: momentum not reset")
    check(same_memory(new.memory._store, tr.memory._store) and new.known == 60
          and int(new.state.num_active) == 60, "task round trip: the memory or the counters")
    check(not any("epoch" in n for n in os.listdir(ckpt)), "the task save kept epoch files")
    return report


def phase_durability(torch):
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        legs, events, crash, last_flight = {}, {}, {}, {}
        for name in ("twin", "chaos", "chaos_orbax"):
            out, log = os.path.join(tmp, f"{name}.pt"), os.path.join(tmp, f"{name}.jsonl")
            sup_log = os.path.join(tmp, f"supervisor_{name}.jsonl")
            tel = os.path.join(tmp, f"{name}_tel")
            cmd = [sys.executable, os.path.abspath(__file__), "durable", out, *DURABLE_ARGV,
                   "--ckpt_dir", os.path.join(tmp, f"{name}_ckpt"), "--log_file", log]
            if name != "twin":
                # With a telemetry dir: the injector's on_fatal dumps the
                # flight recorder before the SIGKILL, and the supervisor
                # harvests that dump into crash_report.json before the
                # relaunch writes its own.
                cmd = [sys.executable, os.path.join(here, "scripts", "supervise.py"),
                       "--backoff_base", "0.1", "--backoff_max", "0.5", "--max_failures", "2",
                       "--log", sup_log, "--telemetry_dir", tel, "--", *cmd,
                       "--fault_spec", DURABLE_KILL, "--telemetry_dir", tel]
            if name == "chaos_orbax":
                cmd += ["--ckpt_backend", "orbax"]
            rc, wall_s, tail = _run_leg(cmd, here, sup_log if name != "twin" else None)
            check(rc == 0 and os.path.exists(out), f"durability leg {name} exited {rc}: {tail}")
            legs[name] = torch.load(out)
            legs[name]["wall_s"] = wall_s
            legs[name]["log"] = [json.loads(ln) for ln in open(log)]
            if name != "twin":
                events[name] = [json.loads(ln) for ln in open(sup_log)]
                crash[name] = json.load(open(os.path.join(tel, "crash_report.json")))
                last_flight[name] = json.load(open(os.path.join(tel, "flight_0.json")))
        report = _round_trip(torch, tmp)

    twin, chaos = legs["twin"], legs["chaos"]
    for name, ext in (("chaos", "ckpt"), ("chaos_orbax", "orbax")):
        ev, leg = events[name], legs[name]
        check([e["event"] for e in ev] == ["launch", "exit", "crash_report", "relaunch",
                                           "launch", "exit", "done"]
              and ev[1]["returncode"] == -9
              and [e["cmd"].count("--resume") for e in ev if e["event"] == "launch"] == [0, 1],
              f"{name}: the supervisor's events: {[(e['event'], e.get('returncode')) for e in ev]}")
        check(leg["resumed_from"] is not None and leg["resumed_from"]["kind"] == "epoch"
              and leg["resumed_from"]["path"].endswith(f"task_002_epoch_001.{ext}")
              and leg["start"] == [2, 1],
              f"{name}: the relaunch resumed from {leg['resumed_from']} at {leg['start']}")
    for name, leg in legs.items():
        _check_counts(name, leg["counts"], leg["steps"], leg["captures"])
        check(all(r["fused"] is True and r["graphed"] is True
                  for r in leg["log"] if r["type"] == "epoch"),
              f"{name}: the durability leg did not run the fused, graphed epoch")
    core = [r for r in twin["log"] if r["type"] in CORE_RECORDS]
    types = [r["type"] for r in core]
    cut = next(i for i, r in enumerate(core)
               if r["type"] == "epoch" and (r["task_id"], r["epoch"]) == (2, 1)) + 1
    want = types[:cut] + ["fault_injected", "run", "resume"] + types[cut:]
    for name in ("chaos", "chaos_orbax"):
        leg = legs[name]
        check(leg["step0"] + leg["steps"] == twin["steps"],
              f"{name} steps: {leg['step0']} restored + {leg['steps']} run != {twin['steps']}")
        got = [r["type"] for r in leg["log"] if r["type"] in CORE_RECORDS]
        check(got == want, f"{name} record sequence {got}")
        # The killed child's flight recorder, dumped by the injector's on_fatal.
        dumps = crash[name]["flight_dumps"]
        check(crash[name]["returncode"] == -9 and len(dumps) == 1
              and dumps[0]["reason"] == "fatal"
              and any(e.get("type") == "fault_injected" for e in dumps[0]["events"])
              and last_flight[name]["reason"] == "close",
              f"{name} flight dumps: {[(d['reason'], d['last_open_span']) for d in dumps]}, "
              f"the relaunch's {last_flight[name]['reason']}")
    orbax = legs["chaos_orbax"]
    check(orbax["result"]["acc1s"] == twin["result"]["acc1s"]
          and orbax["result"]["acc_matrix"] == twin["result"]["acc_matrix"]
          and [r["gamma"] for r in orbax["log"] if r["type"] == "task"]
          == [r["gamma"] for r in twin["log"] if r["type"] == "task"]
          and _state_equal(torch, orbax["state"], twin["state"]),
          f"the orbax kill-and-resume is not bitwise its twin: acc1s {orbax['result']['acc1s']} "
          f"vs {twin['result']['acc1s']}, state delta "
          f"{_state_delta(torch, orbax['state'], twin['state'])[0]:.3g}")
    dumps = crash["chaos"]["flight_dumps"]

    gammas = {n: [r["gamma"] for r in leg["log"] if r["type"] == "task"]
              for n, leg in legs.items()}
    rt, cr = twin["result"], chaos["result"]
    bitwise = (rt["acc1s"] == cr["acc1s"] and rt["acc_matrix"] == cr["acc_matrix"]
               and gammas["twin"] == gammas["chaos"]
               and _state_equal(torch, twin["state"], chaos["state"]))
    state_abs, state_over = _state_delta(torch, chaos["state"], twin["state"])
    acc_delta = max(abs(a - b) for a, b in zip(rt["acc1s"], cr["acc1s"]))
    gamma_delta = max(abs(a - b) for a, b in zip(gammas["twin"][1:], gammas["chaos"][1:]))
    deltas = {"bitwise": bitwise, "state_abs": state_abs, "acc1s": acc_delta,
              "gamma": gamma_delta}
    if not bitwise:
        # The fallback the issue of this phase allows: the data-parallel
        # phase's tolerances, printed; the op at fault is named in ROADMAP.
        print(f"[durable] NOT bitwise under deterministic cuDNN: {deltas}")
        check(len(cr["acc1s"]) == len(rt["acc1s"]) and state_over <= 0
              and gamma_delta <= 0.02 and acc_delta <= 0.5,
              f"the resumed run is outside the tolerances: {deltas}")
    print(f"[durable] twin {twin['wall_s']:.1f} s wall (fit {twin['fit_s']:.1f} s, "
          f"{twin['steps']} steps); chaos {chaos['wall_s']:.1f} s wall under the supervisor "
          f"(resumed fit {chaos['fit_s']:.1f} s, {chaos['steps']} steps); the orbax leg "
          f"{orbax['wall_s']:.1f} s wall (resumed fit {orbax['fit_s']:.1f} s) [{CARD}]")
    print(f"[durable] --ckpt_backend orbax: killed at task 2 epoch 1, resumed from "
          f"{os.path.basename(orbax['resumed_from']['path'])}, bitwise equal to the twin; "
          f"kernels ran {orbax['counts']['ran']} times after the resume")
    print(f"[durable] the killed child's flight_0.json: reason {dumps[0]['reason']}, last "
          f"open span {dumps[0]['last_open_span']}, {len(dumps[0]['events'])} events, harvested "
          f"into crash_report.json")
    print(f"[durable] resumed from {os.path.basename(chaos['resumed_from']['path'])} at task "
          f"{chaos['start'][0]}, epoch {chaos['start'][1] + 1}; kernels ran "
          f"{chaos['counts']['ran']} times after the resume (wrapper calls "
          f"{chaos['counts']['calls']}); "
          f"bitwise equal to the twin: {bitwise} (state {state_abs:.3g}, acc1s "
          f"{acc_delta:.3g}, gamma {gamma_delta:.3g})")
    for kind, r in report.items():
        print(f"[durable] {kind} payload {r['bytes']} bytes: save {r['save_ms']:.3f} ms, "
              f"restore {r['restore_ms']:.3f} ms [{CARD}]")
    return {"legs_wall_s": {n: leg["wall_s"] for n, leg in legs.items()},
            "fit_s": {n: leg["fit_s"] for n, leg in legs.items()},
            "steps": {n: leg["steps"] for n, leg in legs.items()},
            "launches_resumed": chaos["counts"]["ran"], "resumed_from": chaos["start"],
            "deltas": deltas, "round_trip": report, "acc1s": cr["acc1s"],
            "gammas": gammas["chaos"]}


# --------------------------------------------------------------------------- #
# Phase 7: serving
# --------------------------------------------------------------------------- #


def _events_ms(torch, fn, n=SERVE_TIMED) -> float:
    """Device ms a call of ``fn``: ``n`` calls between two CUDA events,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _latency_summary(lat_ms, seconds, served, slots) -> dict:
    import numpy as np

    lat = np.asarray(lat_ms, np.float64)
    return {"requests": int(lat.size), "seconds": seconds,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)), "throughput_rps": lat.size / seconds,
            "bucket_occupancy": served / slots if slots else 0.0}


def _window(before: dict, after: dict):
    """Served requests and bucket slots between two ``stats()``."""
    slots = sum(int(b) * (n - before["bucket_counts"].get(b, 0))
                for b, n in after["bucket_counts"].items())
    return after["served"] - before["served"], slots


def _serve_reload(torch, export_dir: str) -> list:
    """(b) Every task's artifact reloaded in this fresh process: its probe
    replays bitwise; per bucket the replayed graph's device ms against the
    loaded module run eagerly, the capture ms, the program's bytes; and the
    served logits of every seen validation slice against the trainer's eval
    (the artifact's model at batch 128 under the trainer's cuDNN settings)."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.config import (
        config_from_args,
        get_args_parser,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import build_scenario
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
        eval_preprocess,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        exact_cuda_numerics,
        load_artifact,
        probe_artifact,
        read_manifest,
        rebuild_model,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.checkpoint import (
        _read_payload,
    )

    scenario_val, _ = build_scenario(
        config_from_args(get_args_parser().parse_args(SERVE_ARGV)), train=False)
    man = read_manifest(export_dir)
    out = []
    for t in sorted(man["artifacts"], key=int):
        path = os.path.join(export_dir, man["artifacts"][t]["path"])
        art = load_artifact(path)
        check(art.device.type == "cuda" and all(r.graph is not None for r in art.runners.values()),
              f"task {t}: the artifact did not load as graphs on the card")
        probe = probe_artifact(art)
        check(probe["ok"] and probe["checked"],
              f"task {t}: the probe did not replay bitwise in a fresh process: {probe}")
        buckets = []
        for b, r in sorted(art.runners.items()):
            replay_ms = _events_ms(torch, r.graph.replay)
            with torch.no_grad(), exact_cuda_numerics():
                eager_ms = _events_ms(torch, lambda: r.module(r._x, r.num_active))
            x = np.random.RandomState(b).randint(0, 256, r.shape).astype(np.uint8)
            t0 = time.perf_counter()
            for _ in range(SERVE_TIMED):
                art.predict_padded(x, b)
            buckets.append({"bucket": b, "replay_ms": replay_ms, "eager_ms": eager_ms,
                            "predict_host_ms": 1e3 * (time.perf_counter() - t0) / SERVE_TIMED,
                            "capture_ms": 1e3 * r.capture_s,
                            "bytes": os.path.getsize(os.path.join(
                                path, art.meta["files"]["exported"][str(b)]))})
        # The trainer's eval of the same weights: batch 128, its cuDNN.
        seen = [scenario_val[j] for j in range(len(scenario_val.increments()))]
        cum, xs = 0, []
        for task, inc in zip(seen, scenario_val.increments()):
            if cum + inc > art.known:
                break
            cum += inc
            xs.append(task.x)
        x = np.concatenate(xs)
        served = art.predict(x)
        model, aug_cfg = rebuild_model(art.meta)
        payload, why = _read_payload(os.path.join(path, "weights.pkl"))
        check(payload is not None, f"task {t}: {why}")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               {**payload["params"], **payload["batch_stats"]}.items()})
        model.cuda()
        na = torch.tensor(art.known, dtype=torch.int32, device="cuda")
        evals = []
        with torch.no_grad():
            for lo in range(0, len(x), 128):
                xb = torch.from_numpy(x[lo:lo + 128]).cuda()
                evals.append(model(eval_preprocess(xb, aug_cfg), na, train=False)[0].cpu())
        trained = torch.cat(evals).numpy()
        k = art.known
        out.append({"task": int(t), "known": k, "load_ms": art.load_ms,
                    "compile_ms": art.compile_ms, "probe": probe,
                    "artifact_bytes": sum(os.path.getsize(os.path.join(path, f))
                                          for f in os.listdir(path)),
                    "buckets": buckets, "eval_images": int(len(x)),
                    "logits_max_abs_vs_train_eval": float(np.max(np.abs(
                        served[:, :k].astype(np.float64) - trained[:, :k]))),
                    "argmax_disagreements": int(np.sum(
                        served[:, :k].argmax(-1) != trained[:, :k].argmax(-1)))})
        del art, model
        torch.cuda.empty_cache()
    return out


def _serve_traffic(torch, export_dir: str, tmp: str) -> dict:
    """(c) One ``InferenceServer`` on the card over a staging directory with
    task 0 and ``swap_ioerror@task1`` armed: closed-loop traffic
    (``SERVE_WORKERS``) with task 1 published 2 s in and kept up at least
    ``SERVE_AFTER_SWAP_S`` after the swap lands, then open-loop traffic at
    ``SERVE_OPEN_RPS``."""
    import shutil
    import threading

    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        InferenceServer,
        register_artifact,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.logging import (
        JsonlLogger,
    )
    from faults.injector import FaultInjector, parse_fault_spec

    stage = os.path.join(tmp, "stage")
    os.makedirs(stage)
    shutil.copytree(os.path.join(export_dir, "task_000"), os.path.join(stage, "task_000"))
    register_artifact(stage, 0, {"path": "task_000"})
    log = os.path.join(tmp, "serve.jsonl")
    sink = JsonlLogger(log)
    inj = FaultInjector(parse_fault_spec("swap_ioerror@task1"),
                        ledger_path=os.path.join(tmp, "ledger.jsonl"), sink=sink)
    images = np.random.RandomState(0).randint(0, 256, (256, 32, 32, 3)).astype(np.uint8)
    server = InferenceServer(stage, max_wait_ms=SERVE_MAX_WAIT_MS, poll_s=0.05, sink=sink,
                             faults=inj).start()
    closed, errors, lock = [], [], threading.Lock()
    stop = threading.Event()

    def worker(k):
        i = k
        while not stop.is_set():
            try:
                res = server.submit(images[i % len(images)]).result(timeout=60)
            except Exception as e:  # noqa: BLE001 — checked empty below
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                closed.append((res["task_id"], res["latency_ms"]))
            i += SERVE_WORKERS

    try:
        s0 = server.stats()
        workers = [threading.Thread(target=worker, args=(k,)) for k in range(SERVE_WORKERS)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        time.sleep(2.0)
        shutil.copytree(os.path.join(export_dir, "task_001"), os.path.join(stage, "task_001"))
        register_artifact(stage, 1, {"path": "task_001"})
        t_pub = time.perf_counter()
        while time.perf_counter() - t_pub < 60 and server.task_id != 1:
            time.sleep(0.01)
        swap_s = time.perf_counter() - t_pub
        # however long the swap's load took, task 1 must answer closed-loop requests
        time.sleep(max(SERVE_AFTER_SWAP_S, SERVE_CLOSED_S - (time.perf_counter() - t0)))
        stop.set()
        for w in workers:
            w.join(timeout=60)
        closed_s = time.perf_counter() - t0
        s1 = server.stats()
        futs = []
        t0 = time.perf_counter()
        for i in range(int(SERVE_OPEN_RPS * SERVE_OPEN_S)):
            time.sleep(max(0.0, t0 + i / SERVE_OPEN_RPS - time.perf_counter()))
            futs.append(server.submit(images[i % len(images)]))
        opened = []
        for f in futs:
            try:
                res = f.result(timeout=60)
                opened.append((res["task_id"], res["latency_ms"]))
            except Exception as e:  # noqa: BLE001 — checked empty below
                errors.append(repr(e))
        open_s = time.perf_counter() - t0
        s2 = server.stats()
    finally:
        stop.set()
        server.stop()
    traces = server.trace_count()
    records = [json.loads(ln) for ln in open(log) if ln.strip()]
    kinds = [r["type"] for r in records]
    swaps = [r for r in records if r["type"] == "serve_swap"]
    swap_trail = [(r["type"], r.get("to_task", r.get("task_id"))) for r in records
                  if r["type"].startswith("serve_swap")]
    check(not errors and s2["failed"] == 0, f"serve: {len(errors)} failed requests: {errors[:3]}")
    check(kinds.count("serve_swap_failed") == 1 and [w["to_task"] for w in swaps] == [0, 1]
          and kinds.index("serve_swap_failed") < kinds.index("serve_swap", 1),
          f"serve: swap records {swap_trail}")
    tasks = [t for t, _ in closed]
    check(tasks[0] == 0 and tasks[-1] == 1 and sorted(set(tasks)) == [0, 1]
          and all(t == 1 for t, _ in opened),
          f"serve: responses did not switch task 0 -> 1 ({sorted(set(tasks))}, open loop "
          f"{sorted({t for t, _ in opened})})")
    check(traces == 0, f"serve: {traces} programs made after load")
    return {"closed_loop": {**_latency_summary([m for _, m in closed], closed_s,
                                               *_window(s0, s1)), "workers": SERVE_WORKERS},
            "open_loop": {**_latency_summary([m for _, m in opened], open_s, *_window(s1, s2)),
                          "rps": SERVE_OPEN_RPS},
            "bucket_counts": s2["bucket_counts"], "swap_s": swap_s,
            "swap_record": swaps[1], "swap_failed": kinds.count("serve_swap_failed"),
            "trace_count": traces, "max_wait_ms": SERVE_MAX_WAIT_MS}


def serve_child(export_dir: str, out: str) -> int:
    """``serve_child``: the serve phase's (b) and (c) in a fresh process;
    results to ``out``."""
    import torch

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
        use_full_f32,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    use_full_f32()  # the trainer's TF32 switches, for its eval side
    with tempfile.TemporaryDirectory() as tmp:
        reload = _serve_reload(torch, export_dir)
        traffic = _serve_traffic(torch, export_dir, tmp)
    with open(out, "w") as f:
        json.dump({"reload": reload, "traffic": traffic}, f)
    return 0


def _get_json(port: int, path: str, timeout: float = 5.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serve_fleet(export_dir: str, tmp: str) -> dict:
    """(d) Two supervised replica subprocesses on card 0 behind the port's
    ``Frontend``: replica 0 dies at its first request (``replica_die``),
    is ejected, relaunched and readmitted; then task 1 is published and the
    rollout refuses once on replica 1 (``swap_ioerror``) and converges."""
    import http.client
    import shutil
    import threading

    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
        Frontend,
        register_artifact,
        stop_supervised_replica,
        supervised_replica_cmd,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving.replica import (
        encode_image,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.logging import (
        JsonlLogger,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    serve_dir, tdir = os.path.join(tmp, "fleet_serve"), os.path.join(tmp, "fleet_tel")
    os.makedirs(serve_dir)
    shutil.copytree(os.path.join(export_dir, "task_000"), os.path.join(serve_dir, "task_000"))
    register_artifact(serve_dir, 0, {"path": "task_000"})
    ports = [_free_port() for _ in FLEET_FAULTS]
    procs, consoles, fe = [], [], None
    results, failures, lock = [], [], threading.Lock()
    stop = threading.Event()
    body = encode_image(np.random.RandomState(1).randint(0, 256, (32, 32, 3)).astype(np.uint8))
    timeline = {}

    def client():
        while not stop.is_set():
            conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60.0)
            try:
                conn.request("POST", "/predict", body=body, headers={
                    "Content-Type": "application/octet-stream", "X-Deadline-Ms": "30000"})
                resp = conn.getresponse()
                payload = resp.read()
                with lock:
                    if resp.status == 200:
                        results.append(int(resp.getheader("X-Task-Id")))
                    else:
                        failures.append((resp.status, payload[:120]))
            except Exception as e:  # noqa: BLE001 — checked empty below
                with lock:
                    failures.append(("exc", repr(e)))
            finally:
                conn.close()

    def wait_for(cond, seconds, what):
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            if cond():
                return
            time.sleep(0.2)
        raise SmokeFailure(f"fleet: {what} within {seconds} s")

    def healthz(i):
        try:
            return _get_json(ports[i], "/healthz")[1]
        except (OSError, ValueError):
            return {}

    t0 = time.perf_counter()
    clients = []
    try:
        for i, spec in enumerate(FLEET_FAULTS):
            os.makedirs(os.path.join(tdir, f"replica_{i}"), exist_ok=True)
            consoles.append(open(os.path.join(tdir, f"replica_{i}", "console.log"), "wb"))
            procs.append(subprocess.Popen(
                supervised_replica_cmd(repo, serve_dir, i, ports[i], tdir, fault_spec=spec,
                                       platform="cuda"),
                cwd=repo, start_new_session=True, stdout=consoles[-1],
                stderr=subprocess.STDOUT))
        wait_for(lambda: all(healthz(i).get("warm") for i in range(len(ports))), 240,
                 "the replicas did not warm up")
        timeline["warm_s"] = time.perf_counter() - t0
        first_pid = healthz(0)["pid"]
        fe_log = os.path.join(tmp, "frontend.jsonl")
        fe = Frontend([("127.0.0.1", p) for p in ports], capacity=64,
                      default_deadline_ms=30000.0, max_attempts=6, retry_backoff_s=0.02,
                      error_threshold=2, probe_s=0.5, export_dir=serve_dir,
                      rollout_poll_s=1.0, sink=JsonlLogger(fe_log)).start()
        clients = [threading.Thread(target=client) for _ in range(FLEET_CLIENTS)]
        for c in clients:
            c.start()
        t1 = time.perf_counter()
        wait_for(lambda: 0 in fe.health.ejected(), 60, "replica 0 was not ejected")
        timeline["eject_s"] = time.perf_counter() - t1
        wait_for(lambda: fe.health.is_healthy(0), 240, "replica 0 was not readmitted")
        timeline["readmit_s"] = time.perf_counter() - t1
        shutil.copytree(os.path.join(export_dir, "task_001"),
                        os.path.join(serve_dir, "task_001"))
        register_artifact(serve_dir, 1, {"path": "task_001"})
        t2 = time.perf_counter()
        wait_for(lambda: all(healthz(i).get("task_id") == 1 for i in range(len(ports))), 180,
                 "the fleet did not converge on task 1")
        timeline["converge_s"] = time.perf_counter() - t2
        time.sleep(1.0)
        stop.set()
        for c in clients:
            c.join(timeout=90)
        stats = [_get_json(p, "/stats")[1] for p in ports]
        relaunched_pid = healthz(0).get("pid")
        fe_stats = fe.stats()
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=90)
        if fe is not None:
            fe.stop()
        for i, proc in enumerate(procs):
            stop_supervised_replica(proc, tdir, i)
        for console in consoles:
            console.close()
    fe_records = [json.loads(ln) for ln in open(fe_log) if ln.strip()]
    ejected = [(r["replica"], r["event"]) for r in fe_records if r["type"] == "replica_ejected"]
    rollbacks = [r for r in fe_records if r["type"] == "serve_rollback"]
    check(not failures, f"fleet: {len(failures)} failed client requests: {failures[:3]}")
    check(ejected == [(0, "eject"), (0, "readmit")], f"fleet: breaker events {ejected}")
    check(len(rollbacks) == 1 and rollbacks[0]["replica"] == 1 and rollbacks[0]["task_id"] == 1,
          f"fleet: rollbacks {rollbacks}")
    check(relaunched_pid != first_pid, "fleet: replica 0 was never relaunched")
    check(all(st["task_id"] == 1 and st["trace_count"] == 0 for st in stats),
          f"fleet: replicas ended on {[(st['task_id'], st['trace_count']) for st in stats]}")
    check(sorted(set(results)) == [0, 1] and results[-1] == 1,
          f"fleet: responses came from tasks {sorted(set(results))}")
    replica_rollbacks = [sum(json.loads(ln)["type"] == "serve_rollback" for ln in open(
        os.path.join(tdir, f"replica_{i}", "run.jsonl")) if ln.strip()) for i in range(len(ports))]
    check(replica_rollbacks == [0, 1], f"fleet: replicas' own serve_rollback {replica_rollbacks}")
    return {"replicas": len(ports), "faults": list(FLEET_FAULTS), "requests": len(results),
            "retries": fe_stats["retries"], "latency_ms": fe_stats["latency_ms"]["high"],
            "rollout_swaps": fe_stats["rollout_swaps"], "breaker": ejected,
            "trace_counts": [st["trace_count"] for st in stats], "timeline_s": timeline}


def gaps(reps: int) -> int:
    """``gaps [reps]``: the main path's recipe with its telemetry (2 epochs
    a task), ``reps`` times; for tasks 2-5 the child spans' coverage and
    every gap between them over 3 ms, with the forced heartbeats and the
    GC pauses inside it (the evidence behind the span gate's margin)."""
    import gc

    import torch

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    pauses, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            pauses.append((time.time(), 1e3 * (time.perf_counter() - started["t"])))

    gc.callbacks.append(on_gc)
    for rep in range(reps):
        with tempfile.TemporaryDirectory() as tmp:
            tel = os.path.join(tmp, "tel")
            trainer = build_trainer([
                *RACE_ARGV, "--batch_size", "128", "--num_epochs", "2",
                "--log_file", os.path.join(tmp, "log.jsonl"), "--telemetry_dir", tel,
                "--heartbeat_path", os.path.join(tmp, "hb", "heartbeat.json"),
                "--recompile_budget"])
            beats, update = [], trainer.telemetry.heartbeat.update

            def timed(force=False, _update=update, **state):
                t0 = time.perf_counter()
                _update(force=force, **state)
                if force:
                    beats.append((time.time(), 1e3 * (time.perf_counter() - t0)))

            trainer.telemetry.heartbeat.update = timed
            pauses.clear()
            trainer.fit()
            spans = [json.loads(ln) for ln in open(os.path.join(tel, "spans.jsonl"))]
        for t in [sp for sp in spans if sp["name"] == "task"][2:]:
            kids = sorted((sp for sp in spans if sp["parent"] == t["span_id"]),
                          key=lambda sp: sp["ts"])
            cur, found = t["ts"], []
            for k in kids + [{"name": "end", "ts": t["ts"] + t["dur_s"], "dur_s": 0.0}]:
                if k["ts"] - cur > 0.003:
                    inside = lambda xs: [round(ms, 2) for ts, ms in xs  # noqa: E731
                                         if cur <= ts <= k["ts"] + 0.001 and ms > 0.5]
                    found.append(f"before {k['name']} {1e3 * (k['ts'] - cur):.1f} ms "
                                 f"(beats {inside(beats)}, gc {inside(pauses)})")
                cur = k["ts"] + k["dur_s"]
            cover = sum(k["dur_s"] for k in kids) / t["dur_s"]
            print(f"[gaps] run {rep} task {t['task']}: {1e3 * t['dur_s']:.0f} ms, children "
                  f"cover {100 * cover:.1f}%; " + "; ".join(found))
    return 0


def imagenet_only(torch, depths) -> int:
    """``imagenet [DEPTH ...]``: the environment (the kernels' build), the
    width timings and the image-folder phase at each ``--prefetch_depth``
    given (default 0)."""
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        CARD = phase_environment(torch)[0]
        widths = phase_widths(torch)
        imagenet = [phase_imagenet(torch, d) for d in depths or [0]]
    except (SmokeFailure, ImportError) as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"imagenet": imagenet, "width_timing": widths, "card": CARD}))
    return 0


def serve_only(torch) -> int:
    """``serve``: the serve phase alone (the kernels build on first use)."""
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
        use_full_f32,
    )

    use_full_f32()
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        serve = phase_serve(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"serve": serve, "card": CARD}))
    return 0


def phase_serve(torch):
    """(a) The main path's recipe at 1 epoch a task with ``--export_dir
    --serve_skew_check``: 6 artifacts, 6 skew records; (b) and (c) in a fresh
    process (``serve_child``); (d) the fleet."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    with tempfile.TemporaryDirectory() as tmp:
        export_dir, log = os.path.join(tmp, "export"), os.path.join(tmp, "serve_train.jsonl")
        trainer = build_trainer([*SERVE_ARGV, "--log_file", log, "--export_dir", export_dir,
                                 "--serve_skew_check", "--serve_buckets",
                                 ",".join(map(str, SERVE_BUCKETS))])
        torch.cuda.synchronize()
        fl.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(fl)
        steps, captures = trainer.global_step, trainer.epoch_fn.captures
        del trainer
        torch.cuda.empty_cache()
        _check_counts("serve phase (a)", counts, steps, captures)
        records = [json.loads(ln) for ln in open(log)]
        exports = [r for r in records if r["type"] == "serve_export"]
        skews = [r for r in records if r["type"] == "serve_skew"]
        check([r["task_id"] for r in exports] == list(range(6))
              and all("error" not in r for r in exports),
              f"serve: export records {exports}")
        check([r["task_id"] for r in skews] == list(range(6)), f"serve: skew records {skews}")
        recompiles = [r for r in records if r["type"].startswith("recompile")]
        check(len(recompiles) == captures and all(
            r["type"] == "recompile" and r["group"] == "train" and r["expected"]
            for r in recompiles), f"serve: the exports moved the train group: {recompiles}")
        for r, s in zip(exports, skews):
            print(f"[serve] task {r['task_id']}: exported {len(SERVE_BUCKETS)} buckets in "
                  f"{r['seconds']} s; skew_abs_max {s['skew_abs_max']} (served "
                  f"{s['served_acc_per_task']}, trained {s['train_acc_per_task']}) [{CARD}]")
        out = os.path.join(tmp, "serve_child.json")
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "serve_child",
                               export_dir, out], capture_output=True, text=True,
                              timeout=SERVE_CHILD_S)
        child_s = time.perf_counter() - t1
        check(proc.returncode == 0, f"serve child exited {proc.returncode}: "
              f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        child = json.load(open(out))
        t2 = time.perf_counter()
        fleet = _serve_fleet(export_dir, tmp)
        fleet_s = time.perf_counter() - t2
    for a in child["reload"]:
        print(f"[serve] reload task {a['task']}: load {a['load_ms']:.1f} ms (captures "
              f"{a['compile_ms']:.1f} ms), {a['artifact_bytes']} bytes, probe bitwise; served "
              f"vs trained eval over {a['eval_images']} images: max |dlogit| "
              f"{a['logits_max_abs_vs_train_eval']:.3g}, {a['argmax_disagreements']} argmax "
              f"disagreements [{CARD}]")
        for b in a["buckets"]:
            print(f"[serve]   bucket {b['bucket']}: replay {b['replay_ms']:.4f} ms, eager "
                  f"{b['eager_ms']:.4f} ms (device), predict_padded {b['predict_host_ms']:.4f} "
                  f"ms (host), capture {b['capture_ms']:.1f} ms, {b['bytes']} bytes")
    tr = child["traffic"]
    for name in ("closed_loop", "open_loop"):
        t = tr[name]
        print(f"[serve] {name}: {t['requests']} requests in {t['seconds']:.2f} s, "
              f"{t['throughput_rps']:.1f} req/s, p50 {t['p50_ms']:.3f} / p95 {t['p95_ms']:.3f} "
              f"/ p99 {t['p99_ms']:.3f} ms, bucket occupancy {t['bucket_occupancy']:.3f} "
              f"[{CARD}]")
    print(f"[serve] hot swap under traffic: 1 injected failure, swapped to task 1 "
          f"{tr['swap_s']:.2f} s after publication (load {tr['swap_record']['load_ms']} ms, "
          f"capture {tr['swap_record']['compile_ms']} ms), no failed request, "
          f"trace_count {tr['trace_count']}; buckets {tr['bucket_counts']}")
    print(f"[serve] fleet: {fleet['requests']} requests, 0 failed, {fleet['retries']} retries, "
          f"breaker {fleet['breaker']}, 1 rollback, trace counts {fleet['trace_counts']}, "
          f"timeline {json.dumps(fleet['timeline_s'])} ({fleet_s:.1f} s) [{CARD}]")
    return {"fit_s": fit_s, "steps": steps, "launches": counts["ran"],
            "exports": [{k: r[k] for k in ("task_id", "seconds", "known")} for r in exports],
            "skew_abs_max": [s["skew_abs_max"] for s in skews], "child_s": child_s,
            "reload": child["reload"], "traffic": tr, "fleet": fleet, "fleet_s": fleet_s,
            "acc1s": result["acc1s"]}


def launch_cli(argv) -> int:
    """``launch2``: the CLI at ``DP_RANKS`` ranks (``--mesh_data 2``, or
    ``--mesh_data 1 --mesh_model 2`` for the model axis)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch_ranks(torch, ["cli"], tmp, argv)
        out = torch.load(os.path.join(tmp, "cli0.pt"))
    print(f"[dp] {DP_RANKS}-rank run: {time.perf_counter() - t0:.2f} s wall "
          f"(fit {out['wall_s']:.2f} s); acc1s {out['acc1s']}")
    return 0


def race(log: str, argv) -> int:
    """``race``: the race recipe (RandAugment, the CUDA kernels, batch 128)
    with the caller's flags under deterministic cuDNN (same-seed runs
    agree), logged to ``log``; prints the card, the wall
    time, the median train step and the average incremental top-1.  With
    ``--init_state <state.pt>`` the model takes that state dict right after
    task 0's head grows (e.g. the JAX package's initial weights for a seed,
    written by ``tests/test_torch_race_init.py save``).  The summary also
    counts task 0's epochs on the plateau (train CE >= ``PLATEAU_CE``) and
    gives each alignment's γ distance from ``RACE_REFERENCE``."""
    import torch

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    argv = list(argv)
    init_state = None
    if "--init_state" in argv:
        i = argv.index("--init_state")
        init_state = argv[i + 1]
        del argv[i:i + 2]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    # Deterministic cuDNN, so that two runs with one seed are one run.
    _deterministic_cudnn(torch, True)
    t0 = time.perf_counter()
    trainer = build_trainer([*RACE_ARGV, "--batch_size", "128", "--log_file", log, *argv])
    if init_state is not None:
        grow = trainer._grow_state

        def grow_then_load(task_id, known, nb_new):
            grow(task_id, known, nb_new)
            if task_id == 0:
                trainer.state.model.load_state_dict(torch.load(init_state))

        trainer._grow_state = grow_then_load
    result = trainer.fit()
    wall_s = time.perf_counter() - t0
    records = [json.loads(ln) for ln in open(log)]
    epochs = [r for r in records if r["type"] == "epoch"]
    gammas = [r["gamma"] for r in records if r["type"] == "task"]
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), RACE_REFERENCE)
    ref = ([r["gamma"] for r in map(json.loads, open(ref_path)) if r["type"] == "task"]
           if os.path.exists(ref_path) else [])
    summary = {
        "log": log, "argv": argv, "init_state": init_state, "card": smi, "wall_s": wall_s,
        # Task 0's epochs on the plateau of the uniform prediction (CE ln 50).
        "task0_plateau_epochs": sum(1 for r in epochs
                                    if r["task_id"] == 0 and r["ce"] >= PLATEAU_CE),
        "gammas": gammas,
        "gamma_deltas": [round(abs(a - b), 6) for a, b in zip(gammas[1:], ref[1:])],
        "graphed": sorted({r["graphed"] for r in epochs}), "captures": trainer.epoch_fn.captures,
        "run_to_final_s": records[-1]["ts"] - records[0]["ts"],
        "steps": sum(r["steps"] for r in epochs),
        "median_step_ms": _step_ms(epochs),
        "avg_incremental_acc1": result["avg_incremental_acc1"], "acc1s": result["acc1s"],
    }
    print(json.dumps({"race": summary}))
    return 0


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "launch2":
        return launch_cli(sys.argv[2:])
    if len(sys.argv) > 2 and sys.argv[1] == "race":
        return race(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "durable":
        return durable_child(sys.argv[2], sys.argv[3:])
    if len(sys.argv) > 3 and sys.argv[1] == "serve_child":
        return serve_child(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        return serve_only(torch)
    if len(sys.argv) > 1 and sys.argv[1] == "imagenet":
        return imagenet_only(torch, [int(a) for a in sys.argv[2:]])
    if len(sys.argv) > 1 and sys.argv[1] == "gaps":
        return gaps(int(sys.argv[2]) if len(sys.argv) > 2 else 2)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    global CARD
    try:
        smi, ptxas = phase_environment(torch)
        CARD = smi
        err = phase_kernels(torch)
        timing = phase_timing(torch)
        widths = phase_widths(torch)
        augment = phase_augment(torch)
        launches = phase_main_path(torch)
        herding = phase_herding(launches)
        precision = phase_precision(torch)
        fused = phase_fused(torch)
        dp = phase_data_parallel(torch)
        model_axis = phase_model_axis(torch)
        mnist = phase_mnist(torch)
        imagenet = phase_imagenet(torch)
        durability = phase_durability(torch)
        serve = phase_serve(torch)
    except (SmokeFailure, ImportError) as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for i, (name, line) in enumerate((("fwd", 47), ("bwd", 72))):
        t = timing[name]
        c = t["cuda"]
        common = {"replaces": f"{JAX_KERNELS}:{line}", "plain_ms": t["plain_ms"],
                  "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                  "library_ms": t["library_ms"], "library_call": t["library_call"],
                  "library_host_us": t["library_host_us"], "shape": list(MAIN_SHAPE)}
        kernels.append({
            "name": f"fused_ce_{name}", "route": "cuda", "source": CUDA_SOURCE,
            "kernel": f"fused_ce_{name}_sm90", "on_path": True, "launches": launches[name],
            "launches_counted_by": "kernel", "wrapper_calls": launches["calls"][i],
            "graphed": True, "launches_in_a_replayed_epoch": {
                "profiler": launches["profiled"][name],
                "steps": launches["profiled"]["steps"],
                "device_ms": launches["profiled"][f"{name}_device_ms"]},
            "max_abs_err": err[name], "ms": c["ms"], "device_ms": c["device_ms"],
            "host_us": c["host_us"], "floor_ms": t["floor"]["device_ms"],
            "floor_spacing_ms": t["floor"]["ms"], "floor_host_us": t["floor"]["host_us"],
            "turns": c["turns"],
            "ptxas": {k: v for k, v in ptxas.items() if f"fused_ce_{name}_sm90" in k},
            **common,
        })
    for name, line in (("fwd", 47), ("bwd", 72)):
        t = timing[name]
        tr = t["triton"]
        kernels.append({
            "name": f"triton_fused_ce_{name}", "route": "triton", "source": TRITON_SOURCE,
            "kernel": f"{name}_kernel", "on_path": False,
            "launches": launches[f"triton_{name}"], "max_abs_err": err[f"triton_{name}"],
            "ms": tr["ms"], "device_ms": tr["device_ms"], "host_us": tr["host_us"],
            "turns": tr["turns"], "replaces": f"{JAX_KERNELS}:{line}",
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": list(MAIN_SHAPE),
        })
    t = dp["sharded"]
    kernels.append({
        "name": "sharded_fused_ce", "route": "cuda", "source": SHARDED_SOURCE,
        "replaces": f"{JAX_KERNELS}:191", "launches": dp["launches"],
        "launches_per_rank": dp["launches_per_rank"], "backend": dp["backend"],
        "shape": list(DP_STRIPE), "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "kernel_ms": t["kernel_ms"], "device_ms": t["device_ms"],
        "allreduce_ms": t["allreduce_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "round_launches": t["round"]["launches"], "round_collective": t["round"]["collective"],
        "round_copies": t["round"]["copies"],
    })
    r = timing["round"]
    print(json.dumps({"ce_round": {
        "shape": list(MAIN_SHAPE), "cuda": r["cuda"], "triton": r["triton"],
        "launches": r["launches"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
        "library_host_us": r["library_host_us"], "library_call": r["library_call"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "floor": r["floor"],
        "main_path_step_ms": launches["step_ms"],
    }}))
    print(json.dumps({"augment": augment, "precision": precision,
                      "main_path_step_ms": launches["step_ms"], "card": smi}))
    print(json.dumps({"durability": durability, "card": smi}))
    print(json.dumps({"fused": fused, "main_path": {k: launches[k] for k in (
        "step_ms", "replay_step_ms", "fit_s", "captures", "profiled", "telemetry")},
        "herding": herding, "card": smi}))
    print(json.dumps({"model_axis": model_axis, "mnist": mnist,
                      "kernel_widths": sorted({w for _, w, _ in GRID + NEW_WIDTHS}),
                      "width_timing": widths, "card": smi}))
    print(json.dumps({"serve": serve, "card": smi}))
    print(json.dumps({"imagenet": imagenet, "card": smi}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
