#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py                  # every phase, on one card
    python3 chip_smoke.py launch2 <flags>  # the CLI at 2 data-parallel ranks

Phases, in order; any failure exits non-zero before the result lines:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and Triton versions, and the TF32 switches of the f32 preset.
2. Each kernel against its plain PyTorch version on the card: the fused
   masked-CE forward and backward over the test grid, the train step's shape
   (B=128, W=100, 50 active) and a wide head (B=64, W=5000, 4321 active)
   that runs the column loop, with smoothing 0 / 0.1 and f32 / bf16 logits.
   f32 must agree to rtol 1e-5 / atol 1e-6 (Triton's exp/log and the sum
   order differ from PyTorch's), bf16 outputs to rtol 1e-2 (one bf16 ulp),
   and masked-column gradients must be exactly 0.  Then, at the train
   step's shape, the kernel's time against its plain version, the one
   PyTorch call that computes the same loss, and the card's bound.
3. The main path: the CLI's trainer on the race recipe at full width
   (``synthetic_hard128``, resnet32, 100-wide head, batch 128, B50-inc10, 6
   tasks) cut to 2 epochs a task, with ``--use_pallas_loss``.  Every
   parameter must live on the card, every loss be finite, each kernel be
   launched once per train step, the records come in the CLI's order, and
   the trained model's eval forward on the card agree with the same model
   on the CPU.
4. Data parallel: two ranks started with ``torch.multiprocessing``, on
   ``nccl`` with a card each where there are two cards, else on ``gloo``
   with both ranks on the one card (NCCL refuses two ranks on one device).
   (a) Step parity: resnet32, 100-wide head, 2 x 64 rows (global 128), 3
   steps of task 0 then 3 of task 1 with a teacher, through the sharded
   fused loss; each step is held against the 1-rank step on the 128-row
   batch from the same weights (loss rtol 1e-4; parameters and buffers
   rtol 1e-3 / atol 1e-4, since cuDNN's backward is not deterministic;
   the momentum, the raw gradient, is reported against a float64 step),
   the ranks must end bitwise equal, and each rank must
   launch each kernel once per step.  Then the sharded loss on a (64, 100,
   50) stripe against its plain version over the 128 rows, and its times.
   (b) Protocol: the race recipe at 2 ranks x 64 rows, 1 epoch a task, 6
   tasks, through the CLI's trainer: the record sequence, finite losses,
   γ > 0 after task 0, kernel launches per rank equal to the train steps,
   and the same memory on both ranks.
5. A ``{"kernels": [...]}`` line, then the card line
   ``{"ok": true, "device": {...}}`` last.

Kernel times: ``ms`` from CUDA events between back-to-back launches (the
launch spacing for kernels this small), ``device_ms`` the kernel's own time
from ``torch.profiler`` over the same 100 launches (null where the profiler
shows none).
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
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
KERNEL_SOURCE = f"{PORT}/ops/triton_fused_loss.py"
SHARDED_SOURCE = f"{PORT}/ops/fused_loss.py"
JAX_KERNELS = "a_pytorch_tutorial_to_class_incremental_learning_tpu/ops/fused_loss.py"

DP_RANKS = 2
DP_STRIPE = (64, 100, 50)  # one rank's (B, W, active) in the data-parallel step
DP_STEPS = 6               # 3 of task 0, then 3 of task 1 with a teacher
DP_HP = dict(lr=0.1, lambda_kd=0.5, label_smoothing=0.0, kd_temperature=2.0,
             momentum=0.9, weight_decay=5e-4)
RACE_ARGV = ["--data_set", "synthetic_hard128", "--backbone", "resnet32",
             "--num_bases", "50", "--increment", "10", "--memory_size", "256",
             "--aa", "none", "--color_jitter", "0", "--use_pallas_loss"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------------- #
# Phase 1
# --------------------------------------------------------------------------- #


def phase_environment(torch) -> str:
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
    return smi


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


def phase_kernels(torch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    err = {"fwd": 0.0, "bwd": 0.0}
    for b, w, active in GRID:
        for dtype in (torch.float32, torch.bfloat16):
            for s in (0.0, 0.1):
                x, y, na = _inputs(torch, b, w, active, dtype)
                g = torch.tensor(1.0, device="cuda")
                launches = (fl.FWD_LAUNCHES, fl.BWD_LAUNCHES)
                per, lse = fl.fused_ce_fwd(x, y, na, s)
                torch.cuda.synchronize()
                dx = fl.fused_ce_bwd(x, y, na, lse, g, s)
                torch.cuda.synchronize()
                check((fl.FWD_LAUNCHES, fl.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1),
                      "a CUDA call did not launch its kernel")
                ref_per, ref_lse = fl.fused_ce_fwd_plain(x, y, na, s)
                ref_dx = fl.fused_ce_bwd_plain(x, y, na, ref_lse, g, s)
                tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
                       else dict(rtol=1e-2, atol=1e-5))
                case = f"B={b} W={w} active={active} {str(dtype)[6:]} s={s}"
                for name, got, ref in (("fwd", per, ref_per), ("fwd", lse, ref_lse),
                                       ("bwd", dx, ref_dx)):
                    ok = torch.allclose(got.float(), ref.float(), **tol)
                    check(ok, f"{name} kernel disagrees with its plain version at {case}: "
                              f"max |diff| {(got.float() - ref.float()).abs().max().item()}")
                    if dtype == torch.float32 and (b, w, active) == MAIN_SHAPE:
                        err[name] = max(err[name],
                                        (got.float() - ref.float()).abs().max().item())
                check(bool(torch.all(dx[:, active:] == 0)),
                      f"masked-column gradient is not exactly 0 at {case}")
                check(bool(torch.isfinite(per).all()), f"non-finite loss at {case}")
        print(f"[kernels] B={b} W={w} active={active}: f32+bf16, s=0/0.1 agree")
    return err


def _device_ms(torch, fn, n=100, reps=5):
    """Median device time of one ``fn()`` call in ms: ``n`` calls queued
    behind a sleep kernel so they run back to back on the card, each
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


def _profiled_ms(torch, fn, kernel: str, n=100):
    """The kernel's own device time per launch in ms, from ``torch.profiler``
    over ``n`` launches (its events matched by name); None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += (getattr(evt, "self_device_time_total", None)
                         or getattr(evt, "self_cuda_time_total", 0.0) or 0.0)
    if total_us <= 0:
        print(f"[timing] torch.profiler shows no device time for {kernel}; "
              "device_ms left null")
        return None
    return total_us / n / 1e3


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


def _fwd_bytes(b, w):
    return b * w * 4 + b * 8 + 4 + 2 * b * 4  # logits, labels, na -> per, lse


def phase_timing(torch):
    import torch.nn.functional as F

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    b, w, active = MAIN_SHAPE
    x, y, na = _inputs(torch, b, w, active, torch.float32, seed=1)
    g = torch.tensor(1.0, device="cuda")
    _, lse = fl.fused_ce_fwd(x, y, na, 0.0)
    bwd_bytes = 2 * b * w * 4 + b * 8 + 4 + b * 4 + 4  # + lse, g -> dx
    out = {
        "fwd": {
            "ms": _device_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0)),
            "device_ms": _profiled_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0),
                                      "fwd_kernel"),
            "plain_ms": _device_ms(torch, lambda: fl.fused_ce_fwd_plain(x, y, na, 0.0)),
            "library_ms": _device_ms(torch, lambda: F.cross_entropy(x[:, :active], y)),
            "bytes": _fwd_bytes(b, w), "ops": 6 * b * w,
        },
        "bwd": {
            "ms": _device_ms(torch, lambda: fl.fused_ce_bwd(x, y, na, lse, g, 0.0)),
            "device_ms": _profiled_ms(torch, lambda: fl.fused_ce_bwd(x, y, na, lse, g, 0.0),
                                      "bwd_kernel"),
            "plain_ms": _device_ms(torch, lambda: fl.fused_ce_bwd_plain(x, y, na, lse, g, 0.0)),
            "library_ms": None,  # no one PyTorch call computes this gradient
            "bytes": bwd_bytes, "ops": 7 * b * w,
        },
    }
    for name, t in out.items():
        _bound(t)
        print(f"[timing] fused_ce_{name} B={b} W={w}: kernel_ms={t['ms']:.5f} "
              f"device_ms={t['device_ms']} plain_ms={t['plain_ms']:.5f} "
              f"library_ms={t['library_ms']} bound_ms={t['bound_ms']:.6f} ({t['bound_by']})")
    return out


# --------------------------------------------------------------------------- #
# Phase 3
# --------------------------------------------------------------------------- #


def phase_main_path(torch):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    epochs = 2
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "smoke.jsonl")
        trainer = build_trainer([
            "--data_set", "synthetic_hard128", "--backbone", "resnet32",
            "--num_bases", "50", "--increment", "10", "--batch_size", "128",
            "--memory_size", "256", "--aa", "none", "--color_jitter", "0",
            "--num_epochs", str(epochs), "--use_pallas_loss", "--log_file", log,
        ])
        model = trainer.state.model
        check(model.fc.weight.shape == (100, 64), "the head is not 100 wide")
        off = [n for n, p in model.named_parameters() if p.device.type != "cuda"]
        off += [n for n, t in model.named_buffers() if t.device.type != "cuda"]
        check(not off, f"tensors off the card: {off[:5]}")

        fl.FWD_LAUNCHES = fl.BWD_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"fwd": fl.FWD_LAUNCHES, "bwd": fl.BWD_LAUNCHES}
        records = [json.loads(ln) for ln in open(log)]

    steps = trainer.global_step
    check(steps > 0 and launches["fwd"] == launches["bwd"] == steps,
          f"kernel launches {launches} != train steps {steps}")
    types = [r["type"] for r in records]
    nb_tasks = result["nb_tasks"]
    want = ["run"] + (["epoch"] * epochs + ["task", "cil_metrics"]) * nb_tasks + ["final"]
    check(nb_tasks == 6 and types == want, f"record sequence {types}")
    epochs_rec = [r for r in records if r["type"] == "epoch"]
    check(sum(r["steps"] for r in epochs_rec) == steps, "epoch records miss steps")
    for r in epochs_rec:
        check(all(math.isfinite(r[k]) for k in ("loss", "ce", "kd", "acc1")),
              f"non-finite metrics in {r}")
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

    step_ms = statistics.median(
        1e3 * (r["host_s"] + r["device_s"]) / r["steps"] for r in epochs_rec
    )
    print(f"[main] {steps} train steps in {nb_tasks} tasks, {wall_s:.1f} s wall; "
          f"median step {step_ms:.3f} ms; launches {launches}")
    print(f"[main] acc1 per task: {[round(a, 3) for a in result['acc1s']]}")
    print(f"[main] gammas: {[t['gamma'] for t in tasks]}")
    return launches


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
    """The parity steps' global batches of 128 rows, the same in every
    process: ``synthetic_hard128`` images, normalized, labels among the 50
    classes of task 0 for the first 3 steps, then among 60.  Real images,
    not noise: on noise the first conv's weight gradient is a sum of
    terms with random signs, which a coherent 1e-6 change in a BN
    statistic moves by ~1e-3 of its size."""
    import numpy as np

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import (
        build_raw_dataset,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
        AugmentConfig, eval_preprocess,
    )

    (x, y), _ = build_raw_dataset("synthetic_hard128", "", True)
    rows = DP_STRIPE[0] * DP_RANKS
    half = DP_STEPS // 2 * rows
    idx = np.concatenate([np.flatnonzero(y < 50)[:half], np.flatnonzero(y < 60)[-half:]])
    xs = eval_preprocess(torch.from_numpy(x[idx]).cuda(), AugmentConfig())
    ys = torch.from_numpy(y[idx]).cuda()
    return xs.reshape(DP_STEPS, rows, *xs.shape[1:]), ys.reshape(DP_STEPS, rows)


def _parity_model(torch, axis=None):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import create_model

    return create_model("resnet32", 100, seed=5, axis=axis).cuda()


def _job_step(torch, rank, out_dir, argv):
    """Six train steps at 2 ranks x 64 rows through the sharded fused loss,
    with rank 0's state before and after each step; then the sharded loss
    on one stripe against its plain version, and its times."""
    import torch.distributed as dist

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import grow
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
        broadcast_module, data_axis,
    )

    axis = data_axis((DP_RANKS, 1))
    model = _parity_model(torch, axis)
    broadcast_module(model, axis.group)
    xs, ys = _step_batches(torch)
    b = DP_STRIPE[0]
    rows = slice(rank * b, (rank + 1) * b)
    state = tt.TrainState(model, tt.sgd_init(model.parameters()), _count(torch, 50),
                          _count(torch, 0))
    teacher = None
    out = {"before": [], "after": [], "loss": []}
    fl.FWD_LAUNCHES = fl.BWD_LAUNCHES = 0
    for i in range(DP_STEPS):
        if i == DP_STEPS // 2:  # task 1: teacher snapshot, head growth, fresh SGD
            teacher = tt.Teacher(copy.deepcopy(model).requires_grad_(False), _count(torch, 50))
            grow(model, torch.Generator().manual_seed(12), 50, 10)
            state.momentum = tt.sgd_init(model.parameters())
            state.num_active, state.known = _count(torch, 60), _count(torch, 50)
        if rank == 0:
            out["before"].append(_snapshot(state))
        m = tt.train_step_on_batch(
            state, teacher, xs[i][rows], ys[i][rows], DP_HP["lr"], DP_HP["lambda_kd"],
            label_smoothing=DP_HP["label_smoothing"], kd_temperature=DP_HP["kd_temperature"],
            momentum=DP_HP["momentum"], weight_decay=DP_HP["weight_decay"],
            use_pallas_loss=True, group=axis.group,
        )
        out["loss"].append(float(m["loss"]))
        if rank == 0:
            out["after"].append(_snapshot(state))
    torch.cuda.synchronize()
    out["launches"] = [fl.FWD_LAUNCHES, fl.BWD_LAUNCHES]
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
    per, lse = fl.fused_ce_fwd_plain(full_x, full_y, na, 0.0)
    ref_dx = fl.fused_ce_bwd_plain(full_x, full_y, na, lse, torch.tensor(1.0, device="cuda"),
                                   0.0)[rows]
    err = max((loss - per.mean()).abs().item(), (dx - ref_dx).abs().max().item())
    ok = (torch.allclose(loss, per.mean(), rtol=1e-5, atol=1e-6)
          and torch.allclose(dx, ref_dx, rtol=1e-5, atol=1e-6)
          and bool(torch.all(dx[:, active:] == 0)))
    t = {"max_abs_err": err, "ok": ok, "bytes": _fwd_bytes(b, w), "ops": 6 * b * w}
    if axis.rank == 0:
        t["kernel_ms"] = _device_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0))
        t["device_ms"] = _profiled_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0),
                                      "fwd_kernel")
        t["library_ms"] = _device_ms(torch, lambda: F.cross_entropy(x[:, :active], y))
    dist.barrier()
    scalar = torch.zeros((), device="cuda")

    def plain():
        total = fl.fused_ce_fwd_plain(x, y, na, 0.0)[0].sum()
        dist.all_reduce(total, group=axis.group)
        return total / (b * axis.size)

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
    ])
    fl.FWD_LAUNCHES = fl.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    mx, my = trainer.memory.get()[:2]
    return {
        "launches": [fl.FWD_LAUNCHES, fl.BWD_LAUNCHES], "steps": trainer.global_step,
        "wall_s": time.perf_counter() - t0, "acc1s": result["acc1s"],
        "device": str(trainer.device),
        "memory": hashlib.sha256(mx.tobytes() + my.tobytes()).hexdigest(),
    }


def _job_cli(torch, rank, out_dir, argv):
    """The CLI with the caller's flags (``launch2``)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import main

    t0 = time.perf_counter()
    result = main(argv)
    return {"wall_s": time.perf_counter() - t0, "acc1s": result["acc1s"]}


RANK_JOBS = {"step": _job_step, "protocol": _job_protocol, "cli": _job_cli}


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


def _step_at(torch, batches, snap, teacher_sd, i, dtype, use_pallas_loss):
    """One 1-rank step on the 128-row batch ``i`` from the state ``snap``
    (in ``dtype``); returns the loss and the new state."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt

    xs, ys = batches
    task1 = i >= DP_STEPS // 2
    model = _parity_model(torch).to(dtype)
    model.load_state_dict(snap["model"])
    state = tt.TrainState(model, [m.cuda().to(dtype) for m in snap["momentum"]],
                          _count(torch, 60 if task1 else 50), _count(torch, 50 if task1 else 0))
    teacher = None
    if task1:
        t_model = _parity_model(torch).to(dtype)
        t_model.load_state_dict(teacher_sd)
        teacher = tt.Teacher(t_model.requires_grad_(False), _count(torch, 50))
    m = tt.train_step_on_batch(
        state, teacher, xs[i].to(dtype), ys[i], DP_HP["lr"], DP_HP["lambda_kd"],
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
        check(out["launches"] == [DP_STEPS, DP_STEPS],
              f"rank {r}: kernel launches {out['launches']} != {DP_STEPS} steps")
    check(torch.equal(step[0]["final"], step[1]["final"]),
          "the ranks' parameters, buffers and momentum are not bitwise equal")
    worst = _reference_steps(torch, step)
    print(f"[dp] step parity: {DP_STEPS} steps at {DP_RANKS} x {DP_STRIPE[0]} rows vs 1 x "
          f"{DP_STRIPE[0] * DP_RANKS}: max loss rel diff {worst['loss_rel']:.3g}, "
          f"max state abs diff {worst['state_abs']:.3g}; ranks bitwise equal; "
          f"launches {step[0]['launches']} / {step[1]['launches']}")
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
          f"bound_ms={sharded['bound_ms']:.6f} ({sharded['bound_by']})")

    # (b) Protocol.
    nb_tasks = 6
    want = ["run"] + ["epoch", "task", "cil_metrics"] * nb_tasks + ["final"]
    for r, recs in enumerate(logs):
        check([x["type"] for x in recs] == want,
              f"rank {r} record sequence {[x['type'] for x in recs]}")
        check({x["process_index"] for x in recs} == {r}, f"rank {r} log tags")
    recs = logs[0]
    check(recs[0]["mesh"] == {"data": DP_RANKS, "model": 1}
          and recs[0]["global_batch"] == DP_STRIPE[0] * DP_RANKS, f"run record {recs[0]}")
    epochs = [x for x in recs if x["type"] == "epoch"]
    for x in epochs:
        check(all(math.isfinite(x[k]) for k in ("loss", "ce", "kd", "acc1")),
              f"non-finite metrics in {x}")
    gammas = [x["gamma"] for x in recs if x["type"] == "task"]
    check(gammas[0] is None and all(g > 0 for g in gammas[1:]), f"gammas {gammas}")
    for r, out in enumerate(proto):
        check(out["steps"] > 0 and out["launches"] == [out["steps"]] * 2,
              f"rank {r}: kernel launches {out['launches']} != train steps {out['steps']}")
    check(proto[0]["steps"] == sum(x["steps"] for x in epochs), "epoch records miss steps")
    check(proto[0]["memory"] == proto[1]["memory"], "the ranks herded different memories")
    check(proto[0]["acc1s"] == proto[1]["acc1s"], "the ranks' accuracies differ")
    step_ms = statistics.median(1e3 * (x["host_s"] + x["device_s"]) / x["steps"] for x in epochs)
    print(f"[dp] protocol: {proto[0]['steps']} train steps a rank in {nb_tasks} tasks on "
          f"{proto[0]['device']} / {proto[1]['device']}, fit {proto[0]['wall_s']:.1f} s, "
          f"phase {wall_s:.1f} s; median step {step_ms:.3f} ms; launches "
          f"{proto[0]['launches']} / {proto[1]['launches']}; memories equal")
    print(f"[dp] acc1 per task: {[round(a, 3) for a in proto[0]['acc1s']]}; gammas {gammas}")
    return {"backend": backend, "sharded": sharded, "launches": proto[0]["launches"][0],
            "launches_per_rank": [out["launches"] for out in proto]}


def launch_cli(argv) -> int:
    """``launch2``: the CLI at ``DP_RANKS`` data-parallel ranks."""
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


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "launch2":
        return launch_cli(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        smi = phase_environment(torch)
        err = phase_kernels(torch)
        timing = phase_timing(torch)
        launches = phase_main_path(torch)
        dp = phase_data_parallel(torch)
    except (SmokeFailure, ImportError) as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for name, line in (("fwd", 47), ("bwd", 72)):
        t = timing[name]
        kernels.append({
            "name": f"fused_ce_{name}", "route": "triton", "source": KERNEL_SOURCE,
            "replaces": f"{JAX_KERNELS}:{line}", "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    t = dp["sharded"]
    kernels.append({
        "name": "sharded_fused_ce", "route": "triton", "source": SHARDED_SOURCE,
        "replaces": f"{JAX_KERNELS}:191", "launches": dp["launches"],
        "launches_per_rank": dp["launches_per_rank"], "backend": dp["backend"],
        "shape": list(DP_STRIPE), "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "kernel_ms": t["kernel_ms"], "device_ms": t["device_ms"],
        "allreduce_ms": t["allreduce_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
