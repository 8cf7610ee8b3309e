#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

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
4. A ``{"kernels": [...]}`` line, then the card line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import copy
import json
import math
import os
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
JAX_KERNELS = "a_pytorch_tutorial_to_class_incremental_learning_tpu/ops/fused_loss.py"


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


def phase_timing(torch):
    import torch.nn.functional as F

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import fused_loss as fl

    b, w, active = MAIN_SHAPE
    x, y, na = _inputs(torch, b, w, active, torch.float32, seed=1)
    g = torch.tensor(1.0, device="cuda")
    _, lse = fl.fused_ce_fwd(x, y, na, 0.0)
    logits_bytes = b * w * 4
    fwd_bytes = logits_bytes + b * 8 + 4 + 2 * b * 4      # logits, labels, na -> per, lse
    bwd_bytes = 2 * logits_bytes + b * 8 + 4 + b * 4 + 4  # + lse, g -> dx
    out = {
        "fwd": {
            "ms": _device_ms(torch, lambda: fl.fused_ce_fwd(x, y, na, 0.0)),
            "plain_ms": _device_ms(torch, lambda: fl.fused_ce_fwd_plain(x, y, na, 0.0)),
            "library_ms": _device_ms(torch, lambda: F.cross_entropy(x[:, :active], y)),
            "bytes": fwd_bytes, "ops": 6 * b * w,
        },
        "bwd": {
            "ms": _device_ms(torch, lambda: fl.fused_ce_bwd(x, y, na, lse, g, 0.0)),
            "plain_ms": _device_ms(torch, lambda: fl.fused_ce_bwd_plain(x, y, na, lse, g, 0.0)),
            "library_ms": None,  # no one PyTorch call computes this gradient
            "bytes": bwd_bytes, "ops": 7 * b * w,
        },
    }
    for name, t in out.items():
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops"] / F32_FLOP_PER_S * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[timing] fused_ce_{name} B={b} W={w}: kernel_ms={t['ms']:.5f} "
              f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']} "
              f"bound_ms={t['bound_ms']:.6f} ({t['bound_by']})")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        smi = phase_environment(torch)
        err = phase_kernels(torch)
        timing = phase_timing(torch)
        launches = phase_main_path(torch)
    except (SmokeFailure, ImportError) as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for name, line in (("fwd", 47), ("bwd", 72)):
        t = timing[name]
        kernels.append({
            "name": f"fused_ce_{name}", "route": "triton", "source": KERNEL_SOURCE,
            "replaces": f"{JAX_KERNELS}:{line}", "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
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
