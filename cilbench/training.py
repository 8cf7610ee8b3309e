"""The training cells' set-up and the port's first steps, followed.

Set-up reaches task ``T`` through the trainer's own boundary calls
(``_grow_state`` for each task, the rehearsal memory's ``add``, a teacher
snapshot as the trainer takes it, the exemplars injected into task T's
set) without training tasks ``0..T-1``: the weights' values do not change
the work.  The exemplars are herded from seeded features.  Then the
benchmark's own weights (``weights.py``) are loaded into the student and
the teacher, and the first steps run through the window's own call,
observed: the augmented batch the student received (a forward pre-hook),
each step's loss as the call returned it, the augmentation's random
draws, the momentum after the first step and the parameters after the
last.  The reference augments the step's uint8 rows itself, on those
draws (``reference/augment.py``), and trains on its own batch."""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights
from .synth import stream_seed

PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"


class StopSteps(Exception):
    """Raised by a wrapper around one of the trainer's calls to end its
    loop there."""


@contextlib.contextmanager
def recording_draws(out: list):
    """While open, every set of augmentation draws the port makes is
    appended to ``out`` as ``{name: tensor}``, on the device and in order.
    A CUDA graph captured meanwhile keeps its draws in the recorded
    tensors: each replay writes its own into them."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment

    orig = augment.draw_params

    def draw(*a, **k):
        d = orig(*a, **k)
        out.append({n: t for n, t in vars(d).items() if t is not None})
        return d

    augment.draw_params = draw
    try:
        yield
    finally:
        augment.draw_params = orig


def port_argv(cfg: dict, data_path: str, seed: int, device: torch.device) -> List[str]:
    argv = [*cfg["argv"], "--data_path", data_path, "--seed", str(int(seed) % (1 << 31))]
    if device.type == "cpu":
        argv += ["--platform", "cpu"]
    return argv


def build(argv: List[str]):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    return build_trainer(argv)


def reach_task(trainer, task: int, seed: int):
    """Grow tasks ``0..task``, fill the memory from seeded features,
    snapshot the teacher after task ``task-1``; returns ``(task_train,
    dataset_val)`` with the exemplars injected."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.train import Teacher

    inc = trainer.scenario_train.increments()
    rng = np.random.Generator(np.random.PCG64(stream_seed(seed, 11)))
    for t in range(task):
        trainer._grow_state(t, trainer.known, inc[t])
        tt = trainer.scenario_train[t]
        feats = rng.standard_normal((len(tt), 64), dtype=np.float32)
        trainer.memory.add(*tt.get_raw_samples(), feats)
        if t == task - 1:
            trainer.teacher = Teacher(
                model=copy.deepcopy(trainer.state.model).requires_grad_(False),
                known=trainer._count(trainer.known + inc[t]))
        trainer.known += inc[t]
    task_train = trainer.scenario_train[task]
    if task > 0:
        task_train.add_samples(*trainer.memory.get())
    trainer._grow_state(task, trainer.known, inc[task])
    return task_train, trainer.scenario_val[: task + 1]


def load_weights(trainer, task: int, seed: int, cfg: dict) -> dict:
    """Load the benchmark's student and teacher weights; returns them and
    the number of student leaves that did not load bitwise (0)."""
    inc = trainer.scenario_train.increments()
    known, active = sum(inc[:task]), sum(inc[:task + 1])
    dev = trainer.device
    student = weights.draw(seed, 1, dev, depth=cfg["depth"], channels=cfg["channels"],
                           width=cfg["head_width"], active=active,
                           input_size=cfg["input_size"], mean=cfg["mean"], std=cfg["std"])
    # The teacher is the student before this task's rows grew, as in WA.
    teacher = (weights.head_rows(student[0], known), student[1]) if task > 0 else None
    trainer.state.model.load_state_dict({**student[0], **student[1]}, strict=True)
    if teacher is not None:
        trainer.teacher.model.load_state_dict({**teacher[0], **teacher[1]}, strict=True)
    got = dict(trainer.state.model.named_parameters())
    bad = sum(not torch.equal(got[k], v) for k, v in student[0].items())
    return {"student": student, "teacher": teacher, "known": known, "active": active,
            "start_mismatch": bad}


def epoch_start(trainer, task: int, epoch: int, gen: torch.Generator) -> None:
    """The loop's per-epoch settings: the cosine lr and the reseeded
    augmentation generator (``engine/loop.py`` ``_fit_task``)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import loop
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.train import cosine_lr
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
        derive_seed,
    )

    cfg = trainer.config
    trainer._lr.fill_(cosine_lr(cfg.lr, epoch, cfg.num_epochs))
    gen.manual_seed(derive_seed(cfg.seed, loop._AUG_STREAM, task, epoch))


class Follow:
    """What the port's first steps produced, kept on the host."""

    def __init__(self, model):
        self.names = [n for n, _ in model.named_parameters()]
        self.fired: List[torch.Tensor] = []
        self._hook = model.register_forward_pre_hook(lambda m, a: self.fired.append(a[0]))
        self.x: List[torch.Tensor] = []
        self.y: List[torch.Tensor] = []
        self.losses: List[float] = []
        self.mom1: Optional[Dict[str, torch.Tensor]] = None
        self.after: Optional[Dict[str, torch.Tensor]] = None
        self.rows: List[np.ndarray] = []  # the uint8 rows a fused step gathered
        self.draws: List[Dict[str, torch.Tensor]] = []  # each step's augmentation draws

    def momentum(self, state) -> None:
        self.mom1 = {n: m.detach().cpu().clone() for n, m in zip(self.names, state.momentum)}

    def finish(self, model) -> None:
        self.after = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        self._hook.remove()
        self.fired = []


def follow_fused(trainer, task: int, n: int, resident, gen, steps: int) -> Follow:
    """Steps ``0..steps-1`` of epoch 0 through the fused epoch function,
    one index row a call (the first call runs the eager step and the
    capture, the later ones replay)."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import epoch_index_table
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.prefetch import to_device
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.train import METRICS

    epoch_start(trainer, task, 0, gen)
    table = epoch_index_table(n, trainer.global_batch_size, trainer._shuffle_seed(task, 0))
    model = trainer.state.model
    f = Follow(model)
    graph_x = None
    drawn: list = []
    for s in range(steps):
        before, d_before = len(f.fired), len(drawn)
        row = to_device(trainer.device, table[s:s + 1])[0]
        with recording_draws(drawn):
            out = trainer.epoch_fn(trainer.state, trainer.teacher, resident[0], resident[1],
                                   row, gen, trainer._lr, trainer._lam)
        new = f.fired[before:]
        if len(new) > 1:
            graph_x = new[-1]  # the captured step's input buffer
        x = new[0] if new else graph_x
        # The eager step's draws, or the captured step's, as this replay wrote them.
        d = drawn[d_before] if len(drawn) > d_before else drawn[-1]
        f.draws.append({k: v.cpu().clone() for k, v in d.items()})
        f.x.append(x.detach().float().cpu())
        f.y.append(resident[1][row[0]].cpu())
        f.rows.append(resident[0][row[0]].cpu().numpy())
        f.losses.append(float(out[0, METRICS.index("loss")]))
        if s == 0:
            f.momentum(trainer.state)
    f.finish(model)
    return f


def plain_batches(f: Follow, cfg: dict, device) -> list:
    """Each followed step's ``(x, labels)`` as the plain reference makes
    it: the step's uint8 rows augmented on the step's draws."""
    from .reference import augment

    return [(augment.train_batch(torch.from_numpy(r).to(device), d, padding=cfg["crop_padding"],
                                 mean=cfg["mean"], std=cfg["std"]), y.to(device))
            for r, d, y in zip(f.rows, f.draws, f.y)]


def reference_numbers(f: Follow, w: dict, cfg: dict, device) -> dict:
    """The plain reference's steps from the benchmark's weights, on the
    followed rows augmented by the plain augmentation, compared with what
    the port produced.  ``aug_mismatch``: values of the batches the
    student received that are not the plain augmentation's."""
    from . import check
    from .reference import resnet

    p0 = w["student"][0]
    rows = cfg["batch_size"]
    short = sum(x.shape[0] != rows or y.shape[0] != rows for x, y in zip(f.x, f.y))
    if short or len(f.x) != len(f.y):
        # A step that did not take the whole batch: nothing to follow.
        inf = float("inf")
        return {"loss_gap": inf, "grad_gap": inf, "delta_gap": inf, "delta_gap_worst": inf,
                "aug_mismatch": inf, "batch_mismatch": short}
    batches = plain_batches(f, cfg, device)
    aug_bad = sum(int((x.to(device) != b[0]).sum()) for x, b in zip(f.x, batches))
    with resnet.numerics(False):
        ref = resnet.wa_steps(p0, w["teacher"], batches, **_step_kw(cfg, w))
    p0c = {k: v.cpu() for k, v in p0.items()}
    grad_prog = {k: f.mom1[k] - cfg["weight_decay"] * p0c[k] for k in p0c}
    delta_prog = {k: f.after[k] - p0c[k] for k in p0c}
    delta_ref = {k: ref["params"][k].cpu() - p0c[k] for k in p0c}
    grad_ref = {k: v.cpu() for k, v in ref["grad1"].items()}
    out = check.training_numbers(f.losses, ref["losses"], grad_prog, grad_ref,
                                 delta_prog, delta_ref)
    out["batch_mismatch"] = 0
    out["aug_mismatch"] = aug_bad
    out["_ref_losses"] = ref["losses"]
    out["_prog_losses"] = list(f.losses)
    return out


def _step_kw(cfg: dict, w: dict) -> dict:
    return dict(lr=cfg["lr"], momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
                lambda_kd=cfg["lambda_kd"], temperature=cfg["kd_temperature"],
                active=w["active"], known=w["known"], depth=cfg["depth"])


def control_numbers(f: Follow, w: dict, cfg: dict, device) -> dict:
    """The control: the reference in TF32 put in the port's place."""
    from . import check
    from .reference import resnet

    batches = plain_batches(f, cfg, device)
    runs = {}
    for tf32 in (False, True):
        with resnet.numerics(tf32):
            runs[tf32] = resnet.wa_steps(w["student"][0], w["teacher"], batches,
                                         **_step_kw(cfg, w))
    p0 = {k: v.cpu() for k, v in w["student"][0].items()}
    r, c = runs[False], runs[True]
    return check.training_numbers(
        c["losses"], r["losses"], {k: v.cpu() for k, v in c["grad1"].items()},
        {k: v.cpu() for k, v in r["grad1"].items()},
        {k: c["params"][k].cpu() - p0[k] for k in p0},
        {k: r["params"][k].cpu() - p0[k] for k in p0})


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()
