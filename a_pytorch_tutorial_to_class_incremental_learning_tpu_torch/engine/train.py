"""Train, eval and feature steps, and the torch-semantics SGD.

Counterpart of the JAX package's ``engine/train.py``.  One train step is:
augment on the device -> student forward (train mode, BN running stats
updated) -> masked CE, through the fused kernel with ``use_pallas_loss`` ->
teacher forward (eval mode, no grad) + λ·KD -> backward -> SGD.  Step
metrics stay on the device; the loop fetches them once per epoch.
``make_epoch_fn`` runs an epoch of these steps on a dataset held on the
device (JAX ``make_epoch_fn``), replaying one captured CUDA graph a step
on CUDA at one rank; :class:`FeatureStep` runs herding's feature pass over
such a dataset, replaying one captured graph a batch.

Precision: the model carries its policy (``ops/precision.py``) and casts at
the JAX package's cast points; the logits, the losses, the parameters, the
momentum and the gradient all-reduce stay f32 under every preset.  The
fused loss kernel runs only under a preset it is registered for
(``kernel_policy_compatible``); any other combination raises, where the
JAX package would fall back to the plain loss.

Data parallel (``group``, the process group of the data axis): each rank
holds a stripe of the global batch and its loss terms are its *shares* of
the global-batch loss (local mean / N); the masked CE with
``use_pallas_loss`` goes through ``sharded_fused_masked_cross_entropy``.
The parameter gradients are then summed over the data axis in one
all-reduce of a flat buffer, the JAX convention for replicated parameters
(the sum of the per-shard contributions), and every rank takes the same SGD
step.  The model is not wrapped in ``DistributedDataParallel``: its reducer
hooks do not fire under ``torch.autograd.grad``, the head grows in place
every task, and it averages where this convention sums.

Model axis: the ranks of one data index step the same stripe; the model
gathers its head shards into the full head for the forward
(``parallel/mesh.py`` ``gather_rows``), so the loss, the kernels' full-width
rows and the feature gradient are the same on each, and each rank's head
gradient is its rows of the unsharded one.  The data-axis all-reduce then
covers the backbone and the head shard alike.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, fields
from typing import Callable, ContextManager, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data import augment
from ..data.augment import AugmentConfig, eval_preprocess, train_augment
from ..models import CilModel
from ..ops import fused_masked_cross_entropy, sharded_fused_masked_cross_entropy
from ..ops.precision import Policy, kernel_policy_compatible
from ..parallel.mesh import DataAxis, all_reduce_sum
from ..telemetry.compilewatch import CompileWatch
from .losses import accuracy, cross_entropy, soft_target_kd, topk_correct

Scalar = Union[float, torch.Tensor]
# The train step's metrics, in the order of the fused epoch's rows.
METRICS = ("acc1", "acc5", "ce", "kd", "loss")


@dataclass
class TrainState:
    """The student and its optimizer state.  ``num_active`` and ``known``
    are 1-element int32 tensors on the model's device, so masking and the
    kernels read them without a host sync."""

    model: CilModel
    momentum: List[torch.Tensor]  # SGD velocity, one per parameter
    num_active: torch.Tensor
    known: torch.Tensor


@dataclass
class Teacher:
    """Frozen previous-task model: a deep copy of the student, run in eval
    mode inside the student's step."""

    model: CilModel
    known: torch.Tensor


def sgd_init(params) -> List[torch.Tensor]:
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_update(
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    momentum_buf: List[torch.Tensor],
    lr: Scalar,
    momentum: float,
    weight_decay: float,
    frozen: Optional[Sequence[bool]] = None,
) -> None:
    """torch.optim.SGD (dampening 0, no Nesterov), in place, in the JAX
    package's order: ``buf = m·buf + g + wd·p;  p = p - lr·buf``.  ``lr``
    may be a 0-d tensor on the parameters' device (a captured step reads it
    at each replay) or a float.  ``frozen`` (one flag a parameter,
    ``models.freeze_mask``'s values) is JAX's mask: a frozen parameter gets
    no update and its momentum buffer stays zero."""
    if frozen is not None:
        for buf, f in zip(momentum_buf, frozen):
            if f:
                buf.zero_()
        live = [i for i, f in enumerate(frozen) if not f]
        params, grads, momentum_buf = ([xs[i] for i in live]
                                       for xs in (params, grads, momentum_buf))
        if not live:
            return
    torch._foreach_mul_(momentum_buf, momentum)
    torch._foreach_add_(momentum_buf, grads)
    torch._foreach_add_(momentum_buf, params, alpha=weight_decay)
    torch._foreach_sub_(params, torch._foreach_mul(momentum_buf, lr))


def cosine_lr(base_lr: float, epoch: int, num_epochs: int) -> float:
    """``CosineAnnealingLR(T_max=num_epochs)`` stepped per epoch."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / num_epochs))


LOSS_KERNEL = "fused_masked_cross_entropy"


def require_loss_kernel(policy: Policy) -> None:
    """Raise unless the fused loss kernel is registered for ``policy``."""
    if not kernel_policy_compatible(LOSS_KERNEL, policy):
        raise ValueError(
            f"{LOSS_KERNEL} is not registered for the {policy.name!r} precision "
            "policy (ops/precision.register_policy_kernel); run without "
            "--use_pallas_loss or with a registered preset"
        )


def train_step_on_batch(
    state: TrainState,
    teacher: Optional[Teacher],
    x: torch.Tensor,
    labels: torch.Tensor,
    lr: Scalar,
    lambda_kd: Scalar,
    *,
    label_smoothing: float,
    kd_temperature: float,
    momentum: float,
    weight_decay: float,
    use_pallas_loss: bool = False,
    group=None,
) -> Dict[str, torch.Tensor]:
    """One step on an already augmented, normalized NHWC batch ``x``: this
    rank's stripe of the global batch when ``group`` is given.  The metrics
    are the global batch's on every rank.  ``lr`` and ``lambda_kd`` are 0-d
    tensors on the model's device in the loop (floats are accepted too).
    """
    model = state.model
    if use_pallas_loss:
        require_loss_kernel(model.policy)
    params = list(model.parameters())
    logits, _ = model(x, state.num_active, train=True)
    if use_pallas_loss and group is not None:
        # The value is the global mean already (a pmean); its gradient is
        # the share's.
        ce = sharded_fused_masked_cross_entropy(
            group, logits, labels, state.num_active, label_smoothing
        )
        ce_share = ce.detach() / dist.get_world_size(group)
    else:
        if use_pallas_loss:
            ce = fused_masked_cross_entropy(logits, labels, state.num_active, label_smoothing)
        else:
            ce = cross_entropy(logits, labels, state.num_active, label_smoothing, group=group)
        ce_share = ce.detach()
    if teacher is not None:
        with torch.no_grad():
            t_logits, _ = teacher.model(x, teacher.known, train=False)
        kd = lambda_kd * soft_target_kd(logits, t_logits, state.known, kd_temperature,
                                        group=group)
    else:
        kd = torch.zeros((), device=logits.device)
    grads = list(torch.autograd.grad(ce + kd, params))
    if group is not None:
        grads = all_reduce_sum(grads, group)
    sgd_update(params, grads, state.momentum, lr, momentum, weight_decay)
    acc1, acc5 = accuracy(logits.detach(), labels, topk=(1, 5), group=group)
    shares = torch.stack([ce_share, kd.detach(), acc1, acc5])
    if group is not None:
        dist.all_reduce(shares, group=group)
    ce, kd, acc1, acc5 = shares.unbind()
    return {"ce": ce, "kd": kd, "loss": ce + kd, "acc1": acc1, "acc5": acc5}


def make_train_step(
    aug_cfg: AugmentConfig,
    policy: Policy,
    label_smoothing: float,
    kd_temperature: float,
    momentum: float,
    weight_decay: float,
    use_pallas_loss: bool = False,
    axis: Optional[DataAxis] = None,
):
    """``step(state, teacher, x_u8, labels, generator, lr, lambda_kd) ->
    metrics``: augment with ``generator``, then :func:`train_step_on_batch`;
    on a sharded ``axis``, ``x_u8`` is this rank's stripe.  With
    ``use_pallas_loss``, the run's ``policy`` must be one the kernel is
    registered for (checked here, and at each step against the model's)."""
    axis = axis or DataAxis()
    if use_pallas_loss:
        require_loss_kernel(policy)

    def step(state, teacher, x_u8, labels, generator, lr, lambda_kd):
        x = train_augment(x_u8, aug_cfg, generator, axis.rank, axis.size)
        return train_step_on_batch(
            state, teacher, x, labels, lr, lambda_kd,
            label_smoothing=label_smoothing, kd_temperature=kd_temperature,
            momentum=momentum, weight_decay=weight_decay,
            use_pallas_loss=use_pallas_loss, group=axis.group,
        )

    return step


class EpochFn:
    """One epoch of train steps over a task's dataset held on the device;
    built by :func:`make_epoch_fn`.  ``captures`` counts the CUDA graphs
    captured so far; :meth:`_cache_size` gives it to the telemetry's
    ``RecompileMonitor`` as JAX's jitted functions give their cache size,
    and each capture is priced in ``telemetry.compilewatch``.  ``span(name)``
    gives the context manager the capture runs in (the trainer's
    ``Telemetry.span``): its ``capture`` region opens before the eager first
    step and closes after the graph's capture block has exited."""

    def __init__(self, step, axis: DataAxis, graphed: bool,
                 span: Callable[[str], ContextManager] = contextlib.nullcontext):
        self._step = step
        self._axis = axis
        self.graphed = graphed
        self._span = span
        self.captures = 0
        self._graph = None
        self._idx = None  # the static index row the captured gather reads
        self._out = None  # the captured step's metrics vector

    def reset(self) -> None:
        """Drop the captured step and free its memory: the next call runs
        its first step eagerly and captures anew.  A graph replays against
        the tensors it was captured with, so the caller resets wherever it
        rebinds one of them (a new task's grown head and momentum, teacher,
        dataset or generator); writing into them in place (``fill_``,
        ``copy_``, ``manual_seed``) needs no reset."""
        self._graph = self._out = self._idx = None

    def _cache_size(self) -> int:
        """The programs this function compiled: the CUDA graphs captured so
        far (0 on the CPU and at N > 1 ranks, where steps run eagerly)."""
        return self.captures

    def _run_step(self, state, teacher, data_x, data_y, idx, generator, lr, lambda_kd):
        m = self._step(state, teacher, data_x[idx], data_y[idx], generator, lr, lambda_kd)
        return torch.stack([m[k] for k in METRICS])

    def _capture(self, state, teacher, data_x, data_y, generator, lr, lambda_kd) -> None:
        """Capture one step into a CUDA graph on the capture stream (which
        runs nothing) and keep it for the replays."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
            out = self._run_step(state, teacher, data_x, data_y, self._idx, generator, lr,
                                 lambda_kd)
        self._graph, self._out = graph, out
        self.captures += 1

    def __call__(self, state: TrainState, teacher: Optional[Teacher], data_x: torch.Tensor,
                 data_y: torch.Tensor, table: torch.Tensor, generator: torch.Generator,
                 lr: torch.Tensor, lambda_kd: torch.Tensor) -> torch.Tensor:
        """Run ``table.shape[0]`` steps, step ``s`` on the rows
        ``table[s]`` of ``data_x``/``data_y`` (this rank's stripe of each
        global batch); returns the metrics ``[steps, len(METRICS)]`` on the
        device."""
        steps, global_b = table.shape
        b = global_b // self._axis.size
        cols = table[:, self._axis.rank * b:(self._axis.rank + 1) * b]
        rows = torch.empty(steps, len(METRICS), device=data_x.device)
        if not self.graphed:
            for s in range(steps):
                rows[s].copy_(self._run_step(state, teacher, data_x, data_y, cols[s], generator,
                                             lr, lambda_kd))
            return rows
        start = 0
        if self._graph is None:
            # Step 0 runs eagerly (a real step, and the capture's warm-up) on
            # the static index row, then the step is captured; the two are
            # the capture's cost (the capture synchronizes on entry).
            with self._span("capture"):
                t0 = time.perf_counter()
                self._idx = torch.empty(b, dtype=torch.int64, device=data_x.device)
                self._idx.copy_(cols[0])
                rows[0].copy_(self._run_step(state, teacher, data_x, data_y, self._idx,
                                             generator, lr, lambda_kd))
                self._capture(state, teacher, data_x, data_y, generator, lr, lambda_kd)
                capture_s = time.perf_counter() - t0
            CompileWatch.install().record_capture(capture_s)
            start = 1
        for s in range(start, steps):
            self._idx.copy_(cols[s])
            self._graph.replay()
            rows[s].copy_(self._out)
        return rows


def make_epoch_fn(
    aug_cfg: AugmentConfig,
    policy: Policy,
    label_smoothing: float,
    kd_temperature: float,
    momentum: float,
    weight_decay: float,
    use_pallas_loss: bool = False,
    axis: Optional[DataAxis] = None,
    device: Optional[torch.device] = None,
    processes: int = 1,
    span: Callable[[str], ContextManager] = contextlib.nullcontext,
) -> EpochFn:
    """The fused epoch: counterpart of the JAX package's ``make_epoch_fn``
    (its ``lax.scan`` over the steps of an epoch, one dispatch an epoch).

    ``epoch(state, teacher, data_x, data_y, table, generator, lr,
    lambda_kd) -> metrics [steps, len(METRICS)]``: ``data_x`` is the task's
    uint8 ``[N, H, W, C]`` dataset and ``data_y`` its labels, both on the
    device for the whole task; ``table`` the epoch's int64 ``[steps,
    global_batch]`` index table on the device; ``lr`` and ``lambda_kd`` 0-d
    f32 tensors on the device.  Each step gathers its batch on the device
    (``data_x[idx]``) and runs the train step of :func:`make_train_step`.

    On CUDA at one rank the step is captured as a CUDA graph and replayed
    once a step: the first step after :meth:`EpochFn.reset` (or after the
    function is made) runs eagerly and is followed by the capture; every
    other step is a replay that reads its index row from a static buffer.
    The replays read and write the tensors of the capture, so the caller
    resets the function whenever it passes other ones (the loop does at
    the start of each task).  ``generator`` is registered with the graph,
    so reseeding it between epochs reseeds the replays.
    On the CPU, and at more than one rank (``processes``: the run's, data
    and model axes together; gloo's collectives cannot be captured), the
    same steps run eagerly.  The choice is made here, from the device and
    the process count.  ``span`` names the capture's region (see
    :class:`EpochFn`)."""
    axis = axis or DataAxis()
    device = device or torch.device("cpu")
    step = make_train_step(aug_cfg, policy, label_smoothing, kd_temperature, momentum,
                           weight_decay, use_pallas_loss, axis)
    return EpochFn(step, axis, graphed=device.type == "cuda" and processes == 1, span=span)


def make_eval_step(aug_cfg: AugmentConfig):
    """``step(model, x_u8, labels, weights, num_active) -> [loss_sum, c1,
    c5, weight_sum]`` on the device; padding rows weigh 0."""

    @torch.no_grad()
    def step(model, x_u8, labels, weights, num_active):
        x = eval_preprocess(x_u8, aug_cfg)
        logits, _ = model(x, num_active, train=False)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels[:, None])[:, 0]
        return torch.stack([
            (nll * weights).sum(),
            topk_correct(logits, labels, 1, weights),
            topk_correct(logits, labels, 5, weights),
            weights.sum(),
        ])

    return step


class FeatureStep:
    """Herding features ``[B, 64]`` in eval mode, from augmented images
    when ``augmented`` (the reference's herding loader wraps the train
    transform); built by :func:`make_feature_step`.

    Called on one uint8 batch it runs eagerly: the host-batched pass of a
    path dataset.  :meth:`resident_pass` runs the whole
    unshuffled herding pass over a dataset held on the device.  Each batch
    gathers its rows into a static batch on the device and draws its
    augmentation eagerly, one ``augment.draw_params`` call a batch on the
    caller's generator, into fresh tensors.  With ``graphed`` they are
    copied into static ones and the augmentation and the backbone replay
    one CUDA graph; else both run eagerly on the drawn tensors.  A graph is
    captured at the first graphed pass and again only when a pass's batch
    shape, mode or backbone tensors (their storage) differ from the
    capture's; ``captures`` and ``replays`` count them.  The gather stays
    outside the graph: each task's resident dataset is a new tensor, which
    a graph would have to be captured anew to read."""

    def __init__(self, aug_cfg: AugmentConfig, augmented: bool):
        self.aug_cfg = aug_cfg
        self.augmented = augmented
        self.captures = 0
        self.replays = 0
        self._graph = None
        self._key = None  # what the graph binds: batch shape, mode, backbone storage
        self._x = None  # the static uint8 batch
        self._draws = None  # the static draws the graph reads
        self._out = None  # the graph's features

    @torch.no_grad()
    def __call__(self, model: CilModel, x_u8: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        if self.augmented:
            x = train_augment(x_u8, self.aug_cfg, generator)
        else:
            x = eval_preprocess(x_u8, self.aug_cfg)
        return model.extract_vector(x, train=False)

    def _features(self, model: CilModel, draws: Optional[augment.Draws]) -> torch.Tensor:
        """The graph's region: the static batch to its features."""
        if self.augmented:
            x = augment.augment(self._x, draws, self.aug_cfg)
        else:
            x = eval_preprocess(self._x, self.aug_cfg)
        return model.extract_vector(x, train=False)

    def _stage(self, draws: augment.Draws) -> None:
        """A batch's draws into the static ones the graph reads; the drawn
        tensors stay as they were drawn."""
        if self._draws is None:
            self._draws = augment.Draws(**{f.name: t.clone() for f in fields(draws)
                                           if (t := getattr(draws, f.name)) is not None})
            return
        for f in fields(draws):
            if (t := getattr(draws, f.name)) is not None:
                getattr(self._draws, f.name).copy_(t)

    def _capture(self, model: CilModel) -> None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._features(model, self._draws)
        self._graph = graph
        self.captures += 1

    @torch.no_grad()
    def resident_pass(self, model: CilModel, data_x: torch.Tensor, n: int, batch_size: int,
                      generator: torch.Generator, graphed: bool,
                      each_batch: Optional[Callable[[torch.Tensor], None]] = None,
                      ) -> torch.Tensor:
        """The features ``[n, D]`` on the device of the first ``n`` rows of
        ``data_x`` (uint8 ``[N, H, W, C]`` on the device), in the batches of
        ``data/loader.py`` ``sequential_batches``: ``ceil(n / batch_size)``
        of them, the last wrap-padded.  ``each_batch`` sees every batch
        before its features are computed."""
        dev = data_x.device
        nb = -(-n // batch_size)
        table = torch.from_numpy(np.resize(np.arange(n), (nb, batch_size))).to(dev)
        shape = (batch_size, *data_x.shape[1:])
        if self._x is None or tuple(self._x.shape) != shape or self._x.device != dev:
            self._x = torch.empty(shape, dtype=torch.uint8, device=dev)
            self._key = None  # a graph reads the static batch it was captured on
        if graphed:
            backbone = [*model.backbone.parameters(), *model.backbone.buffers()]
            key = (shape, self.augmented, tuple(t.data_ptr() for t in backbone))
            if key != self._key:
                self._graph = self._out = self._draws = None
                self._key = key
        out = None
        for b in range(nb):
            torch.index_select(data_x, 0, table[b], out=self._x)
            if each_batch is not None:
                each_batch(self._x)
            draws = None
            if self.augmented:
                draws = augment.draw_params(batch_size, self.aug_cfg, generator, shape[1:])
            if not graphed:
                f = self._features(model, draws)
            else:
                if draws is not None:
                    self._stage(draws)
                if self._graph is None:
                    # The batch runs eagerly (the capture's warm-up), then
                    # the region is captured; the later batches replay it.
                    f = self._features(model, self._draws)
                    self._capture(model)
                else:
                    self._graph.replay()
                    self.replays += 1
                    f = self._out
            if out is None:
                out = f.new_empty((nb, *f.shape))
            out[b].copy_(f)
        return out.view(nb * batch_size, -1)[:n]


def make_feature_step(aug_cfg: AugmentConfig, augmented: bool) -> FeatureStep:
    """The herding feature step (see :class:`FeatureStep`)."""
    return FeatureStep(aug_cfg, augmented)
