"""Train, eval and feature steps, and the torch-semantics SGD.

Counterpart of the JAX package's ``engine/train.py``.  One train step is:
augment on the device -> student forward (train mode, BN running stats
updated) -> masked CE, through the fused kernel with ``use_pallas_loss`` ->
teacher forward (eval mode, no grad) + λ·KD -> backward -> SGD.  Step
metrics stay on the device; the loop fetches them once per epoch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..data.augment import AugmentConfig, eval_preprocess, train_augment
from ..models import CilModel
from ..ops import fused_masked_cross_entropy
from .losses import accuracy, cross_entropy, soft_target_kd, topk_correct


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
    lr: float,
    momentum: float,
    weight_decay: float,
) -> None:
    """torch.optim.SGD (dampening 0, no Nesterov), in place:
    ``buf = m·buf + g + wd·p;  p -= lr·buf``, in the JAX package's order."""
    torch._foreach_mul_(momentum_buf, momentum)
    torch._foreach_add_(momentum_buf, grads)
    torch._foreach_add_(momentum_buf, params, alpha=weight_decay)
    torch._foreach_add_(params, momentum_buf, alpha=-lr)


def cosine_lr(base_lr: float, epoch: int, num_epochs: int) -> float:
    """``CosineAnnealingLR(T_max=num_epochs)`` stepped per epoch."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / num_epochs))


def train_step_on_batch(
    state: TrainState,
    teacher: Optional[Teacher],
    x: torch.Tensor,
    labels: torch.Tensor,
    lr: float,
    lambda_kd: float,
    *,
    label_smoothing: float,
    kd_temperature: float,
    momentum: float,
    weight_decay: float,
    use_pallas_loss: bool = False,
) -> Dict[str, torch.Tensor]:
    """One step on an already augmented, normalized NHWC batch ``x``."""
    model = state.model
    params = list(model.parameters())
    logits, _ = model(x, state.num_active, train=True)
    if use_pallas_loss:
        ce = fused_masked_cross_entropy(logits, labels, state.num_active, label_smoothing)
    else:
        ce = cross_entropy(logits, labels, state.num_active, label_smoothing)
    if teacher is not None:
        with torch.no_grad():
            t_logits, _ = teacher.model(x, teacher.known, train=False)
        kd = lambda_kd * soft_target_kd(logits, t_logits, state.known, kd_temperature)
    else:
        kd = torch.zeros((), device=logits.device)
    loss = ce + kd
    grads = torch.autograd.grad(loss, params)
    sgd_update(params, list(grads), state.momentum, lr, momentum, weight_decay)
    acc1, acc5 = accuracy(logits.detach(), labels, topk=(1, 5))
    return {"ce": ce.detach(), "kd": kd.detach(), "loss": loss.detach(),
            "acc1": acc1, "acc5": acc5}


def make_train_step(
    aug_cfg: AugmentConfig,
    label_smoothing: float,
    kd_temperature: float,
    momentum: float,
    weight_decay: float,
    use_pallas_loss: bool = False,
):
    """``step(state, teacher, x_u8, labels, generator, lr, lambda_kd) ->
    metrics``: augment with ``generator``, then :func:`train_step_on_batch`."""

    def step(state, teacher, x_u8, labels, generator, lr, lambda_kd):
        x = train_augment(x_u8, aug_cfg, generator)
        return train_step_on_batch(
            state, teacher, x, labels, lr, lambda_kd,
            label_smoothing=label_smoothing, kd_temperature=kd_temperature,
            momentum=momentum, weight_decay=weight_decay,
            use_pallas_loss=use_pallas_loss,
        )

    return step


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


def make_feature_step(aug_cfg: AugmentConfig, augmented: bool):
    """Herding features ``[B, 64]`` in eval mode, from augmented images by
    default (the reference's herding loader wraps the train transform)."""

    @torch.no_grad()
    def step(model, x_u8, generator):
        if augmented:
            x = train_augment(x_u8, aug_cfg, generator)
        else:
            x = eval_preprocess(x_u8, aug_cfg)
        return model.extract_vector(x, train=False)

    return step
