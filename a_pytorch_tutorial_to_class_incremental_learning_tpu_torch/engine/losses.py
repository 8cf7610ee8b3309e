"""Losses and accuracy over masked full-width logits, accumulated in f32.

Counterpart of the JAX package's ``engine/losses.py``.  ``cross_entropy`` is
the train loss without ``--use_pallas_loss`` and the reference the fused
kernel (``ops/fused_loss.py``) is held against.

Under data parallelism each rank holds a stripe of the global batch, and
``group`` (its process group) asks for the rank's *share* of the global-
batch value: its local mean divided by the number of ranks, so that the
shares sum to the global value and their gradients to the global gradient.
``group=None`` is the single-process value.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

Count = Union[int, torch.Tensor]


def _active_mask(width: int, num_active: Count, device) -> torch.Tensor:
    return torch.arange(width, device=device) < num_active


def _ranks(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_active: Count,
    label_smoothing: float = 0.0,
    weights: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Mean CE with label smoothing over the active classes: target
    ``(1-s)·onehot + s/num_active`` on active columns.  Masked columns hold
    ``NEG_INF``, so the full-width log-softmax is the active-slice one.
    With ``group``, the rank's share of the global-batch mean."""
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if label_smoothing:
        mask = _active_mask(logits.shape[-1], num_active, logits.device)
        na = torch.as_tensor(num_active, device=logits.device).float()
        smooth = -torch.where(mask, logp, 0.0).sum(-1) / na
        per = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    else:
        per = nll
    if weights is None:
        return per.mean() / _ranks(group)
    return (per * weights).sum() / weights.sum().clamp_min(1.0) / _ranks(group)


def soft_target_kd(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    known: Count,
    temperature: float = 2.0,
    group=None,
) -> torch.Tensor:
    """``KL(softmax(t/T) || softmax(s/T)) · T²``, batch mean, over the first
    ``known`` classes; with ``group``, the rank's share of the global one."""
    s = student_logits.float()
    t = teacher_logits.float()
    mask = _active_mask(s.shape[-1], known, s.device)
    s = torch.where(mask, s, -1e9) / temperature
    t = torch.where(mask, t, -1e9) / temperature
    logp_s = F.log_softmax(s, dim=-1)
    logp_t = F.log_softmax(t, dim=-1)
    p_t = logp_t.exp()
    kl_per = torch.where(mask, p_t * (logp_t - logp_s), 0.0).sum(-1)
    return kl_per.mean() * temperature * temperature / _ranks(group)


def topk_correct(
    logits: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted count of samples whose label is among the top ``min(k,
    width)`` logits."""
    idx = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    hit = (idx == labels[:, None]).any(dim=-1).float()
    if weights is None:
        return hit.sum()
    return (hit * weights).sum()


def accuracy(
    logits: torch.Tensor, labels: torch.Tensor, topk: Tuple[int, ...] = (1, 5),
    group=None,
) -> Tuple[torch.Tensor, ...]:
    """Batch top-k accuracies in percent; with ``group``, the rank's shares
    of the global batch's (the train step all-reduces them with the other
    metrics, in one collective)."""
    b = logits.shape[0] * _ranks(group)
    return tuple(topk_correct(logits, labels, k) * (100.0 / b) for k in topk)
