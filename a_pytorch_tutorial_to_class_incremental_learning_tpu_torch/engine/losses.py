"""Losses and accuracy over masked full-width logits, accumulated in f32.

Counterpart of the JAX package's ``engine/losses.py``.  ``cross_entropy`` is
the train loss without ``--use_pallas_loss`` and the reference the fused
kernel (``ops/fused_loss.py``) is held against.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Count = Union[int, torch.Tensor]


def _active_mask(width: int, num_active: Count, device) -> torch.Tensor:
    return torch.arange(width, device=device) < num_active


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_active: Count,
    label_smoothing: float = 0.0,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE with label smoothing over the active classes: target
    ``(1-s)·onehot + s/num_active`` on active columns.  Masked columns hold
    ``NEG_INF``, so the full-width log-softmax is the active-slice one."""
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
        return per.mean()
    return (per * weights).sum() / weights.sum().clamp_min(1.0)


def soft_target_kd(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    known: Count,
    temperature: float = 2.0,
) -> torch.Tensor:
    """``KL(softmax(t/T) || softmax(s/T)) · T²``, batch mean, over the first
    ``known`` classes."""
    s = student_logits.float()
    t = teacher_logits.float()
    mask = _active_mask(s.shape[-1], known, s.device)
    s = torch.where(mask, s, -1e9) / temperature
    t = torch.where(mask, t, -1e9) / temperature
    logp_s = F.log_softmax(s, dim=-1)
    logp_t = F.log_softmax(t, dim=-1)
    p_t = logp_t.exp()
    kl_per = torch.where(mask, p_t * (logp_t - logp_s), 0.0).sum(-1)
    return kl_per.mean() * temperature * temperature


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
    logits: torch.Tensor, labels: torch.Tensor, topk: Tuple[int, ...] = (1, 5)
) -> Tuple[torch.Tensor, ...]:
    """Batch top-k accuracies in percent."""
    b = logits.shape[0]
    return tuple(topk_correct(logits, labels, k) * (100.0 / b) for k in topk)
