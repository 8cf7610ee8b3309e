"""The static full-width masked head: growth, masking and weight alignment.

Counterpart of the JAX package's ``models/classifier.py``.  The head is one
``nn.Linear(64, width)`` allocated at full width; columns ``[0, num_active)``
are the live classes and the rest read ``NEG_INF``.  ``num_active`` may be a
device tensor, so masking needs no host sync.  The torch layout stores the
head as ``weight [width, 64]`` (rows are classes), where flax keeps
``fc_kernel [64, width]``.  Growth and alignment write the head in place.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

# Finite stand-in for -inf: exp(NEG_INF - m) is exactly 0 in f32, so masked
# columns get zero probability and zero gradient without NaNs.
NEG_INF = -1e9


def torch_linear_init(
    generator: torch.Generator, feat_dim: int, nb_new: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear``'s default init for one new head: weight and bias both
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.  Returns ``(weight [nb_new,
    feat_dim], bias [nb_new])`` on the generator's device."""
    bound = 1.0 / (feat_dim ** 0.5)
    dev = generator.device
    weight = torch.empty(nb_new, feat_dim, device=dev).uniform_(
        -bound, bound, generator=generator
    )
    bias = torch.empty(nb_new, device=dev).uniform_(-bound, bound, generator=generator)
    return weight, bias


@torch.no_grad()
def grow_head(fc: torch.nn.Linear, generator: torch.Generator, known: int, nb_new: int) -> None:
    """Initialize the rows ``[known, known + nb_new)`` for a new task."""
    width, feat_dim = fc.weight.shape
    if known + nb_new > width:
        raise ValueError(f"head overflow: known={known} + new={nb_new} > width={width}")
    w, b = torch_linear_init(generator, feat_dim, nb_new)
    fc.weight[known : known + nb_new] = w.to(fc.weight.device)
    fc.bias[known : known + nb_new] = b.to(fc.bias.device)


def masked_logits(
    features: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_active: Union[int, torch.Tensor],
) -> torch.Tensor:
    """``[B, 64] -> [B, width]`` logits with columns ``>= num_active`` masked."""
    logits = F.linear(features, weight, bias)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < num_active, logits, NEG_INF)


@torch.no_grad()
def weight_align(fc: torch.nn.Linear, known: int, nb_new: int) -> torch.Tensor:
    """WA: scale the newest head's weight rows (not its bias) by
    ``gamma = mean(old-class norms) / mean(new-class norms)``; returns gamma."""
    if known <= 0 or nb_new <= 0:
        raise ValueError(
            f"weight_align needs old and new classes (known={known}, nb_new={nb_new})"
        )
    norms = torch.linalg.norm(fc.weight[: known + nb_new], dim=1)
    gamma = norms[:known].mean() / norms[known:].mean()
    fc.weight[known : known + nb_new] *= gamma
    return gamma
