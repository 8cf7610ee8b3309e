"""The static full-width masked head: growth, masking and weight alignment.

Counterpart of the JAX package's ``models/classifier.py``.  The head is one
``nn.Linear(64, width)`` allocated at full width; columns ``[0, num_active)``
are the live classes and the rest read ``NEG_INF``.  ``num_active`` may be a
device tensor, so masking needs no host sync.  The torch layout stores the
head as ``weight [width, 64]`` (rows are classes), where flax keeps
``fc_kernel [64, width]``.  Growth and alignment write the head in place.

On a model axis (``parallel/mesh.py``) ``fc`` is this rank's shard, the
rows ``[k·W/m, (k+1)·W/m)`` of the full head, and ``axis`` its
``ModelAxis``: the forward gathers the full head (:func:`gather_rows`),
growth draws every new row on every rank and keeps its own, and alignment
takes its norms over the gathered head, so each gives every rank its rows
of the unsharded result.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..parallel.mesh import ModelAxis, gather_full, gather_rows

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


def _sharded(axis: Optional[ModelAxis]) -> bool:
    return axis is not None and axis.sharded


def _rows(fc: torch.nn.Linear, axis: Optional[ModelAxis]) -> Tuple[int, int]:
    """``(first row, full width)`` of the head that ``fc`` holds."""
    rows = fc.weight.shape[0]
    if not _sharded(axis):
        return 0, rows
    return axis.rank * rows, rows * axis.size


@torch.no_grad()
def grow_head(fc: torch.nn.Linear, generator: torch.Generator, known: int, nb_new: int,
              axis: Optional[ModelAxis] = None) -> None:
    """Initialize the rows ``[known, known + nb_new)`` for a new task.  A
    shard draws all ``nb_new`` rows, as the full head does, and keeps its
    own: the generator's stream stays in step with an unsharded run."""
    lo, width = _rows(fc, axis)
    feat_dim = fc.weight.shape[1]
    if known + nb_new > width:
        raise ValueError(f"head overflow: known={known} + new={nb_new} > width={width}")
    w, b = torch_linear_init(generator, feat_dim, nb_new)
    start, stop = max(known, lo), min(known + nb_new, lo + fc.weight.shape[0])
    if start < stop:
        fc.weight[start - lo:stop - lo] = w[start - known:stop - known].to(fc.weight.device)
        fc.bias[start - lo:stop - lo] = b[start - known:stop - known].to(fc.bias.device)


def masked_logits(
    features: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_active: Union[int, torch.Tensor],
    head_dtype: torch.dtype = torch.float32,
    axis: Optional[ModelAxis] = None,
) -> torch.Tensor:
    """``[B, 64] -> [B, width]`` f32 logits with columns ``>= num_active``
    masked.  ``weight`` and ``bias`` may be shards of the ``axis`` group:
    the full head is gathered first, so every rank gets the full-width
    rows, the same on each.

    A ``head_dtype`` narrower than f32 rounds both operands to it (the f32
    master weight at the call) and multiplies them in f32: the product of
    two bf16 values is exact in f32, so this is JAX's bf16 matmul with
    ``preferred_element_type=float32``, where a bf16 ``F.linear`` would
    round the logits to bf16."""
    weight, bias = gather_rows(axis, weight), gather_rows(axis, bias)
    if torch.finfo(head_dtype).bits < 32:
        features = features.to(head_dtype).float()
        weight = weight.to(head_dtype).float()
    logits = F.linear(features, weight, bias)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < num_active, logits, NEG_INF)


@torch.no_grad()
def weight_align(fc: torch.nn.Linear, known: int, nb_new: int,
                 axis: Optional[ModelAxis] = None) -> torch.Tensor:
    """WA: scale the newest head's weight rows (not its bias) by
    ``gamma = mean(old-class norms) / mean(new-class norms)``; returns gamma.
    The norms are taken over the whole head (a shard gathers it first), so
    gamma is the unsharded one on every rank."""
    if known <= 0 or nb_new <= 0:
        raise ValueError(
            f"weight_align needs old and new classes (known={known}, nb_new={nb_new})"
        )
    lo, _ = _rows(fc, axis)
    weight = gather_full(axis, fc.weight) if _sharded(axis) else fc.weight
    norms = torch.linalg.norm(weight[: known + nb_new], dim=1)
    gamma = norms[:known].mean() / norms[known:].mean()
    start, stop = max(known, lo), min(known + nb_new, lo + fc.weight.shape[0])
    if start < stop:
        fc.weight[start - lo:stop - lo] *= gamma
    return gamma
