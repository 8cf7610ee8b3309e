"""BatchNorm with flax semantics, over the global batch or in fixed groups.

Counterpart of flax ``nn.BatchNorm`` as the JAX package's ResNet uses it
(global-batch statistics) and of the JAX package's ``models/norm.py``
(``GroupedBatchNorm``: the reference's per-replica BN, ``--bn_group_size``).
Both keep the parameter and statistic names (``weight``/``bias``,
``running_mean``/``running_var``), so ``utils/jax_weights.py`` carries
either one's variables, and a teacher of one kind fits a student of the
other.

Under data parallelism (a module given a sharded :class:`DataAxis`) each
rank holds a stripe of the global batch.  ``BatchNorm`` then takes the
per-channel moments of its stripe, all-reduces them through
``torch.distributed.nn.functional.all_reduce`` (whose backward all-reduces
the gradient), and normalizes with the global-batch statistics, as flax
does on a data-sharded batch.  ``GroupedBatchNorm`` keeps its groups on one
rank when the group size divides the per-rank batch, and otherwise all-
reduces over the consecutive ranks one group spans.

A bf16 input follows flax's ``BatchNorm(dtype=bfloat16)`` (and the JAX
``GroupedBatchNorm``): the input is upcast, the statistics, the
normalization, the scale and the shift run in f32, and only the output is
rounded to bf16; the running statistics stay f32.  flax reduces the
statistics from one f32 copy of the input and normalizes another, so in
train mode the backward rounds each copy's gradient to bf16 and sums the
two in bf16; ``BatchNorm`` upcasts twice to do the same (the JAX
``GroupedBatchNorm`` upcasts once, and so does the port's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import DataAxis


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """BatchNorm's arithmetic dtype: at least f32 (flax promotes the same)."""
    return torch.promote_types(dtype, torch.float32)


def all_reduce_moments(x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NCHW ``x`` over the batch
    rows of every rank of ``group`` and the spatial positions.

    Each rank takes its own mean and variance (two passes, no cancellation)
    and puts them in its slot of a ``[ranks, 2, C]`` buffer; one autograd
    all-reduce (sum) of the buffer hands every rank all the ranks' moments,
    as ``SyncBatchNorm``'s all-gather does, and its backward all-reduces the
    gradient, so every rank's backward sees the whole group's statistics.
    The ranks hold equal rows, so the group's variance is the mean of their
    variances plus the variance of their means."""
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    local = torch.stack([mean, var])
    rank = dist.get_rank(group)
    slots = [local if r == rank else torch.zeros_like(local)
             for r in range(dist.get_world_size(group))]
    moments = dist_fn.all_reduce(torch.stack(slots), group=group)
    means, variances = moments[:, 0], moments[:, 1]
    mean = means.mean(0)
    return mean, variances.mean(0) + (means - mean).square().mean(0)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` semantics.

    ``torch.nn.BatchNorm2d`` folds the *unbiased* batch variance into its
    running variance; flax folds the *biased* one.  So train mode normalizes
    with ``F.batch_norm`` on batch statistics and updates the running stats
    by hand: ``running = 0.9·running + 0.1·batch`` with the biased variance.
    On a sharded ``axis`` the batch statistics are the global batch's.
    """

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 axis: Optional[DataAxis] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.axis = axis
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @property
    def world(self) -> int:
        return self.axis.size if self.axis is not None else 1

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = stats_dtype(x.dtype)
        if not train:
            return F.batch_norm(
                x.to(dt), self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            ).to(x.dtype)
        if self.world == 1 and x.dtype == dt:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self._update_running(mean, var)
            return F.batch_norm(
                x, None, None, self.weight, self.bias, True, 0.0, self.eps
            )
        stats_copy = x.to(dt)
        if self.world > 1:
            mean, var = all_reduce_moments(stats_copy, self.axis.group)
        else:
            var, mean = torch.var_mean(stats_copy, dim=(0, 2, 3), correction=0)
        self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x.to(dt) - _channel(mean)) * _channel(scale) + _channel(self.bias)
        return y.to(x.dtype)


def group_span(group_size: int, local_batch: int, world: int) -> int:
    """Ranks one BN group spans: 1 when ``group_size`` divides the per-rank
    batch (every group lies on one rank), ``group_size / local_batch`` when
    the per-rank batch divides it and that many ranks divide the axis.  Any
    other size splits a group unevenly and raises ``ValueError``, as the
    JAX package does for a batch the group size does not divide."""
    if group_size <= 0:
        raise ValueError(f"bn group size must be positive, got {group_size}")
    if local_batch % group_size == 0:
        return 1
    span, rem = divmod(group_size, local_batch)
    if rem == 0 and world % span == 0:
        return span
    raise ValueError(
        f"bn group size {group_size} does not fit a global batch of {world} "
        f"rank(s) x {local_batch} rows: it must divide the per-rank batch or "
        "be a multiple of it that spans a whole number of ranks"
    )


class GroupedBatchNorm(BatchNorm):
    """BatchNorm over consecutive groups of ``group_size`` rows of the global
    batch (JAX ``models/norm.py:30-91``).

    Each group normalizes with its own biased statistics.  The running
    stats move toward the mean over all groups of the global batch, with
    the *Bessel-corrected* variance (``n / (n-1)``, ``n = group_size·H·W``),
    as N torch replicas would on average; they are all-reduced, so every
    rank keeps the same running stats.
    """

    def __init__(self, num_features: int, group_size: int, momentum: float = 0.1,
                 eps: float = 1e-5, axis: Optional[DataAxis] = None):
        super().__init__(num_features, momentum, eps, axis)
        if group_size <= 0:
            raise ValueError(f"bn group size must be positive, got {group_size}")
        self.group_size = group_size

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return super().forward(x, False)
        return self._normalize_groups(x.to(stats_dtype(x.dtype))).to(x.dtype)

    def _normalize_groups(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        gs = self.group_size
        span = group_span(gs, b, self.world)
        if span == 1:
            xg = x.reshape(b // gs, gs, c, h, w)
            mean = xg.mean(dim=(1, 3, 4), keepdim=True)
            centered = xg - mean
            var = centered.square().mean(dim=(1, 3, 4), keepdim=True)
            y = (centered * torch.rsqrt(var + self.eps)).reshape(x.shape)
            mean, var = mean.mean(0).reshape(c), var.mean(0).reshape(c)
        else:
            mean, var = all_reduce_moments(x, self.axis.span_group(span))
            y = (x - _channel(mean)) * _channel(torch.rsqrt(var + self.eps))
        with torch.no_grad():
            # This rank's mean over its groups (or its one group), then the
            # mean over ranks: the mean over every group of the global batch.
            stats = torch.stack([mean, var])
            if self.world > 1:
                dist.all_reduce(stats, group=self.axis.group)
                stats /= self.world
            n = gs * h * w
            self._update_running(stats[0], stats[1] * (n / max(n - 1, 1)))
        return y * _channel(self.weight) + _channel(self.bias)


def make_norm(num_features: int, bn_group_size: int = 0,
              axis: Optional[DataAxis] = None) -> BatchNorm:
    """The ResNet's BN (JAX ``resnet.py:67-89``): global-batch statistics by
    default, fixed-size groups when ``bn_group_size > 0``."""
    if bn_group_size > 0:
        return GroupedBatchNorm(num_features, bn_group_size, axis=axis)
    return BatchNorm(num_features, axis=axis)
