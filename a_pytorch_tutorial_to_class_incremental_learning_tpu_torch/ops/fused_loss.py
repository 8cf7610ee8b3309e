"""Fused masked cross-entropy with label smoothing: kernels, plain version,
and the ``autograd.Function`` around them.

Counterpart of the JAX package's ``ops/fused_loss.py`` and its two Pallas
kernels.  On a CUDA tensor the wrappers launch the Triton kernels of
``triton_fused_loss.py`` (which also documents their design and bound on
the H100); on a CPU tensor they run the plain PyTorch version below, as the
JAX tests run the Pallas kernel in interpret mode.  There is no fallback: a
CUDA tensor launches the kernel or raises.

Same contract as ``engine.losses.cross_entropy`` without sample weights:
masked columns hold ``NEG_INF``, the smoothing target is ``(1-s)·onehot +
s/num_active`` over active columns, and the loss is the batch mean.
``num_active`` is a 1-element int32 tensor on the logits' device, so one
code path serves every task without a host sync.

``sharded_fused_masked_cross_entropy`` is the data-parallel form (JAX
``sharded_fused_masked_cross_entropy``, ``fused_loss.py:191-224``): the same
kernels on each rank's batch stripe, plus one scalar all-reduce.

``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches (never plain-version
calls), so a run can show that its train steps went through the kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_LOGIT_DTYPES = (torch.float32, torch.bfloat16)


def _check(logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits must be [B, W], got {tuple(logits.shape)}")
    if logits.dtype not in _LOGIT_DTYPES:
        raise TypeError(f"logits dtype {logits.dtype} not in {_LOGIT_DTYPES}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if labels.shape != (logits.shape[0],) or labels.dtype != torch.int64:
        raise ValueError(
            f"labels must be int64 [{logits.shape[0]}], got "
            f"{labels.dtype} {tuple(labels.shape)}"
        )
    if num_active.numel() != 1 or num_active.dtype != torch.int32:
        raise ValueError(
            f"num_active must be a 1-element int32 tensor, got "
            f"{num_active.dtype} {tuple(num_active.shape)}"
        )
    for name, t in (("labels", labels), ("num_active", num_active)):
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused masked-CE for device {logits.device}")


# --------------------------------------------------------------------------- #
# Plain PyTorch version (CPU tensors; the yardstick the kernels are held to)
# --------------------------------------------------------------------------- #


def fused_ce_fwd_plain(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    smoothing: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    x = logits.float()
    m = x.max(dim=1, keepdim=True).values
    lse = m[:, 0] + torch.log(torch.exp(x - m).sum(dim=1))
    nll = lse - x.gather(1, labels[:, None])[:, 0]
    cols = torch.arange(x.shape[1], device=x.device)
    active_sum = torch.where(cols < num_active, x, 0.0).sum(dim=1)
    smooth = lse - active_sum / num_active.float()
    return (1.0 - smoothing) * nll + smoothing * smooth, lse


def fused_ce_bwd_plain(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    lse: torch.Tensor, grad: torch.Tensor, smoothing: float,
) -> torch.Tensor:
    x = logits.float()
    b, w = x.shape
    p = torch.exp(x - lse[:, None])
    cols = torch.arange(w, device=x.device)
    target = torch.where(cols == labels[:, None], 1.0 - smoothing, 0.0) + torch.where(
        cols < num_active, smoothing / num_active.float(), 0.0
    )
    return ((p - target) * (grad.float() / b)).to(logits.dtype)


# --------------------------------------------------------------------------- #
# Wrappers: kernel on CUDA, plain version on the CPU
# --------------------------------------------------------------------------- #


def fused_ce_fwd(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    smoothing: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample loss ``[B]`` f32 and the per-row logsumexp ``[B]`` f32."""
    global FWD_LAUNCHES
    _check(logits, labels, num_active)
    if logits.device.type == "cpu":
        return fused_ce_fwd_plain(logits, labels, num_active, smoothing)
    from .triton_fused_loss import launch_fwd

    out = launch_fwd(logits, labels, num_active, smoothing)
    FWD_LAUNCHES += 1
    return out


def fused_ce_bwd(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    lse: torch.Tensor, grad: torch.Tensor, smoothing: float,
) -> torch.Tensor:
    """``dlogits`` of the batch-mean loss for the 0-d upstream ``grad``."""
    global BWD_LAUNCHES
    _check(logits, labels, num_active)
    if lse.shape != (logits.shape[0],) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [{logits.shape[0]}]")
    if grad.numel() != 1:
        raise ValueError(f"grad must have one element, got {tuple(grad.shape)}")
    for name, t in (("lse", lse), ("grad", grad)):
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
    if logits.device.type == "cpu":
        return fused_ce_bwd_plain(logits, labels, num_active, lse, grad, smoothing)
    from .triton_fused_loss import launch_bwd

    dx = launch_bwd(logits, labels, num_active, lse, grad.float().contiguous(), smoothing)
    BWD_LAUNCHES += 1
    return dx


class FusedMaskedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, num_active, smoothing):
        logits = logits.contiguous()
        per, lse = fused_ce_fwd(logits, labels, num_active, smoothing)
        ctx.save_for_backward(logits, labels, num_active, lse)
        ctx.smoothing = smoothing
        return per.mean()

    @staticmethod
    def backward(ctx, grad):
        logits, labels, num_active, lse = ctx.saved_tensors
        dx = fused_ce_bwd(logits, labels, num_active, lse, grad, ctx.smoothing)
        return dx, None, None, None


def fused_masked_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_active: torch.Tensor,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean masked CE with label smoothing through the fused kernels."""
    return FusedMaskedCrossEntropy.apply(logits, labels, num_active, float(label_smoothing))


class ShardedFusedMaskedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, num_active, smoothing, group):
        logits = logits.contiguous()
        per, lse = fused_ce_fwd(logits, labels, num_active, smoothing)
        world = dist.get_world_size(group)
        total = per.sum()
        dist.all_reduce(total, group=group)
        ctx.save_for_backward(logits, labels, num_active, lse)
        ctx.smoothing = smoothing
        ctx.world = world
        return total / (logits.shape[0] * world)

    @staticmethod
    def backward(ctx, grad):
        logits, labels, num_active, lse = ctx.saved_tensors
        dx = fused_ce_bwd(logits, labels, num_active, lse, grad / ctx.world, ctx.smoothing)
        return dx, None, None, None, None


def sharded_fused_masked_cross_entropy(
    group,
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_active: torch.Tensor,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Global-batch mean masked CE over the ranks of ``group``, each holding
    an equal stripe of the batch.

    Forward: the fused kernel on this rank's stripe, then one all-reduce of
    the stripe's summed per-sample loss, divided by the global batch: the
    value of JAX's scalar ``pmean``, the same on every rank.  Backward: the
    kernel on the stripe with upstream ``g / N``, so the stripe's
    ``dlogits`` are the global mean's gradient for those rows (JAX's
    ``pmean`` cotangent), with no collective.  Summing the parameter
    gradients over the ranks then gives the global gradient."""
    return ShardedFusedMaskedCrossEntropy.apply(
        logits, labels, num_active, float(label_smoothing), group
    )
