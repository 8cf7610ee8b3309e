"""Fused masked cross-entropy with label smoothing: kernels, plain version,
and the ``autograd.Function`` around them.

Counterpart of the JAX package's ``ops/fused_loss.py`` and its two Pallas
kernels.  On a CUDA tensor the wrappers launch the CUDA C++ kernels of
``csrc/fused_ce.cu`` (which also documents their design and bound on the
H100), built by ``cuda_build`` at first use and called through ctypes; on a
CPU tensor they run the plain PyTorch version below, as the JAX tests run
the Pallas kernel in interpret mode.  There is no fallback: a CUDA tensor
launches the kernel or raises.

Same contract as ``engine.losses.cross_entropy`` without sample weights:
masked columns hold ``NEG_INF``, the smoothing target is ``(1-s)·onehot +
s/num_active`` over active columns, and the loss is the batch mean.
``num_active`` is a 1-element int32 tensor on the logits' device, so one
code path serves every task without a host sync.

The forward kernel also reduces the batch: it returns ``out = scale · Σ
per`` (``scale = 1/B`` for the batch mean), so a CE call is one launch
forward and one backward.  ``sharded_fused_masked_cross_entropy`` is the
data-parallel form (JAX ``sharded_fused_masked_cross_entropy``,
``fused_loss.py:191-224``): the same kernels on each rank's batch stripe
with ``scale = 1/(B·N)``, plus one scalar all-reduce.

Two counts show that a run's train steps went through the kernels (plain
versions count in neither).  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count the
wrappers' kernel launches on the host.  The kernels also count themselves:
each run on the card adds 1 to a counter in device memory
(:func:`device_launches`).  The two differ under a CUDA graph: a step
captured by the fused epoch (``engine/train.py``) calls the wrappers once,
at the capture, and its kernels then run at every replay.
:func:`reset_launches` zeroes both.

The kernels read f32 or bf16 logits and accumulate in f32 (the
``LOSS_DTYPE`` contract of ``ops/precision.py``); the models hand them f32
logits under every preset (``LOGITS_DTYPE``).  So the kernel is registered
as valid under all three presets, as the JAX package registers its own.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

from . import cuda_build
from .precision import register_policy_kernel

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/fused_ce.cu's DType
_TICKETS = {}  # device index -> the forward's zeroed ticket
_COUNTERS = {}  # device index -> int64 [2]: the kernels' own counts (forward, backward)


def _check(logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor) -> None:
    if logits.dim() != 2 or logits.shape[0] == 0:
        raise ValueError(f"logits must be [B, W] with B > 0, got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"logits dtype {logits.dtype} not in {tuple(_DTYPE_CODES)}")
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
    smoothing: float, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = logits.float()
    m = x.max(dim=1, keepdim=True).values
    lse = m[:, 0] + torch.log(torch.exp(x - m).sum(dim=1))
    nll = lse - x.gather(1, labels[:, None])[:, 0]
    cols = torch.arange(x.shape[1], device=x.device)
    active_sum = torch.where(cols < num_active, x, 0.0).sum(dim=1)
    smooth = lse - active_sum / num_active.float()
    per = (1.0 - smoothing) * nll + smoothing * smooth
    return per, lse, per.sum() * scale


def fused_ce_bwd_plain(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    lse: torch.Tensor, grad: torch.Tensor, smoothing: float, scale: float,
) -> torch.Tensor:
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    cols = torch.arange(x.shape[1], device=x.device)
    target = torch.where(cols == labels[:, None], 1.0 - smoothing, 0.0) + torch.where(
        cols < num_active, smoothing / num_active.float(), 0.0
    )
    return ((p - target) * (grad.float() * scale)).to(logits.dtype)


# --------------------------------------------------------------------------- #
# Wrappers: kernel on CUDA, plain version on the CPU
# --------------------------------------------------------------------------- #


def _counter(device: torch.device) -> torch.Tensor:
    """The device's two launch counters, which the kernels increment."""
    c = _COUNTERS.get(device.index)
    if c is None:
        c = _COUNTERS[device.index] = torch.zeros(2, dtype=torch.int64, device=device)
    return c


def device_launches() -> Tuple[int, int]:
    """``(forward, backward)``: how often the kernels ran on the cards of
    this process since the last :func:`reset_launches`, as the kernels
    counted themselves (waits for the work queued on them)."""
    fwd = bwd = 0
    for c in _COUNTERS.values():
        f, b = c.tolist()
        fwd, bwd = fwd + f, bwd + b
    return fwd, bwd


def reset_launches() -> None:
    """Zero the wrappers' counts and the kernels' own.  The device counters
    are zeroed in place: a captured graph goes on counting into them."""
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = 0
    for c in _COUNTERS.values():
        c.zero_()


def _ticket(device: torch.device) -> torch.Tensor:
    """The device's ticket: one zeroed counter that every forward launch
    takes and leaves at 0 again.  Launches on one stream run in turn, so
    every forward goes to the stream that is current: the trainer's for an
    eager step and for a graph's replays, the capture stream while a graph
    is captured (which runs nothing).  No loss launch goes to a prefetch
    stream: those streams only copy."""
    t = _TICKETS.get(device.index)
    if t is None:
        t = _TICKETS[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


@functools.cache
def _rows_per_block() -> int:
    """Rows a block of the forward kernel takes: its scratch holds one
    partial sum a block."""
    return cuda_build.load("fused_ce").fused_ce_rows_per_block()


def _raise_if(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.fused_ce_error_string(err).decode()})")


def fused_ce_fwd(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    smoothing: float, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample loss ``[B]`` f32, the per-row logsumexp ``[B]`` f32, and
    the 0-d f32 ``scale · Σ per`` (the batch mean for ``scale = 1/B``)."""
    global FWD_LAUNCHES
    _check(logits, labels, num_active)
    if logits.device.type == "cpu":
        return fused_ce_fwd_plain(logits, labels, num_active, smoothing, scale)
    lib = cuda_build.load("fused_ce")
    b, w = logits.shape
    dev = logits.device
    per = torch.empty(b, dtype=torch.float32, device=dev)
    lse = torch.empty(b, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty(-(-b // _rows_per_block()), dtype=torch.float32, device=dev)
    err = lib.fused_ce_fwd_launch(
        dev.index, logits.data_ptr(), _DTYPE_CODES[logits.dtype], b, w, logits.stride(0),
        labels.data_ptr(), num_active.data_ptr(), smoothing, scale, per.data_ptr(),
        lse.data_ptr(), partials.data_ptr(), _ticket(dev).data_ptr(), out.data_ptr(),
        _counter(dev).data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _raise_if(err, lib, "fused_ce_fwd")
    FWD_LAUNCHES += 1
    return per, lse, out


def fused_ce_bwd(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    lse: torch.Tensor, grad: torch.Tensor, smoothing: float, scale: float,
) -> torch.Tensor:
    """``dlogits`` of ``scale · Σ per`` for the 0-d upstream ``grad``."""
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
        return fused_ce_bwd_plain(logits, labels, num_active, lse, grad, smoothing, scale)
    lib = cuda_build.load("fused_ce")
    b, w = logits.shape
    dev = logits.device
    g = grad.float()  # no copy for the f32 scalar that autograd hands in
    dx = torch.empty_like(logits)
    err = lib.fused_ce_bwd_launch(
        dev.index, logits.data_ptr(), _DTYPE_CODES[logits.dtype], b, w, logits.stride(0),
        labels.data_ptr(), num_active.data_ptr(), lse.contiguous().data_ptr(), g.data_ptr(),
        smoothing, scale, dx.data_ptr(), dx.stride(0), _counter(dev)[1:].data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    _raise_if(err, lib, "fused_ce_bwd")
    BWD_LAUNCHES += 1
    return dx


class FusedMaskedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, num_active, smoothing):
        logits = logits.contiguous()
        scale = 1.0 / logits.shape[0]
        _, lse, out = fused_ce_fwd(logits, labels, num_active, smoothing, scale)
        ctx.save_for_backward(logits, labels, num_active, lse)
        ctx.smoothing, ctx.scale = smoothing, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, labels, num_active, lse = ctx.saved_tensors
        dx = fused_ce_bwd(logits, labels, num_active, lse, grad, ctx.smoothing, ctx.scale)
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
        scale = 1.0 / (logits.shape[0] * dist.get_world_size(group))
        _, lse, out = fused_ce_fwd(logits, labels, num_active, smoothing, scale)
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(logits, labels, num_active, lse)
        ctx.smoothing, ctx.scale = smoothing, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, labels, num_active, lse = ctx.saved_tensors
        dx = fused_ce_bwd(logits, labels, num_active, lse, grad, ctx.smoothing, ctx.scale)
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

    Forward: the fused kernel on this rank's stripe with ``scale = 1/(B·N)``
    (``B`` rows a stripe, ``N`` ranks), then one all-reduce of its 0-d
    result: the value of JAX's scalar ``pmean``, the same on every rank.
    Backward: the kernel on the stripe with the same scale, so the stripe's
    ``dlogits`` are the global mean's gradient for those rows (JAX's
    ``pmean`` cotangent), with no collective.  Summing the parameter
    gradients over the ranks then gives the global gradient."""
    return ShardedFusedMaskedCrossEntropy.apply(
        logits, labels, num_active, float(label_smoothing), group
    )


register_policy_kernel("fused_masked_cross_entropy", "f32", "bf16_all", "bf16_selective")
