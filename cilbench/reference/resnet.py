"""The WA training step and the classifier's forward, in plain PyTorch.

The network is the CIFAR ResNet of He et al. (2016, section 4.2): a 3x3
stem of 16 channels, three stages of n basic blocks (3x3 conv, BN, ReLU,
3x3 conv, BN, the shortcut added, ReLU) at 16/32/64 channels and strides
1/2/2, option-A shortcuts (stride-2 subsample and zero channels), global
average pooling and a linear head.  BatchNorm normalizes with the batch's
biased statistics in training and the running statistics in evaluation,
eps 1e-5.  The head is masked: columns at or past the number of active
classes read -1e9.  The parameters are a dict keyed by the names the
port's ``state_dict`` uses, so one set of weights loads into both.

The WA step (Zhao et al., CVPR 2020): cross entropy over the active
classes, plus lambda times the distillation term, KL(softmax(t/T) ||
softmax(s/T)) T^2 over the teacher's classes; then SGD with momentum and
weight decay, ``buf = m*buf + g + wd*p``, ``p -= lr*buf``."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG = -1e9
Tensors = Dict[str, torch.Tensor]


def layout(depth: int = 32, channels: int = 3, width: int = 100
           ) -> Tuple[List[Tuple[str, tuple]], List[Tuple[str, tuple]]]:
    """``(parameters, buffers)``: each a list of ``(name, shape)`` in the
    order of the network."""
    n = (depth - 2) // 6
    params, buffers = [], []

    def bn(prefix, c):
        params.extend([(f"{prefix}.weight", (c,)), (f"{prefix}.bias", (c,))])
        buffers.extend([(f"{prefix}.running_mean", (c,)), (f"{prefix}.running_var", (c,))])

    params.append(("backbone.conv_1_3x3.weight", (16, channels, 3, 3)))
    bn("backbone.bn_1", 16)
    cin = 16
    for stage, planes in enumerate((16, 32, 64), start=1):
        for i in range(n):
            p = f"backbone.stage_{stage}_block_{i}"
            params.append((f"{p}.conv_a.weight", (planes, cin, 3, 3)))
            bn(f"{p}.bn_a", planes)
            params.append((f"{p}.conv_b.weight", (planes, planes, 3, 3)))
            bn(f"{p}.bn_b", planes)
            cin = planes
    params.extend([("fc.weight", (width, 64)), ("fc.bias", (width,))])
    return params, buffers


@contextlib.contextmanager
def numerics(tf32: bool):
    """Full float32 (TF32 off), or TF32 for convolutions and matmuls."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _bn(x, p: Tensors, b: Tensors, name: str, train: bool):
    if isinstance(b, StatsRecorder):
        b.record(name, x)
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"], p[f"{name}.bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, b[f"{name}.running_mean"], b[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, 1e-5)


class StatsRecorder(dict):
    """Given as ``buffers`` to a training-mode forward, keeps each BN
    layer's batch mean and biased variance as its running statistics."""

    def record(self, name: str, x: torch.Tensor) -> None:
        var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
        self[f"{name}.running_mean"] = mean
        self[f"{name}.running_var"] = var


@torch.no_grad()
def batch_statistics(p: Tensors, x_nhwc: torch.Tensor, depth: int = 32) -> Tensors:
    """Running statistics as a network that has seen batches like
    ``x_nhwc`` would hold: each BN layer's batch statistics in one
    training-mode forward."""
    rec = StatsRecorder()
    features(p, rec, x_nhwc, True, depth)
    return dict(rec)


def features(p: Tensors, b: Tensors, x_nhwc: torch.Tensor, train: bool, depth: int = 32):
    """NHWC float images -> ``[B, 64]`` pooled features."""
    n = (depth - 2) // 6
    x = x_nhwc.permute(0, 3, 1, 2)
    x = F.relu(_bn(F.conv2d(x, p["backbone.conv_1_3x3.weight"], None, 1, 1), p, b,
                   "backbone.bn_1", train))
    for stage in (1, 2, 3):
        for i in range(n):
            pre = f"backbone.stage_{stage}_block_{i}"
            stride = 2 if (stage > 1 and i == 0) else 1
            y = F.relu(_bn(F.conv2d(x, p[f"{pre}.conv_a.weight"], None, stride, 1), p, b,
                           f"{pre}.bn_a", train))
            y = _bn(F.conv2d(y, p[f"{pre}.conv_b.weight"], None, 1, 1), p, b, f"{pre}.bn_b", train)
            if stride == 2:
                s = x[:, :, ::2, ::2]
                x = torch.cat([s, torch.zeros_like(s)], dim=1)
            x = F.relu(x + y)
    return x.mean(dim=(2, 3))


def logits(p: Tensors, b: Tensors, x_nhwc, train: bool, active: int, depth: int = 32):
    out = F.linear(features(p, b, x_nhwc, train, depth), p["fc.weight"], p["fc.bias"])
    cols = torch.arange(out.shape[-1], device=out.device)
    return torch.where(cols < active, out, NEG)


def kd_loss(student, teacher, known: int, temperature: float):
    cols = torch.arange(student.shape[-1], device=student.device) < known
    s = torch.where(cols, student, NEG) / temperature
    t = torch.where(cols, teacher, NEG) / temperature
    logp_s, logp_t = F.log_softmax(s, -1), F.log_softmax(t, -1)
    kl = torch.where(cols, logp_t.exp() * (logp_t - logp_s), 0.0).sum(-1)
    return kl.mean() * temperature * temperature


def wa_steps(params: Tensors, teacher: Tuple[Tensors, Tensors], batches: Sequence,
             *, lr: float, momentum: float, weight_decay: float, lambda_kd: float,
             temperature: float, active: int, known: int, depth: int = 32) -> dict:
    """Run the steps on ``batches`` (``(x NHWC float, labels)`` each, on
    the device) from ``params``; ``teacher`` is ``(params, buffers)`` or
    None.  Returns each step's loss, the first step's raw gradient and the
    parameters after the last step (dicts keyed as ``params``)."""
    names = list(params)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    buf = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    for x, y in batches:
        out = logits(p, {}, x, True, active, depth)
        loss = F.cross_entropy(out, y)
        if teacher is not None:
            with torch.no_grad():
                t_out = logits(teacher[0], teacher[1], x, False, known, depth)
            loss = loss + lambda_kd * kd_loss(out, t_out, known, temperature)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                buf[k].mul_(momentum).add_(g).add_(p[k], alpha=weight_decay)
                p[k].sub_(lr * buf[k])
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "params": {k: v.detach() for k, v in p.items()}}


@torch.no_grad()
def classify(p: Tensors, b: Tensors, x_u8: torch.Tensor, mean: Sequence[float],
             std: Sequence[float], active: int, depth: int = 32, block: int = 64):
    """Eval-mode logits of uint8 NHWC images, normalized as
    ``(x - 255*mean) / (255*std)``, in blocks of ``block`` rows."""
    m = torch.tensor(mean, device=x_u8.device) * 255.0
    s = torch.tensor(std, device=x_u8.device) * 255.0
    outs = []
    for lo in range(0, len(x_u8), block):
        x = (x_u8[lo:lo + block].float() - m) / s
        outs.append(logits(p, b, x, False, active, depth))
    return torch.cat(outs)
