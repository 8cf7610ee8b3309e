"""A network's weights made from the seed on the device, in two large
draws: convolutions He normal over fan-out, BatchNorm scales near 1 and
shifts near 0, head rows below ``active`` as ``nn.Linear``'s uniform init
and zero above it (rows of classes not yet seen).  The running statistics
are those of one training-mode forward over seeded images normalized as
the cell normalizes its inputs, so an evaluation-mode forward (the
teacher's) stays in range as a trained network's does."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .reference.resnet import batch_statistics, layout
from .synth import generator


def draw(seed: int, stream: int, device, *, depth: int, channels: int, width: int,
         active: int, input_size: int, mean, std
         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, buffers)`` float32 on ``device``, keyed by the port's
    ``state_dict`` names."""
    params, buffers = layout(depth, channels, width)
    total = sum(math.prod(s) for _, s in params + buffers)
    g = generator(device, seed, 0xBE11, stream)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out_p, out_b, at = {}, {}, 0
    for name, shape in params + buffers:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if name.endswith("conv_1_3x3.weight") or ".conv_" in name:
            t = z * math.sqrt(2.0 / (9 * shape[0]))
        elif "running" in name:
            t = z  # drawn to keep the stream's layout; replaced by batch statistics below
        elif name.startswith("fc."):
            bound = 1.0 / math.sqrt(64)
            t = (2 * u - 1) * bound
            t[active:] = 0.0
        elif name.endswith(".weight"):  # BatchNorm scale
            t = 1.0 + 0.1 * z
        else:  # BatchNorm shift
            t = 0.1 * z
        (out_b if "running" in name else out_p)[name] = t.contiguous()
    x = torch.randint(0, 256, (64, input_size, input_size, channels), generator=g,
                      device=device).float()
    x = (x - torch.tensor(mean, device=device) * 255.0) / (torch.tensor(std, device=device) * 255.0)
    out_b = batch_statistics(out_p, x, depth)
    return out_p, out_b


def head_rows(params: Dict[str, torch.Tensor], rows: int) -> Dict[str, torch.Tensor]:
    """``params`` with the head's rows at or past ``rows`` zero: the model
    as it was before the later classes' rows grew."""
    out = dict(params)
    for k in ("fc.weight", "fc.bias"):
        out[k] = params[k].clone()
        out[k][rows:] = 0.0
    return out
