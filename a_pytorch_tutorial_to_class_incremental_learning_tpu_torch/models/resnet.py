"""CIFAR ResNet backbone (depth 6n+2) as a torch ``nn.Module``.

Counterpart of the JAX package's ``models/resnet.py``: a 3x3 stem conv, BN,
ReLU, three stages of basic blocks at widths 16/32/64 with strides 1/2/2, a
global average pool to a ``[B, 64]`` feature.  The shortcut is option A
(``x[:, :, ::2, ::2]`` plus zero channels).  Submodules carry the flax names
(``conv_1_3x3``, ``bn_1``, ``stage_{s}_block_{i}.conv_a/bn_a/conv_b/bn_b``)
so ``utils/jax_weights.py`` maps variables one to one.

The public input is NHWC, as in the JAX package; inside, the batch is viewed
as NCHW with ``permute`` (no copy: the view has channels-last strides, which
cuDNN takes as they are).  ``forward`` takes ``train`` explicitly instead of
reading ``self.training``, mirroring ``model.apply(..., train=...)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import DataAxis
from .norm import BatchNorm, make_norm


def _conv3x3(cin: int, cout: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class DownsampleA(nn.Module):
    """Option-A shortcut: stride-2 subsample plus zero channels (no params)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, ::2, ::2]
        return torch.cat([x, torch.zeros_like(x)], dim=1)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + shortcut, ReLU after the add."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None):
        super().__init__()
        self.conv_a = _conv3x3(cin, planes, stride)
        self.bn_a = make_norm(planes, bn_group_size, axis)
        self.conv_b = _conv3x3(planes, planes, 1)
        self.bn_b = make_norm(planes, bn_group_size, axis)
        self.shortcut = DownsampleA() if downsample else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn_a(self.conv_a(x), train))
        y = self.bn_b(self.conv_b(y), train)
        residual = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(residual + y)


class CifarResNet(nn.Module):
    """6n+2 CIFAR ResNet: ``NHWC images -> [B, 64]`` features."""

    out_dim = 64

    def __init__(self, depth: int = 32, channels: int = 3,
                 generator: Optional[torch.Generator] = None,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError("depth should be one of 20, 32, 44, 56, 110")
        self.depth = depth
        self.channels = channels
        n = (depth - 2) // 6
        self.conv_1_3x3 = _conv3x3(channels, 16, 1)
        self.bn_1 = make_norm(16, bn_group_size, axis)
        self._block_names = []
        cin = 16
        for stage, (planes, stride) in enumerate(((16, 1), (32, 2), (64, 2)), start=1):
            for i in range(n):
                first = i == 0
                name = f"stage_{stage}_block_{i}"
                self.add_module(name, BasicBlock(
                    cin, planes, stride if first else 1, first and stage > 1,
                    bn_group_size, axis,
                ))
                self._block_names.append(name)
                cin = planes
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """He init over fan-out, ``N(0, sqrt(2 / (kh·kw·out)))`` untruncated,
        BN at scale 1 / bias 0 / mean 0 / var 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                std = math.sqrt(2.0 / (kh * kw * m.out_channels))
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != self.channels:
            raise ValueError(
                f"expected {self.channels}-channel NHWC input, got {tuple(x.shape)}"
            )
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn_1(self.conv_1_3x3(x), train))
        for name in self._block_names:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(2, 3))


_DEPTHS = {"resnet20": 20, "resnet32": 32, "resnet44": 44, "resnet56": 56, "resnet110": 110}


def get_backbone(name: str, generator: Optional[torch.Generator] = None,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None) -> CifarResNet:
    """Flag string -> backbone; ``bn_group_size``/``axis`` pick its BN
    (``models/norm.py``)."""
    if name.endswith("mnist"):
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet: the 1-channel backbones arrive "
            "with the MNIST data slice of the PyTorch port"
        )
    try:
        depth = _DEPTHS[name]
    except KeyError:
        raise NotImplementedError(f"Unknown backbone {name}") from None
    return CifarResNet(depth, 3, generator, bn_group_size, axis)
