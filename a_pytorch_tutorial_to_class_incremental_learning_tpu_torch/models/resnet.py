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

A precision policy (``ops/precision.py``) sets two dtypes, cast at the JAX
package's cast points: the input is cast to ``act_dtype``; each convolution
runs on ``compute_dtype`` operands (its f32 weight cast at the call) and
its output is cast to ``act_dtype`` before BatchNorm; BatchNorm, ReLU, the
residual add and the pooling run in ``act_dtype`` (BatchNorm's statistics in
f32); the pooled feature is f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.precision import PRESETS, Policy
from ..parallel.mesh import DataAxis
from ..utils import jax_random
from .norm import BatchNorm, make_norm, stats_dtype


class Conv2d(nn.Conv2d):
    """3x3 convolution, padding 1, no bias, whose operands are cast to
    ``compute_dtype`` at the call (flax ``nn.Conv(dtype=...)``); the
    parameter stays f32 and the output is in ``compute_dtype``."""

    def __init__(self, cin: int, cout: int, stride: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return self._conv_forward(x.to(cd), self.weight.to(cd), None)


class DownsampleA(nn.Module):
    """Option-A shortcut: stride-2 subsample plus zero channels (no params)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, ::2, ::2]
        return torch.cat([x, torch.zeros_like(x)], dim=1)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + shortcut, ReLU after the add."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_a = Conv2d(cin, planes, stride, compute_dtype)
        self.bn_a = make_norm(planes, bn_group_size, axis)
        self.conv_b = Conv2d(planes, planes, 1, compute_dtype)
        self.bn_b = make_norm(planes, bn_group_size, axis)
        self.shortcut = DownsampleA() if downsample else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        act = x.dtype
        y = F.relu(self.bn_a(self.conv_a(x).to(act), train))
        y = self.bn_b(self.conv_b(y).to(act), train)
        residual = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(residual + y)


class CifarResNet(nn.Module):
    """6n+2 CIFAR ResNet: ``NHWC images -> [B, 64]`` features."""

    out_dim = 64

    def __init__(self, depth: int = 32, channels: int = 3,
                 key: Optional[jax_random.Key] = None, scope: Sequence[str] = (),
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 policy: Policy = PRESETS["f32"]):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError("depth should be one of 20, 32, 44, 56, 110")
        self.depth = depth
        self.channels = channels
        self.act_dtype = policy.act_dtype
        n = (depth - 2) // 6
        self.conv_1_3x3 = Conv2d(channels, 16, 1, policy.compute_dtype)
        self.bn_1 = make_norm(16, bn_group_size, axis)
        self._block_names = []
        cin = 16
        for stage, (planes, stride) in enumerate(((16, 1), (32, 2), (64, 2)), start=1):
            for i in range(n):
                first = i == 0
                name = f"stage_{stage}_block_{i}"
                self.add_module(name, BasicBlock(
                    cin, planes, stride if first else 1, first and stage > 1,
                    bn_group_size, axis, policy.compute_dtype,
                ))
                self._block_names.append(name)
                cin = planes
        self.reset_parameters(jax_random.key(0) if key is None else key, scope)

    @torch.no_grad()
    def reset_parameters(self, key: jax_random.Key, scope: Sequence[str] = ()) -> None:
        """flax's ``init`` of this backbone from the ``params`` key ``key``,
        the backbone being the flax module at path ``scope``: each conv
        kernel He normal over fan-out, ``N(0, sqrt(2 / (kh·kw·out)))``
        untruncated (JAX ``models/resnet.py:46-50``), drawn as JAX draws it
        from its parameter's key (``utils/jax_random.py``) and turned from
        ``HWIO`` to ``OIHW``; BN at scale 1 / bias 0 / mean 0 / var 1.  The
        default key, ``PRNGKey(0)`` at the root, is JAX's
        ``CifarResNet().init(PRNGKey(0), x)``."""
        for name, m in self.named_modules():
            if isinstance(m, Conv2d):
                k = jax_random.param_key(key, (*scope, *name.split(".")))
                kh, kw = m.kernel_size
                w = jax_random.he_normal_fan_out(k, (kh, kw, m.in_channels, m.out_channels))
                m.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """NHWC images -> the first block's NCHW input, in ``act_dtype``."""
        if x.dim() != 4 or x.shape[-1] != self.channels:
            raise ValueError(
                f"expected {self.channels}-channel NHWC input, got {tuple(x.shape)}"
            )
        x = x.permute(0, 3, 1, 2).to(self.act_dtype)
        return F.relu(self.bn_1(self.conv_1_3x3(x).to(self.act_dtype), train))

    def blocks(self):
        return [getattr(self, name) for name in self._block_names]

    @staticmethod
    def pool(x: torch.Tensor) -> torch.Tensor:
        """Global average pool (in ``act_dtype``) to the ``[B, 64]`` feature,
        f32 (or wider, for a float64 reference model)."""
        return x.mean(dim=(2, 3)).to(stats_dtype(x.dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.stem(x, train)
        for block in self.blocks():
            x = block(x, train)
        return self.pool(x)


# Flag string -> (depth, input channels): the JAX package's factory table
# (JAX ``models/resnet.py:209-226``).  ``resnet10mnist`` is there too, but
# depth 10 is not 6n+2, so both packages refuse to build it.
_BACKBONES = {
    "resnet20": (20, 3), "resnet32": (32, 3), "resnet44": (44, 3), "resnet56": (56, 3),
    "resnet110": (110, 3),
    "resnet10mnist": (10, 1), "resnet20mnist": (20, 1), "resnet32mnist": (32, 1),
}


def backbone_channels(name: str) -> int:
    """The input channels of backbone ``name`` (JAX's trainer: 1 for the
    ``*mnist`` family, else 3)."""
    return 1 if "mnist" in name else 3


def get_backbone(name: str, key: Optional[jax_random.Key] = None, scope: Sequence[str] = (),
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 policy: Policy = PRESETS["f32"]) -> CifarResNet:
    """Flag string -> backbone, initialized from ``key`` at flax path
    ``scope`` (:meth:`CifarResNet.reset_parameters`); ``bn_group_size``/
    ``axis`` pick its BN (``models/norm.py``), ``policy`` its dtypes."""
    try:
        depth, channels = _BACKBONES[name]
    except KeyError:
        raise NotImplementedError(f"Unknown backbone {name}") from None
    return CifarResNet(depth, channels, key, scope, bn_group_size, axis, policy)
