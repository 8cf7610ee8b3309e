"""Model layer: CIFAR ResNet backbone and the static masked CIL head."""

from .resnet import BasicBlock, BatchNorm, CifarResNet, DownsampleA, get_backbone  # noqa: F401
from .classifier import (  # noqa: F401
    NEG_INF,
    grow_head,
    masked_logits,
    torch_linear_init,
    weight_align,
)
from .cil_model import CilModel, align, create_model, grow  # noqa: F401
