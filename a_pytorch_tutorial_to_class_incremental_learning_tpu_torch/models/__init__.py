"""Model layer: CIFAR ResNet backbone and the static masked CIL head."""

from .norm import BatchNorm, GroupedBatchNorm, group_span, make_norm  # noqa: F401
from .resnet import BasicBlock, CifarResNet, DownsampleA, get_backbone  # noqa: F401
from .classifier import (  # noqa: F401
    NEG_INF,
    grow_head,
    masked_logits,
    torch_linear_init,
    weight_align,
)
from .cil_model import CilModel, align, create_model, freeze_mask, grow, round_up  # noqa: F401
