"""Model FLOPs of the CIFAR ResNet (depth 6n+2, widths 16/32/64, option-A
shortcuts, a linear head), counted from shapes.  A multiply-add is two
FLOPs; BatchNorm, ReLU, the pooling and the augmentation are not counted.
A train step costs the student's forward, its backward (twice the forward:
the input and the weight gradients) and, with a teacher, the teacher's
forward."""

from __future__ import annotations


def _out(size: int, stride: int) -> int:
    return (size + 2 - 3) // stride + 1  # 3x3, padding 1


def resnet_macs(depth: int = 32, input_size: int = 32, channels: int = 3,
                head_width: int = 100, feature_dim: int = 64) -> dict:
    """``{"conv": MACs of the convolutions, "fc": MACs of the head}`` for
    one image."""
    if (depth - 2) % 6:
        raise ValueError(f"depth {depth} is not 6n+2")
    n = (depth - 2) // 6
    size = input_size
    conv = size * size * 16 * channels * 9  # the stem
    cin = 16
    for planes, stride in ((16, 1), (32, 2), (64, 2)):
        for i in range(n):
            s = stride if i == 0 else 1
            size = _out(size, s)
            conv += size * size * planes * cin * 9   # conv_a
            conv += size * size * planes * planes * 9  # conv_b
            cin = planes
    return {"conv": conv, "fc": feature_dim * head_width}


def forward_flops(**shape) -> int:
    m = resnet_macs(**shape)
    return 2 * (m["conv"] + m["fc"])


def train_step_flops(batch: int, teacher: bool, **shape) -> int:
    """One train step's model FLOPs: forward + backward (3x the forward)
    of the student, plus the teacher's forward."""
    fwd = forward_flops(**shape)
    return batch * fwd * (4 if teacher else 3)
