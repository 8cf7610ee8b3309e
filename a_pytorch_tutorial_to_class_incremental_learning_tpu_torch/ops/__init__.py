"""Hand-written GPU kernels of the port and their plain PyTorch versions."""

from .fused_loss import (  # noqa: F401
    FusedMaskedCrossEntropy,
    fused_ce_bwd,
    fused_ce_bwd_plain,
    fused_ce_fwd,
    fused_ce_fwd_plain,
    fused_masked_cross_entropy,
    sharded_fused_masked_cross_entropy,
)
