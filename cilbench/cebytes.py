"""Bytes the fused masked-CE kernels must move, each input read once and
each output written once: the frozen counts of the port's kernel tables
(f32 logits ``[B, W]``, int64 labels, the int32 active count).

forward:  logits, labels, num_active -> per-row loss and log-sum-exp, the mean.
backward: logits, labels, num_active, log-sum-exp, the upstream scalar ->
          the logits' gradient."""

from __future__ import annotations


def fwd_bytes(b: int, w: int, esize: int = 4) -> int:
    return b * w * esize + b * 8 + 4 + 2 * b * 4 + 4


def bwd_bytes(b: int, w: int, esize: int = 4) -> int:
    return 2 * b * w * esize + b * 8 + 4 + b * 4 + 4


# The kernels by the names the profiler gives them, and their byte counts.
KERNEL_BYTES = {"fused_ce_fwd_sm90": fwd_bytes, "fused_ce_bwd_sm90": bwd_bytes}
