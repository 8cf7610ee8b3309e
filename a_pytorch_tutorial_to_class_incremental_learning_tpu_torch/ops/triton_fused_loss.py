"""Triton kernels for the fused masked cross-entropy (forward and backward):
the first design, kept off every path of the port.

The port's wrappers (``ops.fused_loss``) launch the CUDA C++ kernels of
``csrc/fused_ce.cu``, which took these kernels' place.  Only
``chip_smoke.py``'s kernel and timing phases call this module, to hold the
CUDA kernels against this design in the same run; its launches are counted
in this module's own ``FWD_LAUNCHES`` / ``BWD_LAUNCHES``, apart from the
wrappers' counts.

Like the CUDA kernels, they stand in for the Pallas kernels of the JAX
package's ``ops/fused_loss.py``: ``fwd_kernel`` for ``_fwd_kernel``
(``fused_loss.py:47``) and ``bwd_kernel`` for ``_bwd_kernel``
(``fused_loss.py:72``).

What bounds them: a row-wise reduction and one elementwise pass, with no
matrix product.  On the train step's shape (B=128, W=100, f32) the forward
reads about 51 KB and the backward reads and writes about 51 KB each, which
at the H100 SXM data-sheet rate (3.35 TB/s, 700 W limit) is 15-31 ns of
memory time: the launch, not the card, sets their time.

Design, against the TPU kernels: no 128-lane padding and no ``gcd(B, 256)``
batch tile.  One program per row walks the row in ``BLOCK_W``-wide chunks
(``BLOCK_W = next_pow2(min(W, 2048))``) with an online max / sum-exp, so any
head width works.  Lanes past ``W`` load as ``-inf`` (never 0), so they add
nothing to the sum; masked columns hold ``NEG_INF`` and ``exp(NEG_INF - m)``
is exactly 0 in f32, which is what makes their gradient exactly 0.  Loads
upcast to f32, so bf16 logits are taken too.  ``num_active``, the 0-d
upstream gradient and the labels (int64) are read through pointers: the
train step never syncs with the host.  The forward stores the per-row
logsumexp as the backward's residual.

``triton`` is imported, and the kernels built, on the first launch only:
importing this module needs no Triton.  The cache goes to ``build/triton``
under the repository unless ``TRITON_CACHE_DIR`` is set.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Tuple

import torch

_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "triton"
MAX_BLOCK_W = 2048

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def block_w(width: int) -> int:
    """Columns one chunk covers: the next power of two of ``min(W, 2048)``,
    at least 16."""
    return max(16, 1 << (min(width, MAX_BLOCK_W) - 1).bit_length())


def _num_warps(block: int) -> int:
    return min(8, max(1, block // 256))


@functools.cache
def _kernels():
    os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE_DIR))
    import triton
    import triton.language as tl

    @triton.jit
    def fwd_kernel(x_ptr, labels_ptr, na_ptr, per_ptr, lse_ptr,
                   W, stride_row, smoothing, BLOCK_W: tl.constexpr):
        row = tl.program_id(0)
        base = x_ptr + row.to(tl.int64) * stride_row
        na = tl.load(na_ptr)
        label = tl.load(labels_ptr + row)
        cols = tl.arange(0, BLOCK_W)
        # The first chunk always holds column 0, so its max is finite and
        # the online update below never computes -inf - -inf.
        x = tl.load(base + cols, mask=cols < W, other=float("-inf")).to(tl.float32)
        m = tl.max(x, axis=0)
        s = tl.sum(tl.exp(x - m), axis=0)
        a = tl.sum(tl.where(cols < na, x, 0.0), axis=0)
        for start in range(BLOCK_W, W, BLOCK_W):
            c = start + cols
            x = tl.load(base + c, mask=c < W, other=float("-inf")).to(tl.float32)
            m_new = tl.maximum(m, tl.max(x, axis=0))
            s = s * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new), axis=0)
            a += tl.sum(tl.where(c < na, x, 0.0), axis=0)
            m = m_new
        lse = m + tl.log(s)
        x_label = tl.load(base + label, mask=(label >= 0) & (label < W),
                          other=0.0).to(tl.float32)
        nll = lse - x_label
        # -mean of logp over the active columns = lse - mean of x over them.
        smooth = lse - a / na.to(tl.float32)
        tl.store(per_ptr + row, (1.0 - smoothing) * nll + smoothing * smooth)
        tl.store(lse_ptr + row, lse)

    @triton.jit
    def bwd_kernel(x_ptr, labels_ptr, na_ptr, lse_ptr, g_ptr, dx_ptr,
                   W, stride_row, stride_dx_row, B, smoothing,
                   BLOCK_W: tl.constexpr):
        row = tl.program_id(0)
        base = x_ptr + row.to(tl.int64) * stride_row
        out = dx_ptr + row.to(tl.int64) * stride_dx_row
        na = tl.load(na_ptr)
        label = tl.load(labels_ptr + row)
        lse = tl.load(lse_ptr + row)
        scale = tl.load(g_ptr).to(tl.float32) / B  # d(mean)/d(per-sample)
        on_label = 1.0 - smoothing
        uniform = smoothing / na.to(tl.float32)
        cols = tl.arange(0, BLOCK_W)
        for start in range(0, W, BLOCK_W):
            c = start + cols
            x = tl.load(base + c, mask=c < W, other=float("-inf")).to(tl.float32)
            p = tl.exp(x - lse)
            target = tl.where(c == label, on_label, 0.0) + tl.where(c < na, uniform, 0.0)
            dx = (p - target) * scale
            tl.store(out + c, dx.to(dx_ptr.dtype.element_ty), mask=c < W)

    return fwd_kernel, bwd_kernel


def launch_fwd(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    smoothing: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample loss ``[B]`` and logsumexp ``[B]``, both f32.  Inputs are
    checked by the caller (``ops.fused_loss._check``)."""
    global FWD_LAUNCHES
    fwd, _ = _kernels()
    b, w = logits.shape
    per = torch.empty(b, dtype=torch.float32, device=logits.device)
    lse = torch.empty(b, dtype=torch.float32, device=logits.device)
    blk = block_w(w)
    fwd[(b,)](logits, labels, num_active, per, lse, w, logits.stride(0),
              float(smoothing), BLOCK_W=blk, num_warps=_num_warps(blk))
    FWD_LAUNCHES += 1
    return per, lse


def launch_bwd(
    logits: torch.Tensor, labels: torch.Tensor, num_active: torch.Tensor,
    lse: torch.Tensor, grad: torch.Tensor, smoothing: float,
) -> torch.Tensor:
    """``dlogits [B, W]`` in the logits' dtype for an upstream 0-d ``grad``
    of the batch-mean loss."""
    global BWD_LAUNCHES
    _, bwd = _kernels()
    b, w = logits.shape
    dx = torch.empty_like(logits)
    blk = block_w(w)
    bwd[(b,)](logits, labels, num_active, lse, grad, dx, w, logits.stride(0),
              dx.stride(0), b, float(smoothing), BLOCK_W=blk,
              num_warps=_num_warps(blk))
    BWD_LAUNCHES += 1
    return dx
