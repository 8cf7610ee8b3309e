"""Device choice, float32 numerics and seeded generators.

Entry points run on CUDA unless the caller asks for the CPU: with no CUDA
device the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(platform: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None``/``"default"``/``"cuda"`` -> the CUDA device (an error when
    there is none); ``"cpu"`` -> the CPU; a ``torch.device`` as it is (a
    CUDA one only where CUDA is available).

    Under a launcher that sets ``LOCAL_RANK`` (``torchrun``), the process
    takes card ``LOCAL_RANK`` and makes it the current device; a rank
    without a card of its own is an error, never a second tenant of
    another rank's card."""
    if isinstance(platform, torch.device):
        if platform.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is available for {platform}")
        return platform
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "default", "cuda"):
        raise ValueError(f"unknown platform {platform!r}; want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on CUDA by default "
            "(pass --platform cpu, or device='cpu', to run on the CPU)"
        )
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device("cuda")
    index, count = int(local), torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"LOCAL_RANK {index} has no CUDA device: this node has {count}; "
            f"launch at most {count} process(es) per node"
        )
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def use_full_f32() -> None:
    """Full f32 wherever a preset computes in f32 (all of ``f32``, and
    everything but the bf16 operands of the others): cuDNN would run f32
    convolutions in TF32 (about three decimal digits) by default, so TF32
    is turned off for convolutions and matmuls alike.  Process-wide
    switches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def derive_seed(*coords: int) -> int:
    """A 32-bit seed that is a pure function of non-negative int coordinates
    such as ``(seed, task, epoch)``."""
    return int(np.random.SeedSequence([int(c) for c in coords]).generate_state(1)[0])


def make_generator(device: torch.device, *coords: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``coords``."""
    return torch.Generator(device=device).manual_seed(derive_seed(*coords))
