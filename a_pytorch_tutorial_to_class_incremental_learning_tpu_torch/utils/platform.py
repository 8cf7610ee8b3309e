"""Device choice, float32 numerics and seeded generators.

Entry points run on CUDA unless the caller asks for the CPU: with no CUDA
device the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def resolve_device(platform: Optional[str] = None) -> torch.device:
    """``None``/``"default"``/``"cuda"`` -> the CUDA device (an error when
    there is none); ``"cpu"`` -> the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "default", "cuda"):
        raise ValueError(f"unknown platform {platform!r}; want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on CUDA by default "
            "(pass --platform cpu, or device='cpu', to run on the CPU)"
        )
    return torch.device("cuda")


def use_full_f32() -> None:
    """The f32 preset: cuDNN would run f32 convolutions in TF32 (about three
    decimal digits) by default, so TF32 is turned off for convolutions and
    matmuls alike.  Process-wide switches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def derive_seed(*coords: int) -> int:
    """A 32-bit seed that is a pure function of non-negative int coordinates
    such as ``(seed, task, epoch)``."""
    return int(np.random.SeedSequence([int(c) for c in coords]).generate_state(1)[0])


def make_generator(device: torch.device, *coords: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``coords``."""
    return torch.Generator(device=device).manual_seed(derive_seed(*coords))
