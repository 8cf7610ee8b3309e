"""Batched augmentation on the device: padded random crop, flip, normalize.

The race-recipe subset of the JAX package's ``data/augment.py``
(``_random_crop``, ``_random_flip``, ``_normalize``, ``eval_preprocess``):
``RandomCrop(32, padding=4)`` with zero fill, ``RandomHorizontalFlip(0.5)``
and ``(x - 255·mean) / (255·std)``.  Images stay NHWC.  The crop offsets and
flip bits come from a ``torch.Generator`` on the batch's device, so a train
step draws them without a host round trip; the per-op functions take them as
arguments so tests can hand both frameworks the same draws.  RandAugment,
color jitter and random erasing arrive with a later slice
(``config.check_supported`` rejects them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class AugmentConfig:
    crop_padding: int = 4
    hflip: bool = True  # off for digit datasets
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)

    @classmethod
    def from_config(cls, config) -> "AugmentConfig":
        mean, std = config.normalization_stats()
        return cls(
            crop_padding=4 if config.input_size <= 32 else 0,
            hflip="mnist" not in config.data_set.lower(),
            mean=tuple(mean),
            std=tuple(std),
        )


def random_crop(
    img: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, padding: int
) -> torch.Tensor:
    """Per-image crop of the zero-padded batch ``[B,H,W,C]`` at offsets
    ``(oy[b], ox[b])`` in ``[0, 2·padding]``."""
    b, h, w, _ = img.shape
    padded = F.pad(img, (0, 0, padding, padding, padding, padding))
    dev = img.device
    rows = (oy[:, None] + torch.arange(h, device=dev))[:, :, None]
    cols = (ox[:, None] + torch.arange(w, device=dev))[:, None, :]
    return padded[torch.arange(b, device=dev)[:, None, None], rows, cols]


def random_flip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the images whose ``flip`` bit is set (``[B]`` bool)."""
    return torch.where(flip[:, None, None, None], img.flip(2), img)


def normalize(img: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=img.device) * 255.0
    std = torch.tensor(cfg.std, dtype=torch.float32, device=img.device) * 255.0
    return (img - mean) / std


def draw_params(
    batch: int, cfg: AugmentConfig, generator: torch.Generator
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Crop offsets ``oy, ox`` and flip bits for one batch, drawn on the
    generator's device (None for an op the config turns off)."""
    dev = generator.device
    oy = ox = flip = None
    if cfg.crop_padding > 0:
        span = 2 * cfg.crop_padding + 1
        oy = torch.randint(0, span, (batch,), generator=generator, device=dev)
        ox = torch.randint(0, span, (batch,), generator=generator, device=dev)
    if cfg.hflip:
        flip = torch.randint(0, 2, (batch,), generator=generator, device=dev).bool()
    return oy, ox, flip


def train_augment(
    batch_u8: torch.Tensor, cfg: AugmentConfig, generator: torch.Generator,
    process_index: int = 0, process_count: int = 1,
) -> torch.Tensor:
    """``uint8 [B,H,W,C] -> normalized float32 [B,H,W,C]`` train pipeline.

    ``batch_u8`` is stripe ``process_index`` of a global batch of
    ``B·process_count`` rows.  The parameters are drawn for the whole global
    batch, as JAX splits one key over it, and the stripe's rows kept: every
    process seeds its generator alike, so N processes augment exactly as one
    process does at the same global batch."""
    img = batch_u8.float()
    b = img.shape[0]
    rows = slice(process_index * b, (process_index + 1) * b)
    oy, ox, flip = (None if p is None else p[rows]
                    for p in draw_params(b * process_count, cfg, generator))
    if oy is not None:
        img = random_crop(img, oy, ox, cfg.crop_padding)
    if flip is not None:
        img = random_flip(img, flip)
    return normalize(img, cfg)


def eval_preprocess(batch_u8: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """Eval path: normalize only."""
    return normalize(batch_u8.float(), cfg)
