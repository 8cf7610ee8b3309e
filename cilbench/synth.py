"""Inputs made from the seed: class-structured images and a CIFAR-100
pickle tree.

The image generator is a frozen copy of the port's
``data/datasets.py:load_synthetic`` (a low-frequency template per class,
a 3-tap box blur, pixel noise, clipped to uint8), drawn on the device with
a ``torch.Generator`` in a few large calls instead of numpy's legacy
``RandomState``."""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def stream_seed(seed: int, *coords: int) -> int:
    """A 63-bit seed that is a pure function of ``seed`` and ``coords``."""
    ss = np.random.SeedSequence([int(seed) & SEED_MASK, *[int(c) for c in coords]])
    return int(ss.generate_state(2, np.uint64)[0]) & SEED_MASK


def generator(device, seed: int, *coords: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *coords))


def class_images(n_classes: int, per_class: Sequence[int], size: int, seed: int,
                 device, channels: int = 3, noise_std: float = 48.0
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One ``(x uint8 [N, size, size, C], y int64 [N])`` split per entry of
    ``per_class`` (images a class), all over the same class templates, in a
    seeded order.  Split ``k`` draws its own noise."""
    g = generator(device, seed, 0)
    lo = max(2, size // 4)
    up = -(-size // lo)
    coarse = torch.randint(0, 256, (n_classes, lo, lo, channels), generator=g,
                           device=device).float()
    templates = coarse.repeat_interleave(up, 1).repeat_interleave(up, 2)[:, :size, :size]
    for axis in (1, 2):  # separable 3-tap box blur
        templates = (templates + templates.roll(1, axis) + templates.roll(-1, axis)) / 3.0
    out = []
    for k, per in enumerate(per_class):
        gk = generator(device, seed, 1 + k)
        y = torch.arange(n_classes, device=device).repeat_interleave(per)
        y = y[torch.randperm(len(y), generator=gk, device=device)]
        x = torch.empty((len(y), size, size, channels), dtype=torch.uint8, device=device)
        for lo_i in range(0, len(y), 8192):  # bounded device memory
            yy = y[lo_i:lo_i + 8192]
            noise = torch.randn((len(yy), size, size, channels), generator=gk, device=device)
            x[lo_i:lo_i + 8192] = (templates[yy] + noise * noise_std).clamp_(0, 255).to(torch.uint8)
        out.append((x.cpu().numpy(), y.cpu().numpy().astype(np.int64)))
    return out


def write_cifar100(root: str, train: Tuple[np.ndarray, np.ndarray],
                   test: Tuple[np.ndarray, np.ndarray]) -> str:
    """The ``cifar-100-python/{train,test}`` pickles (rows of 3072 bytes,
    channel-major, ``fine_labels``) under ``root``; returns ``root``."""
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    for name, (x, y) in (("train", train), ("test", test)):
        data = np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(len(x), -1)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": [int(v) for v in y],
                         b"coarse_labels": [int(v) // 5 for v in y]}, f, protocol=4)
    return root

