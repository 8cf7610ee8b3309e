"""The training augmentation, in plain PyTorch, on given random draws.

timm 0.5.4's CIFAR recipe as the configuration states it:
``RandomCrop(32, padding=4)`` with zero fill, ``RandomHorizontalFlip(0.5)``,
RandAugment ``rand-m9-mstd0.5-inc1`` (each of ``n`` rounds picks one of 15
ops, applies it with probability ``p`` at a magnitude ``N(m, mstd)``
clipped to [0, 10], with the increasing magnitude maps and fill 128 for
the geometric ops), then ``(x - 255*mean) / (255*std)``.  Every op works in
PIL's uint8 domain: its result is rounded (half to even) and clipped
before the next.  The geometric ops map each output pixel to an input
coordinate (rotation about ``((w-1)/2, (h-1)/2)``), take the ``floor`` and
blend the four bilinear taps, a tap outside the image reading 128.

The random parameters are not drawn here: they are the ones the run drew
(``draws``: ``oy``, ``ox``, ``flip``, ``ra_op``, ``ra_mag``, ``ra_sign``,
``ra_apply``, each a tensor with the batch first), so the result can be
held against the batch the network received.  Each op is applied to the
images that picked it, one op at a time."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

FILL = 128.0
OPS = ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
       "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
       "ShearY", "TranslateXRel", "TranslateYRel")


def _col(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1)


def _round(img: torch.Tensor) -> torch.Tensor:
    return torch.round(img).clamp(0.0, 255.0)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma, rounded: ``[N, H, W, 1]``."""
    return torch.round(img[..., 0:1] * 0.299 + img[..., 1:2] * 0.587 + img[..., 2:3] * 0.114)


def _mix(base: torch.Tensor, img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance: ``base + factor * (img - base)``."""
    return base + _col(factor) * (img - base)


def _autocontrast(img, frac, sign):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    stretched = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-6))
    return torch.where(hi > lo, stretched, img)


def _equalize(img, frac, sign):
    """PIL's ``ImageOps.equalize``, one channel at a time, in integers."""
    x = img.to(torch.int64).cpu().numpy()
    out = x.copy()
    n, h, w, c = x.shape
    for i in range(n):
        for ch in range(c):
            v = x[i, :, :, ch]
            hist = np.bincount(v.ravel(), minlength=256)
            last = hist[np.nonzero(hist)[0][-1]]
            step = (h * w - last) // 255
            if step == 0:
                continue
            lut = np.minimum((step // 2 + np.cumsum(hist) - hist) // step, 255)
            out[i, :, :, ch] = lut[v]
    return torch.from_numpy(out).to(img.device, torch.float32)


def _invert(img, frac, sign):
    return 255.0 - img


def _warp(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of each image by its ``[2, 3]`` output-to-input map."""
    n, h, w, c = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    m = mat.reshape(n, 6, 1, 1)
    xin = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    yin = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    x0, y0 = torch.floor(xin), torch.floor(yin)
    wx, wy = xin - x0, yin - y0
    out = None
    for dy, dx, weight in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                           (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        yi, xi = y0 + dy, x0 + dx
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        tap = img[torch.arange(n, device=dev)[:, None, None], yc, xc]
        tap = torch.where(inside[..., None], tap, FILL)
        term = tap * weight[..., None]
        out = term if out is None else out + term
    return out


def _affine(kind: str):
    def op(img, frac, sign):
        n, h, w, _ = img.shape
        one, zero = torch.ones_like(frac), torch.zeros_like(frac)
        if kind == "rotate":
            cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
            rad = sign * frac * 30.0 * (math.pi / 180.0)
            c, s = torch.cos(rad), torch.sin(rad)
            rows = (c, -s, cx - c * cx + s * cy, s, c, cy - s * cx - c * cy)
        elif kind == "shear_x":
            rows = (one, sign * frac * 0.3, zero, zero, one, zero)
        elif kind == "shear_y":
            rows = (one, zero, zero, sign * frac * 0.3, one, zero)
        elif kind == "translate_x":
            rows = (one, zero, sign * frac * 0.45 * w, zero, one, zero)
        else:
            rows = (one, zero, zero, zero, one, sign * frac * 0.45 * h)
        return _warp(img, torch.stack(rows, -1))

    return op


def _posterize(img, frac, sign):
    shift = _col((8.0 - (4.0 - torch.floor(frac * 4.0))).int())
    return ((img.int() >> shift) << shift).float()


def _solarize(img, frac, sign):
    thresh = _col(256.0 - torch.floor(frac * 256.0))
    return torch.where(img < thresh, img, 255.0 - img)


def _solarize_add(img, frac, sign):
    add = _col(torch.floor(frac * 110.0))
    return torch.where(img < 128.0, (img + add).clamp(0, 255), img)


def _enhance(frac, sign):
    return 1.0 + sign * frac * 0.9


def _color(img, frac, sign):
    return _mix(_gray(img).expand_as(img), img, _enhance(frac, sign))


def _contrast(img, frac, sign):
    mean = torch.round(_gray(img).mean(dim=(1, 2, 3), keepdim=True))
    return _mix(mean.expand_as(img), img, _enhance(frac, sign))


def _brightness(img, frac, sign):
    return img * _col(_enhance(frac, sign))


def _sharpness(img, frac, sign):
    """Blend from PIL's SMOOTH filter (``[[1,1,1],[1,5,1],[1,1,1]] / 13``,
    rounded; the one-pixel border keeps the source)."""
    h, w = img.shape[1], img.shape[2]
    total = 4.0 * img[:, 1:-1, 1:-1]
    box = torch.zeros_like(total)
    for dy in range(3):
        for dx in range(3):
            box = box + img[:, dy:dy + h - 2, dx:dx + w - 2]
    smooth = img.clone()
    smooth[:, 1:-1, 1:-1] = torch.round((box + total) / 13.0)
    return _mix(smooth, img, _enhance(frac, sign))


APPLY = (_autocontrast, _equalize, _invert, _affine("rotate"), _posterize, _solarize,
         _solarize_add, _color, _contrast, _brightness, _sharpness, _affine("shear_x"),
         _affine("shear_y"), _affine("translate_x"), _affine("translate_y"))


def train_batch(x_u8: torch.Tensor, draws: Dict[str, torch.Tensor], *, padding: int,
                mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """``uint8 [N, H, W, C]`` and the run's draws -> the normalized
    float32 batch the network trains on."""
    extra = set(draws) - {"oy", "ox", "flip", "ra_op", "ra_mag", "ra_sign", "ra_apply"}
    if extra:
        raise ValueError(f"no plain version of the draws {sorted(extra)}")
    n, h, w, _ = x_u8.shape
    dev = x_u8.device
    d = {k: v.to(dev) for k, v in draws.items()}
    img = torch.nn.functional.pad(x_u8.float(), (0, 0, padding, padding, padding, padding))
    rows = d["oy"][:, None] + torch.arange(h, device=dev)[None, :]
    cols = d["ox"][:, None] + torch.arange(w, device=dev)[None, :]
    img = img[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    img = torch.where(_col(d["flip"].bool()), img.flip(2), img)
    for r in range(d["ra_op"].shape[1]):
        frac = d["ra_mag"][:, r] / 10.0
        for k, fn in enumerate(APPLY):
            pick = torch.nonzero((d["ra_op"][:, r] == k) & d["ra_apply"][:, r].bool())[:, 0]
            if len(pick):
                img[pick] = _round(fn(img[pick], frac[pick], d["ra_sign"][pick, r]))
    m = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (img - m) / s
