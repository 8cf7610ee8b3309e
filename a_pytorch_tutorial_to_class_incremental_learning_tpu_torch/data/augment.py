"""Batched augmentation on the device: crop, flip, RandAugment, colour
jitter, normalize, random erasing.

Counterpart of the JAX package's ``data/augment.py``, with timm 0.5.4's
semantics as that module documents them: ``RandomCrop(32, padding=4)`` with
zero fill, ``RandomHorizontalFlip(0.5)``, then RandAugment (the parser's
default ``rand-m9-mstd0.5-inc1``: ``n`` rounds, each picking one of 15 ops,
applied with probability ``p``, magnitude ``N(m, mstd)`` clipped to [0, 10],
the increasing magnitude maps, fill 128 for the geometric ops) or, only
when RandAugment is off, colour jitter; then ``(x - 255·mean) / (255·std)``
and random erasing in the normalized domain.  Every op works in PIL's
uint8 domain: the result is rounded and clipped after each one.

Images stay NHWC float on the batch's device.  Every random parameter is
drawn up front by :func:`draw_params` from a ``torch.Generator`` on that
device, and every op takes its parameters as per-image tensors, so a test
can hand both frameworks the same draws.  No op groups images by their
draw: as JAX's vmapped ``lax.switch`` does, a RandAugment round computes
every op for every image and keeps each image's own, with one shared warp
serving the five geometric ops (the matrix is chosen per image).  Nothing
here reads a device value on the host (no boolean-mask indexing, no
``nonzero``, no ``bincount``), so a train step enqueues its augmentation
without waiting for the card.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

FILL = 128.0  # timm's geometric fill colour (128, 128, 128)
NUM_RA_OPS = 15
# The op table of the "rand" policy, in its order (JAX ``_ra_apply``).
RA_OPS = ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
          "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
          "ShearY", "TranslateXRel", "TranslateYRel")
GEOMETRIC_OPS = (3, 11, 12, 13, 14)


@dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation knobs; the fields and defaults of the JAX
    package's ``AugmentConfig``."""

    input_size: int = 32
    crop_padding: int = 4
    hflip: bool = True  # off for digit datasets (mirroring is label noise)
    rand_augment: bool = True
    ra_num_ops: int = 2
    ra_magnitude: float = 9.0
    ra_mag_std: float = 0.5
    ra_prob: float = 0.5  # per-op apply probability (timm AugmentOp default)
    # Geometric resampling: "bilinear" | "bicubic" | "random" (each applied
    # op picks one of the two, timm's no-hint default).
    ra_interpolation: str = "bilinear"
    color_jitter: float = 0.4  # used only when rand_augment is False
    reprob: float = 0.0
    remode: str = "pixel"  # timm modes: pixel | rand | const
    recount: int = 1
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)

    @classmethod
    def from_config(cls, config) -> "AugmentConfig":
        mean, std = config.normalization_stats()
        ra = parse_rand_augment(config.aa)
        return cls(
            input_size=config.input_size,
            crop_padding=4 if config.input_size <= 32 else 0,
            hflip="mnist" not in config.data_set.lower(),
            rand_augment=ra is not None,
            ra_magnitude=ra["m"] if ra else 9.0,
            ra_num_ops=ra["n"] if ra else 2,
            ra_mag_std=ra["mstd"] if ra else 0.5,
            ra_prob=ra["p"] if ra else 0.5,
            ra_interpolation=config.ra_interpolation,
            color_jitter=config.color_jitter or 0.0,
            reprob=config.reprob,
            remode=config.remode,
            recount=config.recount,
            mean=tuple(mean),
            std=tuple(std),
        )


def parse_rand_augment(aa: Optional[str]) -> Optional[dict]:
    """A timm RandAugment policy string (``rand-m9-mstd0.5-inc1``) ->
    ``{"m", "n", "mstd", "p"}``; None for no policy.  The JAX package's
    grammar: ``m`` magnitude, ``n`` ops per image, ``mstd`` magnitude noise,
    ``p`` per-op probability, ``inc`` increasing maps (always on; ``inc0``
    raises), ``w`` accepted and ignored.  Other policies raise."""
    if not aa or aa in ("none", "None"):
        return None
    parts = aa.split("-")
    if parts[0] != "rand":
        raise NotImplementedError(f"auto_augment policy {aa!r} not supported (only 'rand-*')")
    out = {"m": 9.0, "n": 2, "mstd": 0.5, "p": 0.5}
    for tok in parts[1:]:
        for key, typ in (("mstd", float), ("inc", int), ("m", float), ("n", int),
                         ("p", float), ("w", int)):
            if tok.startswith(key):
                val = typ(tok[len(key):])
                if key == "inc":
                    if not val:
                        raise NotImplementedError(
                            "non-increasing magnitude maps (inc0) not implemented")
                elif key != "w":  # weighted op choice: only w0 (uniform) exists
                    out[key] = val
                break
        else:
            raise ValueError(f"unparsable token {tok!r} in aa policy {aa!r}")
    return out


def _b(t: torch.Tensor) -> torch.Tensor:
    """A per-image ``[B]`` tensor broadcast over ``[B, H, W, C]``."""
    return t.reshape(-1, 1, 1, 1)


def round_u8(img: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 quantization between ops (round half to even, as
    ``jnp.round``)."""
    return torch.round(img).clamp_(0.0, 255.0)


# --------------------------------------------------------------------------- #
# Crop and flip
# --------------------------------------------------------------------------- #


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
    return torch.where(_b(flip), img.flip(2), img)


# --------------------------------------------------------------------------- #
# Geometric ops: one affine warp, output -> input coordinates
# --------------------------------------------------------------------------- #


def cubic_weight(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution with a = -1: PIL Geometry.c's bicubic (the
    transform/rotate path of timm's geometric ops), not Resample.c's -0.5."""
    a = -1.0
    at = t.abs()
    near = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    far = a * (((at - 5.0) * at + 8.0) * at - 4.0)
    return torch.where(at <= 1.0, near, torch.where(at < 2.0, far, 0.0))


def affine(img: torch.Tensor, mat: torch.Tensor, kernel: str = "bilinear") -> torch.Tensor:
    """Warp each image ``[B,H,W,C]`` by its 2x3 matrix ``mat[b]`` (output
    pixel -> input pixel): ``floor`` of the input coordinate, taps outside
    the image read ``FILL``, 4 bilinear or 16 bicubic taps summed in the
    JAX package's order.  All taps come from one gather."""
    if kernel not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resampling kernel {kernel!r}")
    b, h, w, c = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    m = mat.reshape(b, 6, 1, 1)
    xin = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    yin = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    x0, y0 = torch.floor(xin), torch.floor(yin)
    wx, wy = xin - x0, yin - y0
    # Tap t sits at (y0 + dy, x0 + dx): bilinear dy, dx in {0, 1}, bicubic
    # in {-1, 0, 1, 2}, row-major.
    k, first = (2, 0.0) if kernel == "bilinear" else (4, -1.0)
    t = torch.arange(k * k, dtype=torch.float32, device=dev)
    dy, dx = torch.div(t, k, rounding_mode="floor") + first, t % k + first
    yi = y0[:, None] + dy[None, :, None, None]  # [B, T, H, W]
    xi = x0[:, None] + dx[None, :, None, None]
    valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(b, -1, 1)
    px = img.reshape(b, h * w, c).gather(1, flat.expand(-1, -1, c))
    px = torch.where(valid[..., None], px.reshape(b, k * k, h, w, c), FILL)
    if kernel == "bilinear":
        weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    else:
        cy = [cubic_weight(wy - d) for d in (-1, 0, 1, 2)]
        cx = [cubic_weight(wx - d) for d in (-1, 0, 1, 2)]
        weights = [cx[i % 4] * cy[i // 4] for i in range(16)]
    out = px[:, 0] * weights[0][..., None]
    for i in range(1, k * k):
        out = out + px[:, i] * weights[i][..., None]
    return out


def geom_matrix(op: torch.Tensor, frac: torch.Tensor, sign: torch.Tensor,
                size: int, hw: Tuple[int, int]) -> torch.Tensor:
    """Per-image ``[B, 2, 3]`` matrix of the geometric op ``op[b]`` at
    magnitude ``frac[b]`` (in [0, 1]) and ``sign[b]``: rotate by 30°·frac
    about the centre, shear by 0.3·frac, translate by 0.45·frac·size
    pixels; the identity for every other op."""
    h, w = hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rad = sign * frac * 30.0 * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    v = sign * frac * 0.3
    px = sign * frac * 0.45 * size
    one, zero = torch.ones_like(frac), torch.zeros_like(frac)
    mats = torch.stack([torch.stack(m, -1) for m in (
        (one, zero, zero, zero, one, zero),  # identity
        (c, -s, cx - c * cx + s * cy, s, c, cy - s * cx - c * cy),  # 3: Rotate
        (one, v, zero, zero, one, zero),     # 11: ShearX
        (one, zero, zero, v, one, zero),     # 12: ShearY
        (one, zero, px, zero, one, zero),    # 13: TranslateXRel
        (one, zero, zero, zero, one, px),    # 14: TranslateYRel
    )], 1)
    which = (op == 3).long() + (op > 10).long() * (op - 9)
    return mats[torch.arange(op.shape[0], device=op.device), which].reshape(-1, 2, 3)


# --------------------------------------------------------------------------- #
# Colour and histogram ops (PIL ImageOps / ImageEnhance semantics)
# --------------------------------------------------------------------------- #


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma (PIL ``convert('L')``), rounded; ``[B,H,W,1]``."""
    if img.shape[-1] == 1:
        return img
    g = img[..., 0:1] * 0.299 + img[..., 1:2] * 0.587 + img[..., 2:3] * 0.114
    return torch.round(g)


def blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ``Image.blend`` / ImageEnhance: ``a + factor·(b - a)``."""
    return a + factor * (b - a)


def color(img, factor, gray=None):
    """Saturation: blend from the grey image; ``factor`` is ``[B]``."""
    gray = grayscale(img) if gray is None else gray
    return blend(gray.expand_as(img), img, _b(factor))


def contrast(img, factor, gray=None):
    """Blend from the image's mean grey level (the rounded mean of the
    rounded grey)."""
    gray = grayscale(img) if gray is None else gray
    mean = torch.round(gray.mean(dim=(1, 2, 3), keepdim=True))
    return blend(mean.expand_as(img), img, _b(factor))


def brightness(img, factor):
    return img * _b(factor)


def sharpness(img, factor):
    """Blend from PIL's SMOOTH filter (3x3 ``[[1,1,1],[1,5,1],[1,1,1]]/13``,
    rounded, the border copied from the source).  The integer sum is exact
    in f32 and ``n/13`` is never a half, so the rounded filter is exact."""
    box = img[:, :, :-2] + img[:, :, 1:-1] + img[:, :, 2:]
    box = box[:, :-2] + box[:, 1:-1] + box[:, 2:]
    inner = torch.round((box + 4.0 * img[:, 1:-1, 1:-1]) / 13.0)
    smoothed = F.pad(inner, (0, 0, 1, 1, 1, 1))
    h, w = img.shape[1], img.shape[2]
    dev = img.device
    border = ((torch.arange(h, device=dev)[:, None] % (h - 1) == 0)
              | (torch.arange(w, device=dev)[None, :] % (w - 1) == 0))
    smoothed = torch.where(border[..., None], img, smoothed)
    return blend(smoothed, img, _b(factor))


def invert(img):
    return 255.0 - img


def solarize(img, thresh):
    return torch.where(img < _b(thresh), img, 255.0 - img)


def solarize_add(img, add):
    return torch.where(img < 128.0, (img + _b(add)).clamp(0, 255), img)


def posterize(img, bits):
    """Keep the top ``bits[b]`` bits of each (integer-valued) pixel."""
    shift = _b((8.0 - bits).int())
    return ((img.int() >> shift) << shift).float()


def autocontrast(img):
    """PIL autocontrast (cutoff 0): each channel's [min, max] -> [0, 255];
    a flat channel stays as it is."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    out = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-6))
    return torch.where(hi > lo, out, img)


def equalize(img):
    """PIL ``ImageOps.equalize`` per channel, in integers: 256-bin
    histograms of the ``B·C`` channels (``scatter_add_``), ``step =
    (npixels - count of the last non-empty bin) // 255``, LUT ``(step//2 +
    exclusive cumsum) // max(step, 1)``; the identity where ``step == 0``."""
    b, h, w, c = img.shape
    levels = img.permute(0, 3, 1, 2).reshape(b * c, h * w).long()
    hist = torch.zeros(b * c, 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, levels, torch.ones_like(levels))
    last_nz = 255 - (hist > 0).flip(1).int().argmax(1, keepdim=True)
    step = (h * w - hist.gather(1, last_nz)) // 255
    csum = hist.cumsum(1) - hist
    lut = ((step // 2 + csum) // step.clamp(min=1)).clamp(0, 255)
    mapped = torch.where(step > 0, lut.gather(1, levels), levels)
    return mapped.reshape(b, c, h, w).permute(0, 2, 3, 1).float()


# --------------------------------------------------------------------------- #
# RandAugment
# --------------------------------------------------------------------------- #


def ra_apply(img: torch.Tensor, op: torch.Tensor, magnitude: torch.Tensor,
             sign: torch.Tensor, size: int, interpolation: str = "bilinear",
             use_bicubic: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply op ``op[b]`` (index into :data:`RA_OPS`) at ``magnitude[b]``
    (in [0, 10]) and ``sign[b]`` (±1) to image ``b``, then round to uint8
    levels.  Every op is computed for the whole batch and each image keeps
    its own; ``use_bicubic[b]`` picks the kernel under ``"random"``."""
    frac = magnitude / 10.0
    mat = geom_matrix(op, frac, sign, size, img.shape[1:3])
    if interpolation == "random":
        warped = torch.where(_b(use_bicubic), affine(img, mat, "bicubic"),
                             affine(img, mat, "bilinear"))
    else:
        warped = affine(img, mat, interpolation)
    gray = grayscale(img)
    enhance = 1.0 + sign * frac * 0.9
    outs = torch.stack([
        autocontrast(img),
        equalize(img),
        invert(img),
        warped,  # Rotate, ShearX, ShearY, TranslateXRel, TranslateYRel
        posterize(img, 4.0 - torch.floor(frac * 4.0)),
        solarize(img, 256.0 - torch.floor(frac * 256.0)),
        solarize_add(img, torch.floor(frac * 110.0)),
        color(img, enhance, gray),
        contrast(img, enhance, gray),
        brightness(img, enhance),
        sharpness(img, enhance),
    ])
    branch = torch.where(op > 10, 3, op)  # the geometric ops share the warp
    return round_u8(outs[branch, torch.arange(img.shape[0], device=img.device)])


def rand_augment(img: torch.Tensor, op, magnitude, sign, apply, use_bicubic,
                 cfg: AugmentConfig) -> torch.Tensor:
    """``cfg.ra_num_ops`` rounds; round ``i`` applies ``op[:, i]`` to the
    images whose ``apply[:, i]`` is set (all parameters ``[B, n]``)."""
    for i in range(cfg.ra_num_ops):
        applied = ra_apply(img, op[:, i], magnitude[:, i], sign[:, i], cfg.input_size,
                           cfg.ra_interpolation,
                           None if use_bicubic is None else use_bicubic[:, i])
        img = torch.where(_b(apply[:, i]), applied, img)
    return img


# --------------------------------------------------------------------------- #
# Colour jitter, normalize, random erasing
# --------------------------------------------------------------------------- #


def color_jitter(img: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(brightness=contrast=saturation=s) in the JAX
    package's fixed order, rounding after each; ``factors`` ``[B, 3]``."""
    img = round_u8(brightness(img, factors[:, 0]))
    img = round_u8(contrast(img, factors[:, 1]))
    return round_u8(color(img, factors[:, 2]))


def _make_normalize_consts(mean, std, device):
    m = torch.tensor(mean, dtype=torch.float32) * 255.0
    s = torch.tensor(std, dtype=torch.float32) * 255.0
    return m.to(device), s.to(device)


_cached_normalize_consts = functools.lru_cache(maxsize=None)(_make_normalize_consts)


def _normalize_consts(mean, std, device):
    """``255·mean`` and ``255·std`` on ``device``, made once (a fresh copy
    from the host each call would wait for the card).  Under tracing
    (``torch.export``, ``torch.compile``) they are made afresh and never
    cached: a traced call makes symbolic tensors, which would poison every
    later eager call of the process."""
    if torch.compiler.is_compiling():
        return _make_normalize_consts(mean, std, device)
    return _cached_normalize_consts(mean, std, device)


def normalize(img: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    mean, std = _normalize_consts(tuple(cfg.mean), tuple(cfg.std), img.device)
    return (img - mean) / std


def random_erasing(img: torch.Tensor, do, area, log_ratio, oy, ox, noise,
                   cfg: AugmentConfig) -> torch.Tensor:
    """timm RandomErasing on the normalized batch, ``cfg.recount`` rounds
    (parameters ``[B, recount]``): a rectangle of ``area[b]`` pixels and
    aspect ``exp(log_ratio[b])`` at ``(oy[b], ox[b])``, clipped at the
    image edge, filled with per-pixel noise (``pixel``), one value a
    channel (``rand``) or zeros (``const``)."""
    if cfg.remode not in ("pixel", "rand", "const"):
        raise ValueError(f"unknown random-erasing mode {cfg.remode!r}")
    _, h, w, _ = img.shape
    dev = img.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    for i in range(cfg.recount):
        ratio = torch.exp(log_ratio[:, i])
        eh = torch.round(torch.sqrt(area[:, i] * ratio)).clamp(1, h).int()[:, None, None]
        ew = torch.round(torch.sqrt(area[:, i] / ratio)).clamp(1, w).int()[:, None, None]
        y0, x0 = oy[:, i, None, None], ox[:, i, None, None]
        inside = (ys >= y0) & (ys < y0 + eh) & (xs >= x0) & (xs < x0 + ew)
        if cfg.remode == "pixel":
            fill = noise[:, i]
        elif cfg.remode == "rand":
            fill = noise[:, i, None, None, :]
        else:
            fill = 0.0
        img = torch.where((inside & do[:, i, None, None])[..., None], fill, img)
    return img


# --------------------------------------------------------------------------- #
# Draws and the pipeline
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Draws:
    """Every random parameter of one batch, batch dimension first (None for
    an op the config turns off).  ``ra_*`` and ``erase_*`` are ``[B, n]``
    (rounds); ``jitter`` is ``[B, 3]`` (brightness, contrast, saturation);
    ``erase_noise`` is ``[B, n, H, W, C]`` (pixel) or ``[B, n, C]`` (rand)."""

    oy: Optional[torch.Tensor] = None
    ox: Optional[torch.Tensor] = None
    flip: Optional[torch.Tensor] = None
    ra_op: Optional[torch.Tensor] = None
    ra_mag: Optional[torch.Tensor] = None
    ra_sign: Optional[torch.Tensor] = None
    ra_apply: Optional[torch.Tensor] = None
    ra_bicubic: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None
    erase_do: Optional[torch.Tensor] = None
    erase_area: Optional[torch.Tensor] = None
    erase_log_ratio: Optional[torch.Tensor] = None
    erase_oy: Optional[torch.Tensor] = None
    erase_ox: Optional[torch.Tensor] = None
    erase_noise: Optional[torch.Tensor] = None

    def rows(self, rows: slice) -> "Draws":
        """The draws of the images ``rows``."""
        return replace(self, **{f.name: getattr(self, f.name)[rows] for f in fields(self)
                                if getattr(self, f.name) is not None})


def draw_params(batch: int, cfg: AugmentConfig, generator: torch.Generator,
                image_shape: Tuple[int, int, int]) -> Draws:
    """Every random parameter for ``batch`` images of ``image_shape``
    ``(H, W, C)``, drawn on the generator's device in a fixed order (crop,
    flip, then RandAugment or colour jitter, then erasing)."""
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    d = {}
    if cfg.crop_padding > 0:
        span = 2 * cfg.crop_padding + 1
        d["oy"] = torch.randint(0, span, (batch,), **kw)
        d["ox"] = torch.randint(0, span, (batch,), **kw)
    if cfg.hflip:
        d["flip"] = torch.randint(0, 2, (batch,), **kw).bool()
    if cfg.rand_augment:
        n = cfg.ra_num_ops
        d["ra_op"] = torch.randint(0, NUM_RA_OPS, (batch, n), **kw)
        d["ra_mag"] = (cfg.ra_magnitude + cfg.ra_mag_std * torch.randn(batch, n, **kw)
                       ).clamp(0.0, 10.0)
        d["ra_sign"] = torch.where(torch.rand(batch, n, **kw) < 0.5, 1.0, -1.0)
        d["ra_apply"] = torch.rand(batch, n, **kw) < cfg.ra_prob
        if cfg.ra_interpolation == "random":
            d["ra_bicubic"] = torch.rand(batch, n, **kw) < 0.5
    elif cfg.color_jitter > 0:
        lo, hi = max(0.0, 1.0 - cfg.color_jitter), 1.0 + cfg.color_jitter
        d["jitter"] = lo + (hi - lo) * torch.rand(batch, 3, **kw)
    if cfg.reprob > 0:
        h, w, c = image_shape
        n = cfg.recount
        d["erase_do"] = torch.rand(batch, n, **kw) < cfg.reprob
        d["erase_area"] = h * w * (0.02 + (1 / 3 - 0.02) * torch.rand(batch, n, **kw))
        lo, hi = math.log(0.3), math.log(10 / 3)
        d["erase_log_ratio"] = lo + (hi - lo) * torch.rand(batch, n, **kw)
        d["erase_oy"] = torch.randint(0, h, (batch, n), **kw)
        d["erase_ox"] = torch.randint(0, w, (batch, n), **kw)
        if cfg.remode == "pixel":
            d["erase_noise"] = torch.randn(batch, n, h, w, c, **kw)
        elif cfg.remode == "rand":
            d["erase_noise"] = torch.randn(batch, n, c, **kw)
    return Draws(**d)


def augment(batch_u8: torch.Tensor, draws: Draws, cfg: AugmentConfig) -> torch.Tensor:
    """The train pipeline on given draws, in the JAX package's order: crop
    -> flip -> RandAugment or colour jitter -> normalize -> erasing."""
    img = batch_u8.float()
    if draws.oy is not None:
        img = random_crop(img, draws.oy, draws.ox, cfg.crop_padding)
    if draws.flip is not None:
        img = random_flip(img, draws.flip)
    if cfg.rand_augment:
        img = rand_augment(img, draws.ra_op, draws.ra_mag, draws.ra_sign, draws.ra_apply,
                           draws.ra_bicubic, cfg)
    elif cfg.color_jitter > 0:
        img = color_jitter(img, draws.jitter)
    img = normalize(img, cfg)
    if cfg.reprob > 0:
        img = random_erasing(img, draws.erase_do, draws.erase_area, draws.erase_log_ratio,
                             draws.erase_oy, draws.erase_ox, draws.erase_noise, cfg)
    return img


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
    b = batch_u8.shape[0]
    draws = draw_params(b * process_count, cfg, generator, tuple(batch_u8.shape[1:]))
    if process_count > 1:
        draws = draws.rows(slice(process_index * b, (process_index + 1) * b))
    return augment(batch_u8, draws, cfg)


def eval_preprocess(batch_u8: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """Eval path: normalize only."""
    return normalize(batch_u8.float(), cfg)
