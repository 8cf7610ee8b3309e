"""Raw datasets as in-memory ``(images uint8 NHWC, labels int64)`` arrays.

numpy only, and bit-identical to the JAX package's ``data/datasets.py``:
the seeded synthetic family (``synthetic_mnist`` included), the CIFAR-100
pickle distribution, the MNIST IDX files and the lazy image-folder tree
(``imagenet1000``), whose ``x`` is an object array of file paths.  Path
batches decode on the host per batch (:func:`decode_image_batch`) through
the port's own C++ decoder (``csrc/image_decode.cpp``), which gives
Pillow's bytes for the JAX package's ``Image.open(p).convert("RGB")`` and
its BICUBIC crop-resizes: the port has no PIL.  Its departures from PIL:
files it does not read (arithmetic-coded, 12-bit, lossless or hierarchical
JPEG; a progressive JPEG whose scans leave low AC coefficients unrefined;
interlaced or 16-bit PNG; other formats) and data that ends early or is
corrupt raise, naming the path, where PIL would read or pad them.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Optional, Sequence, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]  # (x uint8 [N,H,W,C], y int64 [N])


def load_cifar100(data_path: str, train: bool) -> Arrays:
    """Parse the ``cifar-100-python`` pickles from the extracted directory,
    its parent, or the ``.tar.gz`` archive.  Nothing is downloaded."""
    split = "train" if train else "test"
    candidates = [
        os.path.join(data_path, "cifar-100-python", split),
        os.path.join(data_path, split),
    ]
    for path in candidates:
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = pickle.load(f, encoding="bytes")
            return _decode_cifar(raw)
    for tar in (data_path, os.path.join(data_path, "cifar-100-python.tar.gz")):
        if os.path.isfile(tar) and tarfile.is_tarfile(tar):
            with tarfile.open(tar) as tf:
                member = tf.extractfile(f"cifar-100-python/{split}")
                if member is None:
                    raise FileNotFoundError(f"{tar} has no cifar-100-python/{split}")
                raw = pickle.load(member, encoding="bytes")  # noqa: S301
            return _decode_cifar(raw)
    raise FileNotFoundError(
        f"CIFAR-100 not found under {data_path!r} (nothing is downloaded); "
        "use --data_set synthetic_hard128 for runs without data"
    )


def _decode_cifar(raw: dict) -> Arrays:
    x = np.asarray(raw[b"data"], np.uint8).reshape(-1, 3, 32, 32)
    x = x.transpose(0, 2, 3, 1)  # stored NCHW -> NHWC
    y = np.asarray(raw[b"fine_labels"], np.int64)
    return np.ascontiguousarray(x), y


def load_mnist_idx(data_path: str, train: bool) -> Arrays:
    """Parse the MNIST IDX files (``train-images-idx3-ubyte`` and the rest,
    plain or ``.gz``) under ``data_path`` or ``data_path/MNIST/raw`` into
    ``(x uint8 [N,28,28,1], y int64)``.  The format: a big-endian int32 magic
    (0x803 images, 0x801 labels), the dimensions, then the raw bytes.
    Nothing is downloaded."""
    prefix = "train" if train else "t10k"

    def read(kind: str, magic_want: int) -> np.ndarray:
        names = [f"{prefix}-{kind}", f"{prefix}-{kind}.gz"]
        roots = [data_path, os.path.join(data_path, "MNIST", "raw")]
        for root in roots:
            for name in names:
                path = os.path.join(root, name)
                if not os.path.isfile(path):
                    continue
                opener = gzip.open if path.endswith(".gz") else open
                with opener(path, "rb") as f:
                    magic, n = struct.unpack(">ii", f.read(8))
                    if magic != magic_want:
                        raise ValueError(f"{path}: bad IDX magic {magic:#x}")
                    if magic_want == 0x803:
                        h, w = struct.unpack(">ii", f.read(8))
                        return np.frombuffer(f.read(), np.uint8).reshape(n, h, w, 1)
                    return np.frombuffer(f.read(), np.uint8).astype(np.int64)
        raise FileNotFoundError(
            f"MNIST IDX files not found under {data_path!r} (nothing is "
            "downloaded); use --data_set synthetic_mnist for runs without data"
        )

    x = read("images-idx3-ubyte", 0x803)
    y = read("labels-idx1-ubyte", 0x801)
    if len(x) != len(y):
        raise ValueError(f"MNIST images/labels length mismatch: {len(x)}/{len(y)}")
    return x, y


def load_synthetic(
    nb_classes: int = 100,
    per_class: int = 64,
    input_size: int = 32,
    channels: int = 3,
    train: bool = True,
    seed: int = 1234,
    noise_std: float = 48.0,
) -> Arrays:
    """Class-separable synthetic data: a low-frequency template per class
    plus pixel noise, deterministic in ``seed`` (train and val draw disjoint
    noise).  Low-frequency templates keep padded-crop shifts correlated."""
    rng = np.random.RandomState(seed)
    lo = max(2, input_size // 4)
    up = -(-input_size // lo)
    coarse = rng.randint(0, 256, size=(nb_classes, lo, lo, channels))
    templates = np.kron(
        coarse.astype(np.float32), np.ones((1, up, up, 1))
    )[:, :input_size, :input_size, :]
    for axis in (1, 2):  # separable 3-tap box blur
        templates = (
            templates
            + np.roll(templates, 1, axis=axis)
            + np.roll(templates, -1, axis=axis)
        ) / 3.0
    noise_rng = np.random.RandomState(seed + (1 if train else 2))
    y = np.repeat(np.arange(nb_classes, dtype=np.int64), per_class)
    noise = noise_rng.normal(
        0.0, noise_std, size=(len(y), input_size, input_size, channels)
    )
    x = np.clip(templates[y] + noise, 0, 255).astype(np.uint8)
    perm = np.random.RandomState(seed + 3).permutation(len(y))
    return x[perm], y[perm]


def load_image_folder(data_path: str, train: bool) -> Arrays:
    """An ImageNet-style ``train/``/``val/`` tree of class folders, loaded
    lazily: ``x`` is the object array of file paths (class folders sorted,
    files sorted in each), ``y`` int64.  Raw samples, rehearsal exemplars
    and task slices are all path arrays; pixels come per batch from
    :func:`decode_image_batch`."""
    root = os.path.join(data_path, "train" if train else "val")
    if not os.path.isdir(root):
        raise FileNotFoundError(f"image-folder split not found: {root}")
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    paths, ys = [], []
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, fname))
            ys.append(label)
    return np.asarray(paths, object), np.asarray(ys, np.int64)


def _random_resized_crop_box(w: int, h: int, rng: np.random.RandomState):
    """torchvision's ``RandomResizedCrop`` source box ``(x0, y0, x1, y1)``:
    area scale (0.08, 1.0), aspect ratio (3/4, 4/3), 10 attempts, then the
    centre square; the JAX package's draws, in its order."""
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            return (x0, y0, x0 + cw, y0 + ch)
    side = min(w, h)
    x0, y0 = (w - side) // 2, (h - side) // 2
    return (x0, y0, x0 + side, y0 + side)


def decode_geometry(sizes: np.ndarray, input_size: int, train: bool, seed: int = 0):
    """Per-image ``(boxes float32 [B, 4], geom int32 [B, 4])`` for
    :func:`~..utils.image_native.decode_resized` from the files' (width,
    height).  Train: the RandomResizedCrop box of
    ``RandomState((seed + i) & 0x7FFFFFFF)`` resized to ``S x S``.  Eval:
    the shorter side resized to ``int(256/224 * S)`` (``round``-ed sizes),
    then the centre ``S x S`` crop."""
    n = len(sizes)
    boxes = np.empty((n, 4), np.float32)
    geom = np.empty((n, 4), np.int32)
    rng = np.random.RandomState()
    for i, (w, h) in enumerate(sizes):
        w, h = int(w), int(h)
        if train:
            # Reseeding draws what a new RandomState(seed) draws, at a
            # hundredth of the cost of making one.
            rng.seed((seed + i) & 0x7FFFFFFF)
            boxes[i] = _random_resized_crop_box(w, h, rng)
            geom[i] = (input_size, input_size, 0, 0)
        else:
            resize = int((256 / 224) * input_size)
            scale = resize / min(w, h)
            rw, rh = max(1, round(w * scale)), max(1, round(h * scale))
            boxes[i] = (0, 0, w, h)
            geom[i] = (rw, rh, (rw - input_size) // 2, (rh - input_size) // 2)
    return boxes, geom


def decode_image_batch(paths: np.ndarray, input_size: int, train: bool,
                       seed: int = 0) -> np.ndarray:
    """Decode a batch of image paths to ``uint8 [B, S, S, 3]``, bitwise the
    JAX package's PIL pipeline.  Train: RandomResizedCrop with item ``i``'s
    draws from ``seed + i``.  Eval: shorter side to ``256/224 * S`` and a
    centre crop.  The headers are read first (the boxes come from numpy's
    draws), then the C++ decoder decodes and resizes the batch on 16
    threads with the GIL released; safe to call from several threads."""
    from ..utils.image_native import decode_resized, probe_sizes

    paths = [str(p) for p in paths]
    boxes, geom = decode_geometry(probe_sizes(paths), input_size, train, seed)
    return decode_resized(paths, boxes, geom, input_size)


def maybe_decode(x: np.ndarray, input_size: int, train: bool, seed: int = 0) -> np.ndarray:
    """Pixel batches pass through; path batches (lazy datasets) decode."""
    if x.dtype == np.uint8:
        return x
    return decode_image_batch(x, input_size, train, seed)


def is_path_array(x: np.ndarray) -> bool:
    """A lazy dataset's ``x``: file paths, not pixels."""
    return x.dtype == object


def path_digest_bytes(paths: Sequence[str]) -> bytes:
    """A path batch as bytes for a digest: its paths' UTF-8, NUL-joined
    (an object array's own bytes are pointers, which differ by process)."""
    return "\0".join(str(p) for p in paths).encode()


def _precompute_coeffs_plain(in_size: int, in0, in1, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for
    BICUBIC (a = -0.5): ``(xmin [out], taps [out], kk int64 [out, ksize])``,
    the weights past each window's ``taps`` zero."""
    in0, in1 = np.float32(in0), np.float32(in1)
    scale = float(in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1

    def bicubic(x: float) -> float:
        a = -0.5
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    xmins = np.zeros(out_size, np.int64)
    counts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = float(in0) + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        kk[xx, :xmax] = [int(-0.5 + w * (1 << 22)) if w < 0 else int(0.5 + w * (1 << 22))
                         for w in k]
        xmins[xx], counts[xx] = xmin, xmax
    return xmins, counts, kk


def _pass_plain(img: np.ndarray, xmins: np.ndarray, kk: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (1: columns, 0: rows), clipped."""
    taps = xmins[:, None] + np.arange(kk.shape[1])[None, :]
    taps = np.minimum(taps, img.shape[axis] - 1)  # zero weights past xmax
    src = np.take(img.astype(np.int64), taps, axis=axis)  # axis grows to [out, ksize]
    k = kk.reshape((1, *kk.shape, 1)) if axis == 1 else kk.reshape((*kk.shape, 1, 1))
    acc = (src * k).sum(axis=axis + 1) + (1 << 21)
    return np.clip(acc >> 22, 0, 255).astype(np.uint8)


def resample_plain(img: np.ndarray, size: Tuple[int, int],
                   box: Optional[Tuple[float, float, float, float]] = None) -> np.ndarray:
    """The plain numpy version of the C++ resampler: Pillow's
    ``Image.resize(size, BICUBIC, box=box)`` of ``uint8 [H, W, 3]``, in
    Pillow's arithmetic (double coefficients, 22-bit fixed point, the
    horizontal pass over only the rows the vertical pass reads, a clipped
    uint8 between the passes, the copy when size and box are the whole
    image).  The tests hold the C++ resampler to it; nothing on the
    training path calls it."""
    h, w = img.shape[:2]
    ow, oh = int(size[0]), int(size[1])
    box = (0, 0, w, h) if box is None else tuple(box)
    b = [np.float32(v) for v in box]
    need_h = ow != w or b[0] != 0 or b[2] != ow
    need_v = oh != h or b[1] != 0 or b[3] != oh
    xmins, _, kx = _precompute_coeffs_plain(w, b[0], b[2], ow)
    ymins, ycounts, ky = _precompute_coeffs_plain(h, b[1], b[3], oh)
    out = np.asarray(img, np.uint8)
    if need_h:
        first, last = int(ymins[0]), int(ymins[-1] + ycounts[-1])
        out = _pass_plain(out[first:last], xmins, kx, axis=1)
        ymins = ymins - first
    if need_v:
        out = _pass_plain(out, ymins, ky, axis=0)
    return np.array(out, copy=True)


def build_raw_dataset(
    data_set: str, data_path: str, train: bool, input_size: int = 32
) -> Tuple[Arrays, int]:
    """Flag-string dispatch; returns ``((x, y), nb_classes)``."""
    name = data_set.lower()
    if name == "cifar":
        x, y = load_cifar100(data_path, train)
    elif name == "mnist":
        x, y = load_mnist_idx(data_path, train)
    elif name == "synthetic_mnist":
        # The 1-channel dataset of the mnist backbone family, at input_size.
        x, y = load_synthetic(nb_classes=10, input_size=input_size, channels=1, train=train)
    elif name == "imagenet1000":
        x, y = load_image_folder(data_path, train)
    elif name == "synthetic":
        x, y = load_synthetic(train=train)
    elif name.startswith("synthetic_hard"):
        # A numeric suffix sets the noise std (synthetic_hard128); bare
        # synthetic_hard keeps 96.
        suffix = name[len("synthetic_hard"):]
        if suffix and not suffix.isdecimal():
            raise ValueError(f"Unknown dataset {data_set}.")
        std = float(suffix) if suffix else 96.0
        x, y = load_synthetic(train=train, noise_std=std)
    elif name.startswith("synthetic"):  # synthetic10, synthetic20, ...
        suffix = name[len("synthetic"):]
        if not suffix.isdecimal():
            raise ValueError(f"Unknown dataset {data_set}.")
        x, y = load_synthetic(nb_classes=int(suffix), train=train)
    else:
        raise ValueError(f"Unknown dataset {data_set}.")
    return (x, y), int(y.max()) + 1
