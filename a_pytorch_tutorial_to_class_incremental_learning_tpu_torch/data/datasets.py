"""Raw datasets as in-memory ``(images uint8 NHWC, labels int64)`` arrays.

numpy only, and bit-identical to the JAX package's ``data/datasets.py`` for
the loaders ported here: the seeded synthetic family (``synthetic_mnist``
included), the CIFAR-100 pickle distribution and the MNIST IDX files.  The
image-folder loader (``imagenet1000``) decodes through PIL, which the port
does without, and is not ported.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Tuple

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
        raise NotImplementedError(
            "data_set 'imagenet1000' is not ported: its image-folder loader "
            "decodes through PIL, which the PyTorch port does without"
        )
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
