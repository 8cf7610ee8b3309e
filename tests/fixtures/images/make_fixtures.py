"""Write the image fixtures of this directory and their ``digests.json``.

Run from the repository root with Pillow and the JAX package importable:

    python tests/fixtures/images/make_fixtures.py

The images are seeded, so a rerun on the same Pillow writes the same
files.  They cover what an ImageNet-style tree holds: ImageNet's common
sizes (500x375, 375x500, 333x500, 640x480) and a small and an odd one;
4:2:0, 4:2:2 and 4:4:4 sampling, progressive and optimized Huffman tables,
restart markers, gray and Adobe CMYK JPEGs, RGB and palette PNGs, and a PNG
under a ``.JPEG`` name.  ``digests.json`` holds, for each file, the sha256
of the bytes of three decodes through Pillow and the JAX package's
``decode_image_batch``: the whole image (``np.asarray(Image.open(p)
.convert("RGB"))``), the train decode at seed 0 and the eval decode, both
at 224 px.  The port's decoder must give the same digests
(``tests/test_torch_image_decode.py``; on the card, ``chip_smoke.py``'s
``imagenet`` phase, where there is no Pillow).
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE = 224

# name, (width, height), mode, save options
FILES = [
    ("a_500x375_420.jpg", (500, 375), "RGB", dict(quality=90, subsampling=2)),
    ("b_375x500_420_q75.jpg", (375, 500), "RGB", dict(quality=75, subsampling=2)),
    ("c_333x500_422.jpg", (333, 500), "RGB", dict(quality=85, subsampling=1)),
    ("d_640x480_444_q95.jpg", (640, 480), "RGB", dict(quality=95, subsampling=0)),
    ("e_500x375_420_progressive.jpg", (500, 375), "RGB",
     dict(quality=85, subsampling=2, progressive=True)),
    ("f_500x333_420_optimize.jpg", (500, 333), "RGB", dict(quality=80, optimize=True)),
    ("g_500x375_gray.jpg", (500, 375), "L", dict(quality=88)),
    ("h_400x300_cmyk.jpg", (400, 300), "CMYK", dict(quality=85)),
    ("i_64x48_420.jpg", (64, 48), "RGB", dict(quality=90, subsampling=2)),
    ("j_231x117_422_progressive.jpg", (231, 117), "RGB",
     dict(quality=80, subsampling=1, progressive=True)),
    ("k_500x375.png", (500, 375), "RGB", {}),
    ("l_500x400_420_restart.jpg", (500, 400), "RGB",
     dict(quality=85, subsampling=2, restart_marker_rows=2)),
    ("m_375x500_444_progressive.jpg", (375, 500), "RGB",
     dict(quality=90, subsampling=0, progressive=True)),
    ("n_500x357_420_q60.jpg", (500, 357), "RGB", dict(quality=60, subsampling=2)),
    ("o_453x500_422.jpg", (453, 500), "RGB", dict(quality=90, subsampling=1)),
    ("p_200x150_palette.png", (200, 150), "P", {}),
    ("q_160x120_png_named.JPEG", (160, 120), "L", dict(format="PNG")),
    ("r_500x281_420.jpg", (500, 281), "RGB", dict(quality=85, subsampling=2)),
    ("s_300x500_gray_progressive.jpg", (300, 500), "L", dict(quality=85, progressive=True)),
    ("t_500x500_420.jpg", (500, 500), "RGB", dict(quality=92, subsampling=2)),
]


def picture(w: int, h: int, seed: int) -> np.ndarray:
    """A photo-like RGB image: smooth colour fields, a few hard edges and
    fine texture, so the JPEGs have the spectra and sizes of real ones."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 4, 2) * 2 * np.pi / np.array([w, h])
            img[..., c] += rng.uniform(20, 50) * np.sin(fx * xx + fy * yy + rng.uniform(0, 6.3))
    img += rng.uniform(60, 160, 3)
    for _ in range(6):  # discs with hard edges
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(0.05, 0.3) * min(w, h)
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        img[inside] = img[inside] * 0.4 + rng.uniform(0, 255, 3) * 0.6
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reference_digests(path: str) -> dict:
    """The three decodes through Pillow and the JAX package."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.data.datasets import (
        decode_image_batch,
    )

    with Image.open(path) as im:
        full = np.asarray(im.convert("RGB"))
    paths = np.asarray([path], object)
    return {
        "size": [int(full.shape[1]), int(full.shape[0])],
        "full": digest(full),
        "train_seed0_224": digest(decode_image_batch(paths, SIZE, True, 0)),
        "eval_224": digest(decode_image_batch(paths, SIZE, False, 0)),
    }


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    out = {}
    for seed, (name, (w, h), mode, opts) in enumerate(FILES):
        rgb = Image.fromarray(picture(w, h, seed))
        im = rgb.convert(mode) if mode != "P" else rgb.quantize(64)
        path = os.path.join(HERE, name)
        im.save(path, **opts)
        out[name] = reference_digests(path)
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n, *_ in FILES)
    print(f"{len(FILES)} files, {total} bytes")


if __name__ == "__main__":
    main()
