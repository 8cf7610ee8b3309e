"""The port's host image decoder (``…_tpu_torch/csrc/image_decode.cpp``
through ``utils/image_native.py``) against Pillow, bitwise.

* JPEG: a seeded grid written by Pillow (1x1, 7x9, 37x53 and 500x375; 4:4:4,
  4:2:2 and 4:2:0; quality 50 and 95; baseline, progressive, optimized
  tables and restart markers; gray and CMYK) decodes to the bytes of
  ``np.asarray(Image.open(p).convert("RGB"))``.
* PNG: gray, gray+alpha, RGB, RGBA and palette at 8 bits, and gray and
  palette at 1/2/4 bits (written by hand), alike.
* The resampler: the C++ one, ``resample_plain`` (numpy) and Pillow's
  ``resize(size, BICUBIC, box=...)`` agree bitwise over up- and
  down-scales, boxes at the edges, fractional boxes and scale 1.
* The committed fixtures (``tests/fixtures/images``): the digests of the
  whole, train (seed 0) and eval decodes at 224 px through Pillow and the
  JAX package, and through the port, equal ``digests.json``.
* Refusals: arithmetic-coded, 12-bit and lossless JPEG, interlaced and
  16-bit PNG, GIF, a truncated file and a non-image each raise
  ``ImageDecodeError`` naming the path.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import datasets as jds
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import datasets as tds
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import image_native as N

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "images")
DIGESTS = json.load(open(os.path.join(FIXTURES, "digests.json")))


def _picture(w, h, channels, seed):
    """Blocky colour fields plus noise: sharp edges and texture in one."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, channels)).astype(np.float64)
    x = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w] + rng.normal(0, 20, (h, w, channels))
    return np.clip(x, 0, 255).astype(np.uint8)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _assert_decodes_like_pil(path):
    want = _pil_rgb(path)
    got = N.decode_full(str(path))
    assert got.shape == want.shape, path
    if not np.array_equal(got, want):
        diff = np.abs(got.astype(int) - want.astype(int))
        pytest.fail(f"{os.path.basename(path)}: max |diff| {diff.max()}, "
                    f"{(diff > 0).mean():.4f} of the values differ")


JPEG_VARIANTS = {"baseline": {}, "progressive": {"progressive": True},
                 "optimize": {"optimize": True}, "restart": {"restart_marker_blocks": 3}}


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (37, 53), (500, 375)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rgb_jpeg_bitwise_pil(tmp_path, size, subsampling):
    w, h = size
    img = Image.fromarray(_picture(w, h, 3, w * 7 + subsampling))
    for quality in (50, 95):
        for name, opts in JPEG_VARIANTS.items():
            path = tmp_path / f"q{quality}_{name}.jpg"
            img.save(path, quality=quality, subsampling=subsampling, **opts)
            _assert_decodes_like_pil(path)


def test_restart_markers_are_written(tmp_path):
    """The grid's restart case does hold RST markers (so the decoder's
    restart handling is what its parity checks)."""
    path = tmp_path / "r.jpg"
    Image.fromarray(_picture(64, 64, 3, 0)).save(path, quality=90, restart_marker_blocks=3)
    data = path.read_bytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (37, 53), (500, 375)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_and_cmyk_jpeg_bitwise_pil(tmp_path, size, mode):
    w, h = size
    arr = _picture(w, h, 1 if mode == "L" else 4, w + h)
    img = Image.fromarray(arr[..., 0], "L") if mode == "L" else \
        Image.frombytes("CMYK", (w, h), arr.tobytes())
    for quality in (50, 95):
        for progressive in (False, True):
            path = tmp_path / f"q{quality}_{int(progressive)}.jpg"
            img.save(path, quality=quality, progressive=progressive)
            _assert_decodes_like_pil(path)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_bitwise_pil(tmp_path, mode):
    for w, h in ((1, 1), (37, 53), (500, 375)):
        img = Image.fromarray(_picture(w, h, 4, w), "RGBA")
        img = img.quantize(200) if mode == "P" else img.convert(mode)
        path = tmp_path / f"{w}x{h}.png"
        img.save(path)
        _assert_decodes_like_pil(path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(w, h, depth, ctype, rows: bytes, plte: bytes = b"", interlace=0) -> bytes:
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + (_chunk(b"PLTE", plte) if plte else b"")
            + _chunk(b"IDAT", zlib.compress(rows, 9)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("ctype", [0, 3], ids=["gray", "palette"])
def test_low_bit_depth_png_bitwise_pil(tmp_path, depth, ctype):
    """Gray and palette PNGs below 8 bits, with a short
    palette whose missing entries Pillow reads as black."""
    rng = np.random.RandomState(depth * 10 + ctype)
    w, h = 13, 9
    rows = b""
    for y in range(h):
        bits = "".join(format(v, f"0{depth}b") for v in rng.randint(0, 1 << depth, w))
        bits += "0" * (-len(bits) % 8)
        rows += bytes([0]) + int(bits, 2).to_bytes(len(bits) // 8, "big")
    entries = max(1, (1 << depth) - 1)
    plte = bytes(rng.randint(0, 256, 3 * entries).astype(np.uint8)) if ctype == 3 else b""
    path = tmp_path / "low.png"
    path.write_bytes(_png(w, h, depth, ctype, rows, plte))
    _assert_decodes_like_pil(path)


def test_png_row_filters_bitwise_pil(tmp_path):
    """Every filter type (None, Sub, Up, Average, Paeth) on RGB rows."""
    rng = np.random.RandomState(3)
    w, h = 11, 10
    px = rng.randint(0, 256, (h, w * 3)).astype(np.int64)
    rows, prev = b"", np.zeros(w * 3, np.int64)
    for y in range(h):
        f = y % 5
        cur = px[y]
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        rows += bytes([f]) + bytes((enc % 256).astype(np.uint8))
        prev = cur
    path = tmp_path / "filters.png"
    path.write_bytes(_png(w, h, 8, 2, rows))
    _assert_decodes_like_pil(path)
    np.testing.assert_array_equal(N.decode_full(str(path)).reshape(h, w * 3), px)


def _resample_cases(kind, rng):
    for _ in range(12):
        h, w = (int(v) for v in rng.randint(1, 90, 2))
        box = None
        if kind == "up":
            ow, oh = w + int(rng.randint(1, 80)), h + int(rng.randint(1, 80))
        elif kind == "down":
            w, h = w + 60, h + 60
            ow, oh = int(rng.randint(1, w)), int(rng.randint(1, h))
        elif kind == "edge_boxes":
            w, h = w + 2, h + 2
            x0, y0 = int(rng.randint(0, 2)) * (w - 2), int(rng.randint(0, 2)) * (h - 2)
            box = (x0, y0, w if x0 else int(rng.randint(1, w + 1)), h if y0 else int(rng.randint(1, h + 1)))
            ow, oh = (int(v) for v in rng.randint(1, 120, 2))
        elif kind == "fractional_boxes":
            w, h = w + 4, h + 4
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            box = (x0, y0, rng.uniform(x0 + 1, w), rng.uniform(y0 + 1, h))
            ow, oh = (int(v) for v in rng.randint(1, 120, 2))
        else:  # scale 1: the whole image at its size, and unit-scale boxes
            ow, oh = w, h
            if rng.rand() < 0.5:
                dx, dy = int(rng.randint(0, w)), int(rng.randint(0, h))
                box, ow, oh = (dx, dy, w, h), w - dx, h - dy
        yield rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (ow, oh), box


@pytest.mark.parametrize("kind", ["up", "down", "edge_boxes", "fractional_boxes", "scale1"])
def test_resample_bitwise_pil_and_plain(kind):
    rng = np.random.RandomState(len(kind))
    for img, size, box in _resample_cases(kind, rng):
        want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC, box=box))
        got = N.resample(img, size, box)
        plain = tds.resample_plain(img, size, box)
        np.testing.assert_array_equal(got, want, err_msg=f"C++ {img.shape} {size} {box}")
        np.testing.assert_array_equal(plain, want, err_msg=f"plain {img.shape} {size} {box}")


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests(name):
    """Pillow with the JAX package, and the port, give the committed
    digests (so the card's host, which has no Pillow, can be checked)."""
    path = os.path.join(FIXTURES, name)
    want = DIGESTS[name]
    paths = np.asarray([path], object)
    ref = {"full": _digest(_pil_rgb(path)),
           "train_seed0_224": _digest(jds.decode_image_batch(paths, 224, True, 0)),
           "eval_224": _digest(jds.decode_image_batch(paths, 224, False, 0))}
    port = {"full": _digest(N.decode_full(path)),
            "train_seed0_224": _digest(tds.decode_image_batch(paths, 224, True, 0)),
            "eval_224": _digest(tds.decode_image_batch(paths, 224, False, 0))}
    assert ref == {k: want[k] for k in ref}
    assert port == ref
    assert [int(v) for v in N.probe_sizes([path])[0]] == want["size"]


def _jpeg(tmp_path, **opts):
    path = tmp_path / "src.jpg"
    Image.fromarray(_picture(40, 24, 3, 1)).save(path, quality=90, **opts)
    return path.read_bytes()


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` past ``marker``'s start set."""
    i = data.index(marker)
    return data[:i + offset] + bytes([value]) + data[i + offset + 1:]


def _error_cases(tmp_path):
    base = _jpeg(tmp_path)
    png = tmp_path / "ok.png"
    Image.fromarray(_picture(30, 20, 3, 2)).save(png)
    pngb = png.read_bytes()
    gif = tmp_path / "g.gif"
    Image.fromarray(_picture(8, 8, 3, 3)).save(gif)
    png16 = tmp_path / "p16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(png16)
    return {
        "arithmetic": (_patched(base, b"\xff\xc0", 1, 0xC9), "arithmetic"),
        "12bit": (_patched(base, b"\xff\xc0", 4, 12), "12-bit"),
        "lossless": (_patched(base, b"\xff\xc0", 1, 0xC3), "lossless"),
        "truncated_jpeg": (base[: len(base) // 2], "truncated"),
        "truncated_png": (pngb[: len(pngb) // 2], "truncated"),
        "interlaced_png": (_patched(pngb, b"IHDR", 16, 1), "interlaced"),
        "png16": (png16.read_bytes(), "16-bit"),
        "gif": (gif.read_bytes(), "GIF"),
        "not_an_image": (b"these are not the pixels you are looking for\n", "not a JPEG or PNG"),
    }


@pytest.mark.parametrize("case", ["arithmetic", "12bit", "lossless", "truncated_jpeg",
                                  "truncated_png", "interlaced_png", "png16", "gif",
                                  "not_an_image"])
def test_unsupported_or_broken_files_raise_naming_the_path(tmp_path, case):
    data, words = _error_cases(tmp_path)[case]
    bad = tmp_path / f"bad_{case}.JPEG"
    bad.write_bytes(data)
    good = tmp_path / "good.jpg"
    good.write_bytes(_jpeg(tmp_path))
    with pytest.raises(N.ImageDecodeError) as err:
        N.decode_full(str(bad))
    assert str(bad) in str(err.value) and words in str(err.value)
    # In a batch, the failing file is the one named; no pixels come back.
    paths = np.asarray([str(good), str(bad)], object)
    for train in (True, False):
        with pytest.raises(N.ImageDecodeError, match=f"bad_{case}"):
            tds.decode_image_batch(paths, 16, train, 0)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """No compiler, or one that fails, raises; so does every decode once
    the library cannot be had (there is no other decoder)."""
    import subprocess

    stub = tmp_path / "cxx_fails.sh"
    stub.write_text("#!/bin/sh\necho 'error: no such thing' >&2\nexit 1\n")
    stub.chmod(0o755)
    with pytest.raises(subprocess.CalledProcessError):
        N.build(cxx=str(stub), build_root=tmp_path / "host")
    assert not list((tmp_path / "host").rglob("*.so"))
    with pytest.raises(FileNotFoundError, match="no C\\+\\+ compiler"):
        N.build(cxx=str(tmp_path / "no-such-cxx"), build_root=tmp_path / "host")
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setenv("CXX", str(stub))
    monkeypatch.setattr(N, "BUILD_ROOT", tmp_path / "host2")
    monkeypatch.setattr(N, "build", lambda: N.build_host_library(
        N.SOURCE, N.LIB_NAME, N.CXXFLAGS, N.LDFLAGS, tmp_path / "host2"))
    paths = np.asarray([os.path.join(FIXTURES, "i_64x48_420.jpg")], object)
    with pytest.raises(subprocess.CalledProcessError):
        tds.decode_image_batch(paths, 32, True, 0)
