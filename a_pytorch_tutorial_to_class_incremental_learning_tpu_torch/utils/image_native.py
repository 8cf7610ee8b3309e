"""ctypes bindings for the host image decoder of ``csrc/image_decode.cpp``.

The image-folder dataset (``data/datasets.py``, ``--data_set
imagenet1000``) decodes its JPEG and PNG files here, to the bytes Pillow
gives, and crop-resizes them with Pillow's BICUBIC arithmetic; the port
has no PIL to fall back to.  Entry points:

* :func:`probe_sizes`: each file's width and height from its header;
* :func:`decode_full`: one whole image, ``uint8 [H, W, 3]``;
* :func:`decode_resized`: a batch, each image resized from a source box
  and cropped to ``S x S``, ``uint8 [B, S, S, 3]``, on a pool of threads;
* :func:`resample`: Pillow's BICUBIC ``resize(size, box=...)`` of an RGB
  array.

The library is built at its first use by ``g++`` into
``build/host/<hash>/libcilimage.so`` as ``utils/native.py`` builds
``csrc/cil_host.cpp`` (``fcntl`` lock, temporary name, ``os.replace``;
reported to ``CompileWatch``), with ``-O3 -fPIC -std=c++17
-ffp-contract=off`` and no ``-march``: the resampler's coefficients are
doubles, and an FMA contraction would move a rounded one.  A failed build
raises, and so does a file the decoder refuses: :class:`ImageDecodeError`
names the path and the reason.  ctypes releases the GIL for each call.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .native import BUILD_ROOT, build_host_library, host_library_path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "image_decode.cpp"
LIB_NAME = "libcilimage.so"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")
THREADS = 16  # the JAX package's decode pool (max_workers=16)
MSG_LEN = 256

_P8, _P32, _PF = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
                  ctypes.POINTER(ctypes.c_float))
_PPC, _PC, _I64 = ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p, ctypes.c_int64
# function -> (restype, argtypes), as in the source's extern "C" block.
SIGNATURES = {
    # paths, n, wh, status, msgs, msg_len, threads
    "cil_img_probe": (_I64, [_PPC, _I64, _P32, _P32, _PC, _I64, _I64]),
    # path, out, cap, wh, msg, msg_len
    "cil_img_decode_full": (ctypes.c_int32, [_PC, _P8, _I64, _P32, _PC, _I64]),
    # paths, n, boxes, geom, s, out, status, msgs, msg_len, threads
    "cil_img_decode_batch": (_I64, [_PPC, _I64, _PF, _P32, _I64, _P8, _P32, _PC, _I64, _I64]),
    # in, w, h, box, ow, oh, out
    "cil_img_resample": (ctypes.c_int32, [_P8, _I64, _I64, _PF, _I64, _I64, _P8]),
}
STATUS = {1: "cannot read", 2: "unsupported", 3: "corrupt or truncated", 4: "not an image",
          5: "bad argument"}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class ImageDecodeError(OSError):
    """A file the decoder cannot read; the message names the path."""


def library_path(build_root: Path = BUILD_ROOT, cxx: Optional[str] = None) -> Path:
    return host_library_path(SOURCE, LIB_NAME, CXXFLAGS, LDFLAGS, build_root, cxx)


def build(cxx: Optional[str] = None, build_root: Path = BUILD_ROOT) -> Path:
    """Build ``csrc/image_decode.cpp`` unless its library exists."""
    return build_host_library(SOURCE, LIB_NAME, CXXFLAGS, LDFLAGS, build_root, cxx)


def load() -> ctypes.CDLL:
    """The library, built if needed and loaded once a process.  Raises when
    it cannot be built or loaded: there is no other decoder."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (restype, argtypes) in SIGNATURES.items():
                f = getattr(lib, fn)
                f.restype, f.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _path_array(paths: Sequence[str]):
    encoded = [str(p).encode() for p in paths]
    return (ctypes.c_char_p * max(1, len(encoded)))(*encoded)


def _raise_first(paths: Sequence[str], status: np.ndarray, msgs) -> None:
    bad = np.flatnonzero(status)
    if len(bad):
        i = int(bad[0])
        msg = msgs[i * MSG_LEN:(i + 1) * MSG_LEN].split(b"\0", 1)[0].decode(errors="replace")
        more = f" (and {len(bad) - 1} more files)" if len(bad) > 1 else ""
        raise ImageDecodeError(
            f"{paths[i]}: {STATUS.get(int(status[i]), 'error')}: {msg}{more}")


def probe_sizes(paths: Sequence[str], threads: int = THREADS) -> np.ndarray:
    """``int32 [n, 2]``: each file's (width, height) from its header."""
    lib = load()
    n = len(paths)
    wh = np.zeros((n, 2), np.int32)
    status = np.zeros(n, np.int32)
    msgs = ctypes.create_string_buffer(max(1, n) * MSG_LEN)
    lib.cil_img_probe(_path_array(paths), n, wh.ctypes.data_as(_P32), status.ctypes.data_as(_P32),
                      msgs, MSG_LEN, threads)
    _raise_first(paths, status, msgs.raw)
    return wh


def decode_full(path: str) -> np.ndarray:
    """The whole image, ``uint8 [H, W, 3]``: what
    ``np.asarray(Image.open(path).convert("RGB"))`` gives."""
    lib = load()
    w, h = (int(v) for v in probe_sizes([path])[0])
    out = np.empty((h, w, 3), np.uint8)
    wh = np.zeros(2, np.int32)
    msg = ctypes.create_string_buffer(MSG_LEN)
    rc = lib.cil_img_decode_full(str(path).encode(), out.ctypes.data_as(_P8), out.nbytes,
                                 wh.ctypes.data_as(_P32), msg, MSG_LEN)
    _raise_first([path], np.array([rc], np.int32), msg.raw)
    return out


def decode_resized(paths: Sequence[str], boxes: np.ndarray, geom: np.ndarray, size: int,
                   threads: int = THREADS) -> np.ndarray:
    """Decode a batch: image ``i`` is resized from the source box
    ``boxes[i]`` (x0, y0, x1, y1) to ``geom[i, :2]`` (width, height) with
    Pillow's BICUBIC, then the ``size x size`` window at ``geom[i, 2:]``
    (left, top) is kept, zero-filled outside as ``Image.crop`` fills.
    Returns ``uint8 [B, size, size, 3]``."""
    lib = load()
    n = len(paths)
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(n, 4)
    geom = np.ascontiguousarray(geom, np.int32).reshape(n, 4)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.int32)
    msgs = ctypes.create_string_buffer(max(1, n) * MSG_LEN)
    lib.cil_img_decode_batch(_path_array(paths), n, boxes.ctypes.data_as(_PF),
                             geom.ctypes.data_as(_P32), size, out.ctypes.data_as(_P8),
                             status.ctypes.data_as(_P32), msgs, MSG_LEN, threads)
    _raise_first(paths, status, msgs.raw)
    return out


def resample(img: np.ndarray, size, box=None) -> np.ndarray:
    """Pillow's ``Image.resize(size, BICUBIC, box=box)`` of an RGB array
    ``uint8 [H, W, 3]``; ``size`` is (width, height), ``box`` (x0, y0, x1,
    y1) in source pixels, taken as float32 as Pillow takes it."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"resample takes a non-empty uint8 [H, W, 3] array, not {img.shape}")
    h, w = img.shape[:2]
    ow, oh = int(size[0]), int(size[1])
    box = np.asarray((0, 0, w, h) if box is None else box, np.float32)
    if not (0 <= box[0] < box[2] <= w and 0 <= box[1] < box[3] <= h):
        raise ValueError(f"box {tuple(box)} is not inside the {w}x{h} image")
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.cil_img_resample(img.ctypes.data_as(_P8), w, h, box.ctypes.data_as(_PF), ow, oh,
                              out.ctypes.data_as(_P8))
    if rc:
        raise ValueError(f"resample failed: {STATUS.get(rc, 'error')}")
    return out
