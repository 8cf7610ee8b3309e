"""ctypes bindings for the native host kernels of ``csrc/cil_host.cpp``.

Counterpart of the JAX package's ``utils/native.py``, with its entry points
and ctypes signatures: :func:`herd_barycenter_native` (the iCaRL greedy),
:func:`gather_u8_native` (a threaded uint8 row gather) and
:func:`gather_rows` (that gather, or numpy's ``src[idx]``).  The library is
host code: every entry point has its numpy fallback, and
``CIL_TPU_NO_NATIVE=1`` forces it.

The port builds its own copy of the library, at its first use, with
``g++`` and ``csrc/Makefile``'s flags (``-O3 -march=native -fPIC
-std=c++17``, linked ``-shared -pthread``), into
``build/host/<hash>/libcilhost.so`` under the repository (``<hash>``: the
source and the flags), the way ``ops/cuda_build.py`` builds the kernels: an
``fcntl`` lock, a build to a temporary name, then ``os.replace``, so
processes that start together build once and never load a partial file.
It never writes into ``csrc/`` and never loads the JAX loader's
``csrc/libcilhost.so``.  A build, or a cached library found in
``build/host/``, is reported to :class:`~..telemetry.compilewatch.CompileWatch`.

``-march=native`` lets the compiler contract into FMA, so two machines may
rank near-ties apart: a multi-process trainer uses the library only when
every rank has it (``engine/loop.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "cil_host.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")

_P8, _P64, _PF = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                  ctypes.POINTER(ctypes.c_float))
_I64 = ctypes.c_int64
# function -> (restype, argtypes), as in the source's extern "C" block.
SIGNATURES = {
    # feats, n, d, nb, out
    "herd_barycenter": (ctypes.c_int, [_PF, _I64, _I64, _I64, _P64]),
    # src, n_src, idx, n_idx, item_bytes, out, threads
    "gather_u8": (ctypes.c_int, [_P8, _I64, _P64, _I64, _I64, _P8, _I64]),
}

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def library_path(build_root: Path = BUILD_ROOT, cxx: Optional[str] = None) -> Path:
    """Where the library builds to: a directory named by the hash of the
    source, the compiler (``cxx``, else ``$CXX``, else ``g++``), its version,
    the machine and the flags, so an edit or another host builds anew."""
    return host_library_path(SOURCE, "libcilhost.so", CXXFLAGS, LDFLAGS, build_root, cxx)


def build(cxx: Optional[str] = None, build_root: Path = BUILD_ROOT) -> Path:
    """Build ``csrc/cil_host.cpp`` unless its library exists; returns the
    library's path.  Raises ``OSError`` or ``subprocess.SubprocessError``
    when there is no compiler or the build fails."""
    return build_host_library(SOURCE, "libcilhost.so", CXXFLAGS, LDFLAGS, build_root, cxx)


def host_library_path(source: Path, name: str, cxxflags, ldflags, build_root: Path = BUILD_ROOT,
                      cxx: Optional[str] = None) -> Path:
    """``build_root/<hash>/name``, ``<hash>`` over the source, the compiler
    and its version, the machine and the flags: a library built on another
    host (a copied ``build/``) is never loaded."""
    cxx = cxx or os.environ.get("CXX") or "g++"
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join((cxx, _compiler_version(cxx), platform.machine(),
                            *cxxflags, *ldflags)).encode())
    return Path(build_root) / digest.hexdigest()[:16] / name


@functools.lru_cache(maxsize=None)
def _compiler_version(cxx: str) -> str:
    """``cxx -dumpfullversion``; empty when there is no such compiler (the
    build then raises)."""
    try:
        out = subprocess.run([cxx, "-dumpfullversion"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def build_host_library(source: Path, name: str, cxxflags, ldflags, build_root: Path = BUILD_ROOT,
                       cxx: Optional[str] = None) -> Path:
    """Build one host C++ source into a shared library unless it exists
    (fcntl-locked, to a temporary name, then ``os.replace``), report it to
    ``CompileWatch``, and return its path."""
    from ..telemetry.compilewatch import CompileWatch

    cxx = cxx or os.environ.get("CXX") or "g++"
    lib = host_library_path(source, name, cxxflags, ldflags, build_root, cxx)
    t0 = time.perf_counter()
    cached = lib.exists()
    if not cached:
        if shutil.which(cxx) is None:
            raise FileNotFoundError(f"no C++ compiler {cxx!r} on the PATH")
        lib.parent.mkdir(parents=True, exist_ok=True)
        with open(lib.parent / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            cached = lib.exists()  # another process built it while this one waited
            if not cached:
                tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run([cxx, *cxxflags, str(source), *ldflags, "-o", str(tmp)],
                                   check=True, capture_output=True, timeout=300)
                    os.replace(tmp, lib)
                finally:
                    tmp.unlink(missing_ok=True)
    CompileWatch.install().record_build(time.perf_counter() - t0, cache_hit=cached)
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built if needed and loaded once a process; None when
    ``CIL_TPU_NO_NATIVE`` is set or it cannot be built or loaded.  The
    trainer calls this at startup, so no build lands mid-epoch."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("CIL_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(build()))
        for fn, (restype, argtypes) in SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        _lib = None
    return _lib


def native_available() -> bool:
    return load_native() is not None


def herd_barycenter_native(features: np.ndarray, nb: int) -> Optional[np.ndarray]:
    """The C++ iCaRL greedy ranking; None when the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    feats = np.ascontiguousarray(features, dtype=np.float32)
    n, d = feats.shape
    nb = min(nb, n)
    out = np.empty(nb, np.int64)
    rc = lib.herd_barycenter(feats.ctypes.data_as(_PF), n, d, nb, out.ctypes.data_as(_P64))
    return out if rc == 0 else None


def gather_u8_native(src: np.ndarray, idx: np.ndarray) -> Optional[np.ndarray]:
    """Threaded ``src[idx]`` for C-contiguous uint8 arrays; None = fall back
    (no library, another dtype, or an index out of range)."""
    lib = load_native()
    if lib is None or src.dtype != np.uint8 or not src.flags.c_contiguous:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    item_bytes = int(np.prod(src.shape[1:], dtype=np.int64))
    out = np.empty((len(idx),) + src.shape[1:], np.uint8)
    rc = lib.gather_u8(src.ctypes.data_as(_P8), len(src), idx.ctypes.data_as(_P64), len(idx),
                       item_bytes, out.ctypes.data_as(_P8), 0)
    return out if rc == 0 else None


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Batch assembly: the native gather when it applies, numpy's otherwise."""
    out = gather_u8_native(src, idx)
    return src[idx] if out is None else out

