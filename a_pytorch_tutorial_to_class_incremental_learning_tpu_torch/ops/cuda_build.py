"""Build the port's CUDA C++ sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, built at its first use into ``build/kernels/<hash>/lib<name>.so``
under the repository (``<hash>``: the source and the flags), for
``sm_90a`` (the H100).  Nothing is built at import: the CPU tests import
this module and need no ``nvcc``.

Ranks that start together (``torchrun``, the spawned data-parallel ranks)
may reach the first use at once: the build runs under an ``fcntl`` lock,
compiles to a temporary name and ``os.replace``s it, so a library file is
either absent or whole, and one process compiles it.  The ``ptxas`` report
(registers, spills per kernel) is kept beside the library.

``SIGNATURES`` gives every exported function's ctypes types, set on the
library when it loads: without ``argtypes`` ctypes passes a pointer as a
32-bit int and cuts it.  Pointers and the stream are ``c_void_p``.  This
module imports nothing but the standard library; :func:`load` reports each
build, or a library found built, to the stdlib-only
``telemetry/compilewatch.py`` (a ``compile_event``'s build or cache hit).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Mapping, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_BIN = Path("/usr/local/cuda/bin")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# name -> {function: (restype, argtypes)}, as in the source's extern "C" lines.
SIGNATURES = {
    "fused_ce": {
        "fused_ce_rows_per_block": (_I, []),
        "fused_ce_error_string": (ctypes.c_char_p, [_I]),
        # device, x, dtype, B, W, stride, labels, num_active, smoothing, scale,
        # per, lse, partials, ticket, out, launches, stream
        "fused_ce_fwd_launch": (_I, [_I, _P, _I, _LL, _I, _LL, _P, _P, _F, _F,
                                     _P, _P, _P, _P, _P, _P, _P]),
        # device, x, dtype, B, W, stride, labels, num_active, lse, grad,
        # smoothing, scale, dx, dx_stride, launches, stream
        "fused_ce_bwd_launch": (_I, [_I, _P, _I, _LL, _I, _LL, _P, _P, _P, _P,
                                     _F, _F, _P, _LL, _P, _P]),
        "fused_ce_empty_launch": (_I, [_I, _P]),
    },
}


class NvccNotFound(RuntimeError):
    """No ``nvcc`` where the build looks for one."""


class BuildError(RuntimeError):
    """``nvcc`` failed on a source."""


def find_nvcc(env: Optional[Mapping[str, str]] = None,
              default_bin: Optional[Path] = None) -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``$CUDA_PATH/bin``, the ``PATH``,
    then ``default_bin`` (``DEFAULT_CUDA_BIN``), in that order; raises
    ``NvccNotFound`` naming every place searched."""
    env = os.environ if env is None else env
    default_bin = DEFAULT_CUDA_BIN if default_bin is None else default_bin
    searched = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = env.get(var)
        if not root:
            searched.append(f"${var} (unset)")
            continue
        cand = Path(root) / "bin" / "nvcc"
        searched.append(f"${var}/bin ({cand})")
        if os.access(cand, os.X_OK):
            return str(cand)
    on_path = shutil.which("nvcc", path=env.get("PATH", ""))
    searched.append(f"PATH ({env.get('PATH', '')})")
    if on_path:
        return on_path
    cand = Path(default_bin) / "nvcc"
    searched.append(str(cand))
    if os.access(cand, os.X_OK):
        return str(cand)
    raise NvccNotFound("nvcc not found; searched " + ", ".join(searched))


def library_path(name: str, build_root: Path = BUILD_ROOT) -> Path:
    """Where ``csrc/<name>.cu`` builds to: a directory named by the hash of
    the source and the flags, so an edit builds anew."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return Path(build_root) / digest.hexdigest()[:16] / f"lib{name}.so"


def report_path(name: str, build_root: Path = BUILD_ROOT) -> Path:
    """The ``ptxas`` report of the build, beside the library."""
    return library_path(name, build_root).with_name(f"{name}.ptxas.txt")


def build(name: str, *, nvcc: Optional[str] = None, build_root: Path = BUILD_ROOT) -> Path:
    """Build ``csrc/<name>.cu`` unless its library exists; returns the
    library's path.  ``nvcc`` names the compiler (default: ``find_nvcc()``)."""
    lib = library_path(name, build_root)
    if lib.exists():
        return lib
    compiler = nvcc or find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"{compiler} failed ({proc.returncode}) on {name}.cu:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        report = report_path(name, build_root)
        report_tmp = report.with_name(f".{report.name}.{os.getpid()}.tmp")
        report_tmp.write_text(proc.stdout + proc.stderr)
        os.replace(report_tmp, report)
        os.replace(tmp, lib)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed and loaded once a
    process, with every exported function's ctypes types set."""
    from ..telemetry.compilewatch import CompileWatch

    cached = library_path(name).exists()
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build(name)))
    CompileWatch.install().record_build(time.perf_counter() - t0, cache_hit=cached)
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype, f.argtypes = restype, argtypes
    return lib
