"""Compile-time accounting: what each task's first epoch paid to compile.

Counterpart of the JAX package's ``telemetry/compilewatch.py``, whose
``compile_event`` record this feeds with the same fields (``compile_s``,
``backend_compile_s``, ``cache_retrieval_s``, ``compiles``,
``cache_hits``).  JAX listens for XLA's compile and cache-retrieval events;
the port has no XLA, and a compile is one of:

* a **CUDA graph capture** of the fused epoch's train step
  (``engine/train.py`` ``EpochFn``), priced from the start of its eager
  warm-up step (a real step, run just before) to the capture's end;
* a **build** of a native library: ``nvcc`` for ``csrc/*.cu``
  (``ops/cuda_build.py``) or ``g++`` for ``csrc/cil_host.cpp``
  (``utils/native.py``) and ``…_torch/csrc/image_decode.cpp``
  (``utils/image_native.py``).

A library already built under ``build/`` counts as a cache hit: its
lookup-and-load time is ``cache_retrieval_s`` and, as with JAX's persistent
cache, also part of ``backend_compile_s``, so ``compile_s = backend −
retrieval`` is the work actually done.  The watch is a process-wide
singleton; readers take :meth:`snapshot` deltas around the window they
price (a task's first executed epoch).  Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class CompileWatch:
    """Process-wide accumulator of compile and cache-retrieval seconds."""

    _instance: Optional["CompileWatch"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.backend_compile_s = 0.0
        self.cache_retrieval_s = 0.0
        self.compiles = 0
        self.cache_hits = 0

    @classmethod
    def install(cls) -> "CompileWatch":
        """Idempotent: one watch per process, however many callers."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def record_capture(self, seconds: float) -> None:
        """A CUDA graph captured (eager warm-up step included)."""
        with self._lock:
            self.backend_compile_s += float(seconds)
            self.compiles += 1

    def record_build(self, seconds: float, cache_hit: bool) -> None:
        """A native library built, or found built (``cache_hit``)."""
        with self._lock:
            self.backend_compile_s += float(seconds)
            self.compiles += 1
            if cache_hit:
                self.cache_retrieval_s += float(seconds)
                self.cache_hits += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "backend_compile_s": self.backend_compile_s,
                "cache_retrieval_s": self.cache_retrieval_s,
                "compiles": self.compiles,
                "cache_hits": self.cache_hits,
            }

    @staticmethod
    def delta(before: Dict[str, float], after: Dict[str, float]) -> Dict[str, float]:
        """The window between two snapshots, as the ``compile_event``
        record's fields; ``compile_s`` is the net work (clamped at 0)."""
        backend = after["backend_compile_s"] - before["backend_compile_s"]
        retrieval = after["cache_retrieval_s"] - before["cache_retrieval_s"]
        return {
            "compile_s": round(max(0.0, backend - retrieval), 4),
            "backend_compile_s": round(backend, 4),
            "cache_retrieval_s": round(retrieval, 4),
            "compiles": int(after["compiles"] - before["compiles"]),
            "cache_hits": int(after["cache_hits"] - before["cache_hits"]),
        }
