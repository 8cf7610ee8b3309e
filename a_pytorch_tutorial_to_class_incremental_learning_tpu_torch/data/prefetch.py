"""Asynchronous ring-buffer prefetcher for the per-batch paths.

Counterpart of the JAX package's ``data/prefetch.py`` (``DevicePrefetcher``),
with its contract:

* **Byte-identical streams.**  A producer thread iterates the very
  generator the caller would have iterated; threading changes when a batch
  is produced, never what.
* **Source errors cross the thread.**  An exception in the source is
  re-raised in the consumer, after the thread has stopped.
* **Degrade and retry.**  An exception in placement (the host-to-device
  copy, or an injected ``producer_die``) does not end the epoch: the
  producer hands the host batch back and exits, the consumer joins it,
  calls ``on_degrade``, retries that batch's placement inline and goes on
  synchronously; only a retry that fails too is re-raised.  Placement is
  never moved off the device.
* **Clean shutdown.**  ``close()`` (idempotent; also run on exhaustion, on
  error and by the context manager) stops the producer, drains the ring
  and joins the thread.

On CUDA (``device`` given and ``depth > 0``) the producer thread makes the
trainer's card its current device and runs ``place`` on a side stream: the
caller's ``place`` copies through pinned memory with ``non_blocking=True``
(:func:`to_device`), the producer records an event after it, and the
consumer makes its current stream wait on that event and calls
``record_stream`` on every tensor of the batch, so the caching allocator
does not reuse their memory while the consumer's stream still reads it.
No compute runs on the side stream: only copies.

The trainer's ``place`` callbacks also decode a lazy image-folder batch
(``datasets.maybe_decode``), so at ``depth > 0`` the decode runs on the
producer thread too, overlapped with the steps.

With a ``clock`` (a :class:`~..telemetry.StallClock`), only the time the
consumer blocks on the ring is charged to its host bucket; at depth 0
(no thread) the whole production is.  :meth:`DevicePrefetcher.stats` gives
the ring's mean fill at each get (``occupancy``).  With ``metrics`` (a
telemetry ``MetricsRegistry``), the ring also feeds JAX's series:
``prefetch_wait_ms_total`` (the consumer's blocked time),
``prefetch_batches_total`` and the ``prefetch_occupancy`` gauge.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

_BATCH, _DONE, _ERROR, _DEGRADE = "batch", "done", "error", "degrade"


def to_device(device: torch.device, *arrays: np.ndarray, pinned: bool = False):
    """Host arrays -> tensors on ``device``.  ``pinned`` (a producer's
    placement on CUDA) copies through pinned memory with
    ``non_blocking=True``, so the host does not wait for the copy; else the
    plain copy."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pinned and device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=pinned))
    return tuple(out)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


class DevicePrefetcher:
    """Depth-N ring-buffer prefetcher over ``(source, place)``.

    ``source`` is any host-batch iterable; ``place`` maps one host batch to
    its device form and runs on the producer thread when ``depth > 0``,
    inline otherwise.  Iterate it like the source, inside a ``with`` block
    so that an early exit stops the producer.
    """

    def __init__(
        self,
        source: Iterable,
        place: Optional[Callable] = None,
        depth: int = 0,
        clock=None,
        name: str = "prefetch",
        on_degrade: Optional[Callable] = None,
        device: Optional[torch.device] = None,
        metrics=None,
    ):
        self._source = iter(source)
        self._place = place if place is not None else (lambda batch: batch)
        self.depth = max(0, int(depth))
        self._clock = clock
        self._on_degrade = on_degrade
        if metrics is None:
            from ..telemetry.metrics import NullRegistry

            metrics = NullRegistry()
        self._m_wait_ms = metrics.counter("prefetch_wait_ms_total")
        self._m_batches = metrics.counter("prefetch_batches_total")
        self._m_occupancy = metrics.gauge("prefetch_occupancy")
        self._device = None
        if device is not None and device.type == "cuda":
            # The producer thread names its card by index.
            self._device = torch.device("cuda", device.index if device.index is not None
                                        else torch.cuda.current_device())
        self._degraded = False
        self._fill_sum = 0
        self._gets = 0
        self._closed = False
        self._exhausted = False
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(target=self._produce, name=name, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ #
    # Producer thread
    # ------------------------------------------------------------------ #

    def _place_on_side_stream(self, host_batch, stream):
        with torch.cuda.stream(stream):
            placed = self._place(host_batch)
            event = torch.cuda.Event()
            event.record(stream)
        return placed, event

    def _produce(self) -> None:
        stream = None
        if self._device is not None:
            try:
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            except BaseException as e:  # noqa: BLE001 - must cross the thread
                self._enqueue((_ERROR, e))
                return
        while True:
            try:
                host_batch = next(self._source)
            except StopIteration:
                self._enqueue((_DONE, None))
                return
            except BaseException as e:  # noqa: BLE001 - must cross the thread
                # A broken source is unrecoverable (its position is lost).
                self._enqueue((_ERROR, e))
                return
            try:
                if stream is None:
                    placed = (_BATCH, (self._place(host_batch), None))
                else:
                    placed = (_BATCH, self._place_on_side_stream(host_batch, stream))
            except BaseException as e:  # noqa: BLE001 - must cross the thread
                # The host batch is intact: hand it back, so the consumer
                # degrades to the synchronous path without losing (or
                # reordering) a batch.
                self._enqueue((_DEGRADE, (e, host_batch)))
                return
            del host_batch
            if not self._enqueue(placed):
                return  # close() raced us
            del placed

    def _enqueue(self, item) -> bool:
        """Bounded put that stays responsive to ``close()``."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # ------------------------------------------------------------------ #
    # Consumer side
    # ------------------------------------------------------------------ #

    def __iter__(self) -> Iterator:
        return self

    def _charge(self, dt: float) -> None:
        if self._clock is not None:
            self._clock.add_host(dt)

    def __next__(self):
        if self._exhausted or self._closed:
            raise StopIteration
        if self.depth == 0 or self._degraded:
            # Synchronous passthrough; also the path after a degradation:
            # the dead producer left the source one batch past the handback.
            # The clock's host bucket gets it, less what the placement
            # charged to the device.
            with self._clock.host() if self._clock is not None else nullcontext():
                try:
                    host_batch = next(self._source)
                except StopIteration:
                    self._exhausted = True
                    self.close()
                    raise
                return self._place(host_batch)
        self._fill_sum += self._queue.qsize()
        self._gets += 1
        t0 = time.perf_counter()
        tag, payload = self._queue.get()
        wait = time.perf_counter() - t0
        self._charge(wait)
        self._m_wait_ms.inc(wait * 1e3)
        if tag == _BATCH:
            self._m_batches.inc()
            placed, event = payload
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                for t in _tensors(placed):
                    t.record_stream(current)
            return placed
        if tag == _DEGRADE:
            exc, host_batch = payload
            self._note_degraded(exc)
            t0 = time.perf_counter()
            try:
                return self._place(host_batch)
            except BaseException:
                # A retry that fails too is deterministic, not transient.
                self._exhausted = True
                self.close()
                raise
            finally:
                self._charge(time.perf_counter() - t0)
        self._exhausted = True
        self.close()
        if tag == _ERROR:
            raise payload
        raise StopIteration

    def _note_degraded(self, exc: BaseException) -> None:
        """Producer death: join the exiting thread, go synchronous for the
        rest of the stream, and tell the owner through ``on_degrade``."""
        self._degraded = True
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        print(f"| prefetch producer died ({exc!r}); degrading to synchronous")
        if self._on_degrade is not None:
            try:
                self._on_degrade(exc)
            except Exception as cb_err:  # noqa: BLE001 - the hook must not mask the recovery
                print(f"| prefetch on_degrade callback failed: {cb_err!r}")

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #

    def close(self) -> None:
        """Stop the producer, drop buffered batches, join the thread;
        idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()  # unblocks a producer stuck in put
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                raise RuntimeError("prefetch producer thread failed to shut down")
            self._thread = None
        # Again after the join: the producer may have made one last put.
        self._drain()
        if self._clock is not None:
            self._clock.set_prefetch(self.depth, self.occupancy())
        self._m_occupancy.set(self.occupancy())

    def _drain(self) -> None:
        if self._queue is None:
            return
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    @property
    def alive(self) -> bool:
        """Whether the producer thread is running."""
        return self._thread is not None and self._thread.is_alive()

    def occupancy(self) -> float:
        """Mean ring fill fraction sampled at each consumer get."""
        if self.depth <= 0 or self._gets == 0:
            return 0.0
        return self._fill_sum / (self._gets * self.depth)

    def stats(self) -> Dict[str, float]:
        return {
            "prefetch_depth": self.depth,
            "prefetch_depth_occupancy": round(self.occupancy(), 4),
            "prefetch_degraded": int(self._degraded),
        }
