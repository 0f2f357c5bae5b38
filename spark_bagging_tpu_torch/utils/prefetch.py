"""Background chunk prefetching: host ingestion overlapped with the
device's steps.

A copy of the JAX package's ``utils/prefetch.py`` (host-only), with
its telemetry: ``sbt_prefetch_queue_depth`` and
``sbt_prefetch_stall_seconds_total``, read at the consumer. ``PrefetchChunks`` runs a source's iterator on a
daemon thread with a small bounded queue, so the host makes chunk
``c+1`` while the device fits chunk ``c``, at most ``depth`` chunks of
host memory ahead.

Semantics are preserved exactly: chunk ORDER is unchanged (the
chunk-keyed bootstrap weight streams depend on it), producer exceptions
re-raise at the consuming ``next()``, and abandoning the iterator
mid-epoch (early ``break``, error) stops the producer thread promptly.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from typing import Any

import os as _os

from spark_bagging_tpu_torch.utils.io import ChunkSource

_DONE = object()
# Producer-side work only pays when a core is free to do it.
# sched_getaffinity counts the cores THIS process may run on —
# cpu_count() would report a pinned or cgroup-limited process as
# multi-core.
try:
    _SPARE_CORE = len(_os.sched_getaffinity(0)) > 1
except (AttributeError, OSError):  # non-Linux
    _SPARE_CORE = (_os.cpu_count() or 1) > 1


def worth_prefetching() -> bool:
    """Whether a background producer thread can possibly pay for
    itself on this host. With no spare core the producer cannot
    overlap anything — it can only steal cycles and GIL turns from
    the consumer — so the streaming engines skip their default wrap
    when this is False. An explicitly-constructed
    ``PrefetchChunks`` is always honored."""
    return _SPARE_CORE


def _touch_pages(item) -> int:
    """Force each chunk array RESIDENT on the producer thread.

    Zero-copy sources (an ``ArrayChunks`` over an ``np.memmap``) yield
    views over a memory map: without this, the producer enqueues
    untouched views and the disk page-in happens at first access on
    the CONSUMER thread — silently serializing the I/O this wrapper
    exists to overlap. One byte per 4 KiB page suffices (no copy, no
    layout change); non-contiguous or small arrays are already real
    memory and skip the walk. Returns the number of page probes so
    the stride math is testable."""
    import numpy as np

    touched = 0
    for x in item if isinstance(item, tuple) else (item,):
        if (isinstance(x, np.ndarray) and x.flags.c_contiguous
                and x.nbytes > (1 << 20)):
            # reshape(-1) first: on a 2-D view, [::4096] would stride
            # ROWS, not bytes; the flat view strides one byte per
            # 4 KiB page. Both are views on c_contiguous input.
            probes = x.view(np.uint8).reshape(-1)[::4096]
            probes.sum()
            touched += probes.size
    return touched


class PrefetchChunks(ChunkSource):
    """Wrap a ChunkSource so ``chunks()`` is produced on a background
    thread, ``depth`` chunks ahead. Metadata proxies the inner source.
    Wrapping an already-wrapped source unwraps the inner layer first —
    one level of prefetch is the useful amount, so double-wrapping
    never stacks threads/queues.
    """

    def __init__(self, inner: ChunkSource, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if isinstance(inner, PrefetchChunks):
            inner = inner._inner
        self._inner = inner
        self._depth = depth
        self.n_features = inner.n_features
        self.n_rows = inner.n_rows
        self.chunk_rows = inner.chunk_rows

    @property
    def n_chunks(self) -> int:
        return self._inner.n_chunks

    def rewrap(self, transform) -> "PrefetchChunks":
        """New ``PrefetchChunks`` at the same depth over
        ``transform(inner_source)`` — the public way to splice a chunk
        transformation INSIDE an existing wrap (bagging's aux-column
        drop) without coupling callers to this class's internals."""
        return PrefetchChunks(transform(self._inner), depth=self._depth)

    def chunks(self):
        return self.chunks_from(0)

    def chunks_from(self, start: int):
        q: queue.Queue[Any] = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that notices consumer abandonment; returns
            False when the consumer is gone. Every terminal message
            (_DONE, exception) MUST go through this too: a plain
            timed put could drop it while the consumer sits inside a
            long device step (the first chunk's kernel build takes
            seconds), leaving the consumer blocked forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for item in self._inner.chunks_from(start):
                    # every LIVE wrap does the page-in: the 1-core
                    # protection lives at the policy layer (the
                    # engines' default wrap is skipped there via
                    # worth_prefetching) — a user who explicitly
                    # constructed this wrapper gets the full
                    # producer-side I/O they asked for
                    _touch_pages(item)
                    if not put_or_stop(item):
                        return
                put_or_stop(_DONE)
            except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
                put_or_stop(e)

        t = threading.Thread(
            target=produce, daemon=True, name="prefetch-producer"
        )
        t.start()
        from spark_bagging_tpu_torch import telemetry

        try:
            while True:
                if telemetry.enabled():
                    # consumer-side stall: how long the device loop sat
                    # waiting for the producer, the number that says
                    # whether ingestion or compute is the bottleneck;
                    # the queue depth sampled at the same moment (0:
                    # producer-bound, full: consumer-bound)
                    telemetry.set_gauge("sbt_prefetch_queue_depth",
                                        q.qsize())
                    t0 = _time.perf_counter()
                    item = q.get()
                    telemetry.inc("sbt_prefetch_stall_seconds_total",
                                  _time.perf_counter() - t0)
                else:
                    item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain one slot so a producer blocked in put() can exit
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
            if t.is_alive():
                import warnings

                warnings.warn(
                    "prefetch producer thread did not exit within 5s "
                    "of consumer teardown (a chunk read may be "
                    "blocked); its buffers stay alive until it does",
                    stacklevel=2,
                )
