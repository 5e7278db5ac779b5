"""Background-thread prefetch (``repro.data.prefetch``): the consumer
never waits on batch generation.

:class:`Prefetcher` runs the wrapped iterator on a worker thread into a
bounded queue (depth 2 by default: one batch consumed, one staged), so
generation and disk reads overlap the device step. The time the consumer
blocked is summed in ``wait_ms``, the host stall that the trainer's
``data_wait_ms`` reports.

Contract: the output order and contents are the wrapped iterator's; an
exception of the worker re-raises at the consumer's next ``__next__``;
``close()`` (also on leaving a ``with`` block) stops the worker even
when the queue is full.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Optional

_SENTINEL = object()


class Prefetcher:
    """Bounded background prefetch over any iterable of batches."""

    def __init__(self, it: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.wait_ms = 0.0          # total time the consumer blocked
        self.batches = 0            # batches handed out so far
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(
            target=self._worker, args=(iter(it),),
            name="repro-torch-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to ``close()``."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it: Iterator) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised to the consumer
            self._error = e
        self._put(_SENTINEL)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_ms += (time.perf_counter() - t0) * 1e3
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        self.batches += 1
        return item

    def close(self) -> None:
        """Stop the worker thread and empty the queue."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
