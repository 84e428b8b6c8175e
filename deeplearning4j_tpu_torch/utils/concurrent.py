"""Small shared concurrency primitives (a copy of the JAX package's
``utils/concurrent.py``, which imports nothing of JAX).

One implementation of cross-thread plumbing used by more than one
subsystem, so its exactly-once semantics are tested in one place.
"""

from __future__ import annotations

import threading


class ErrorLatch:
    """First-error latch shared by a worker thread and its consumer.

    The worker records the first failure, the consumer marks it delivered
    when it surfaces through the normal result channel, and ``close()``-
    style paths take whatever was never delivered — every transition
    under one lock, so a worker error racing a shutdown can neither be
    lost nor raised twice. Used by ``AsyncDataSetIterator`` and
    ``DevicePrefetcher``."""

    __slots__ = ("_lock", "_error")

    def __init__(self):
        self._lock = threading.Lock()
        self._error: "BaseException | None" = None

    def record(self, e: BaseException) -> None:
        """Worker side: the FIRST error wins."""
        with self._lock:
            if self._error is None:
                self._error = e

    def delivered(self, e: BaseException) -> None:
        """Consumer side: this error surfaced through the queue — a later
        ``take()`` must not return it."""
        with self._lock:
            if self._error is e:
                self._error = None

    def clear(self) -> None:
        with self._lock:
            self._error = None

    def take(self) -> "BaseException | None":
        with self._lock:
            e, self._error = self._error, None
            return e
