"""Preemption signals — the port of the preemption half of
``deeplearning4j_tpu/train/resilience.py``.

:class:`PreemptionSignal` is polled between dispatches;
:class:`SignalPreemption` turns SIGTERM/SIGINT into a drain request (the
model server's ``preemption=True``), and :class:`StepPreemption` is its
deterministic stand-in (drain after n completed batches or steps).

Not ported yet (ROADMAP.md): checkpointing (``CheckpointManager``),
``NanPolicy`` recovery and the resilient ``fit`` loop.
"""

from __future__ import annotations

import signal as _signal
import threading
from typing import Any, Dict


class PreemptionRequested(Exception):
    """Internal control flow: a PreemptionSignal fired; the loop
    unwinds to its boundary and returns cleanly."""


class PreemptionSignal:
    """Pluggable preemption source: ``requested(step)`` is polled after
    every completed (mega)step. Subclass for cluster schedulers that
    announce preemption out-of-band (metadata server, borglet file)."""

    def requested(self, step: int) -> bool:
        return False


class StepPreemption(PreemptionSignal):
    """Synthetic preemption once ``step`` update steps have completed —
    the deterministic stand-in for SIGTERM that the fault harness and
    the resume-equivalence tests use."""

    def __init__(self, step: int):
        self.step = int(step)

    def requested(self, step: int) -> bool:
        return step >= self.step


class SignalPreemption(PreemptionSignal):
    """SIGTERM/SIGINT -> preemption flag. Installed for the duration of
    a resilient ``fit()`` (main thread only — signal handlers cannot be
    installed elsewhere); previous handlers are restored on close.

    ``on_request`` is an optional zero-arg callback invoked from the
    handler so a consumer polling from ANOTHER thread (the model
    server's serve loop reacting to SIGTERM with a drain) wakes
    immediately instead of at its next poll. It must be cheap and
    non-blocking — setting a ``threading.Event`` is the intended use;
    exceptions are swallowed (a failing callback must not break the
    signal handler)."""

    def __init__(self, signals=(_signal.SIGTERM, _signal.SIGINT),
                 on_request=None):
        self.signals = signals
        self.on_request = on_request
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}

    def install(self) -> bool:
        if threading.current_thread() is not threading.main_thread():
            return False
        for s in self.signals:
            self._prev[s] = _signal.signal(s, self._handler)
        return True

    def uninstall(self):
        for s, prev in self._prev.items():
            try:
                _signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}

    def _handler(self, signum, frame):
        self._event.set()
        if self.on_request is not None:
            try:
                self.on_request()
            except Exception:
                pass

    def requested(self, step: int) -> bool:
        return self._event.is_set()
