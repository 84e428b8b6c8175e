"""Instrumented locks — the port of
``deeplearning4j_tpu/profiler/locks.py``.

:class:`InstrumentedLock` / :class:`InstrumentedRLock` /
:class:`InstrumentedCondition` / :class:`InstrumentedQueue` are drop-in
replacements for the ``threading`` and ``queue`` primitives that, while instrumentation is active
(ProfilingMode != OFF or tracing on), record:

- ``dl4j_lock_wait_seconds{lock=...}`` — time spent *waiting* to
  acquire (contention latency),
- ``dl4j_lock_hold_seconds{lock=...}`` — time the lock was *held*,
- ``dl4j_lock_contention_total{lock=...}`` — acquisitions that had to
  block at all.

With instrumentation off the overhead is one module-flag check per
acquire/release on top of the raw primitive.

Independently of ProfilingMode, a process-wide **lock-order witness**
(:func:`enable_lock_order_witness`) records the per-thread held-lock
stack and the observed acquisition edges: the first time two
instrumented locks are taken in both orders it raises
:class:`LockOrderInversionError` (tests) or warns once (production),
and counts ``dl4j_lock_order_inversions_total``.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.profiler import metrics as _metrics
from deeplearning4j_tpu_torch.profiler.modes import ProfilingMode, \
    get_profiling_mode
from deeplearning4j_tpu_torch.profiler.tracer import tracing_enabled

_REG = _metrics.get_registry()
#: bucket layout tuned for lock latencies (1us .. 1s)
_LOCK_BUCKETS = (1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2,
                 5e-2, 0.1, 0.5, 1.0)
LOCK_WAIT = _REG.histogram(
    "dl4j_lock_wait_seconds",
    "Time spent blocked acquiring an instrumented lock",
    labelnames=("lock",), buckets=_LOCK_BUCKETS)
LOCK_HOLD = _REG.histogram(
    "dl4j_lock_hold_seconds",
    "Time an instrumented lock was held (critical-section length)",
    labelnames=("lock",), buckets=_LOCK_BUCKETS)
LOCK_CONTENTION = _REG.counter(
    "dl4j_lock_contention_total",
    "Acquisitions of an instrumented lock that had to block",
    labelnames=("lock",))
LOCK_INVERSIONS = _REG.counter(
    "dl4j_lock_order_inversions_total",
    "Lock-order inversions observed by the runtime witness (each is a "
    "potential deadlock — the dynamic confirmation of DL4J-E203)")


def _active() -> bool:
    return tracing_enabled() or get_profiling_mode() is not ProfilingMode.OFF


class LockOrderInversionError(RuntimeError):
    """Two instrumented locks were acquired in both orders (A->B on one
    code path, B->A on another) — the runtime signature of a potential
    deadlock. Raised only while the witness runs in raising mode
    (tests); production mode warns once per edge pair instead."""


class _LockOrderWitness:
    """Process-wide acquisition-order recorder (module singleton)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.raise_on_inversion = True
        # (first, then) -> first site observed, for the error message
        self._edges: Dict[Tuple[str, str], str] = {}
        self._warned: set = set()
        self._tls = threading.local()

    def _held(self) -> List[str]:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._warned.clear()

    def on_acquired(self, name: str) -> None:
        held = self._held()
        if held:
            me = threading.current_thread().name
            inversion = None
            with self._lock:
                for outer in held:
                    if outer == name:
                        continue        # re-entrant acquire, not ordering
                    self._edges.setdefault((outer, name),
                                           f"thread {me}")
                    rev = self._edges.get((name, outer))
                    if rev is not None and inversion is None:
                        inversion = (outer, name, rev)
            if inversion is not None:   # raise/warn outside our own lock
                self._inversion(*inversion)
        held.append(name)

    def _inversion(self, outer: str, inner: str, rev_site: str) -> None:
        LOCK_INVERSIONS.inc()
        msg = (f"lock-order inversion: this thread acquired "
               f"'{inner}' while holding '{outer}', but the opposite "
               f"order '{inner}' -> '{outer}' was already observed "
               f"({rev_site}) — two such threads interleaved deadlock "
               f"(DL4J-E203 at runtime)")
        if self.raise_on_inversion:
            raise LockOrderInversionError(msg)
        key = tuple(sorted((outer, inner)))
        with self._lock:
            if key in self._warned:
                return
            self._warned.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=4)

    def on_released(self, name: str) -> None:
        # called unconditionally from release paths: bail before the
        # list construction when this thread never pushed anything (the
        # overwhelmingly common disabled case)
        held = getattr(self._tls, "held", None)
        if not held:
            return
        # remove the most recent occurrence (re-entrant locks release in
        # LIFO order; out-of-order releases still clean up correctly)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._lock:
            return dict(self._edges)


_WITNESS = _LockOrderWitness()


def enable_lock_order_witness(raise_on_inversion: bool = True) -> None:
    """Start recording acquisition order across every instrumented lock
    (independent of ProfilingMode). With ``raise_on_inversion`` (the
    test default) the first A->B/B->A pair raises
    :class:`LockOrderInversionError` on the acquiring thread; otherwise
    it warns once per pair and counts
    ``dl4j_lock_order_inversions_total``."""
    _WITNESS.reset()
    _WITNESS.raise_on_inversion = bool(raise_on_inversion)
    _WITNESS.enabled = True


def disable_lock_order_witness() -> None:
    _WITNESS.enabled = False


def lock_order_edges() -> Dict[Tuple[str, str], str]:
    """Snapshot of the observed (outer, inner) acquisition edges."""
    return _WITNESS.edges()


class InstrumentedLock:
    """``threading.Lock`` with wait/hold histograms, a contention
    counter, and lock-order witnessing. Context manager and
    ``acquire``/``release`` compatible; ``name`` is the metrics label
    (keep the cardinality low — name the *role*, not the instance)."""

    _raw_factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = str(name)
        self._raw = self._raw_factory()
        self._tls = threading.local()

    # -- hold bookkeeping (per-thread stack: RLocks nest) ---------------
    def _holds(self) -> list:
        st = getattr(self._tls, "holds", None)
        if st is None:
            st = self._tls.holds = []
        return st

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _active() and not _WITNESS.enabled:
            return self._raw.acquire(blocking, timeout)
        instrument = _active()
        got = self._raw.acquire(False)
        if not got:
            if not blocking:
                return False
            if instrument:
                LOCK_CONTENTION.labels(lock=self.name).inc()
                t0 = time.perf_counter()
            got = self._raw.acquire(True, timeout)
            if instrument and got:
                LOCK_WAIT.labels(lock=self.name).observe(
                    time.perf_counter() - t0)
        if got:
            if instrument:
                self._holds().append(time.perf_counter())
            else:
                self._holds().append(None)
            if _WITNESS.enabled:
                try:
                    _WITNESS.on_acquired(self.name)
                except BaseException:
                    # witness raised (inversion): the lock IS held —
                    # release it so the failure does not strand waiters
                    self._holds().pop()
                    self._raw.release()
                    raise
        return got

    def release(self) -> None:
        holds = self._holds()
        t0 = holds.pop() if holds else None
        # unconditional (cheap no-op when nothing is on the stack):
        # releasing while the witness is disabled must still pop the
        # entry an enabled-time acquire pushed, or the stale name fakes
        # inversions after the next enable
        _WITNESS.on_released(self.name)
        self._raw.release()
        if t0 is not None:
            LOCK_HOLD.labels(lock=self.name).observe(
                time.perf_counter() - t0)

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class InstrumentedRLock(InstrumentedLock):
    """Re-entrant variant. Also delegates the private
    ``_is_owned``/``_release_save``/``_acquire_restore`` protocol so a
    ``threading.Condition`` can be built on top of it (see
    :class:`InstrumentedCondition`)."""

    _raw_factory = staticmethod(threading.RLock)

    def locked(self) -> bool:
        # _thread.RLock.locked() only exists on newer CPython — emulate
        # it with an uninstrumented non-blocking probe
        if self._raw._is_owned():
            return True
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    # Condition protocol: wait() releases the lock fully and re-acquires
    # it after — close/reopen the hold window so hold-time excludes the
    # blocked wait (a wait IS a release for contention purposes).
    def _is_owned(self) -> bool:
        return self._raw._is_owned()

    def _release_save(self):
        holds = self._holds()
        t0s = list(holds)
        holds.clear()
        _WITNESS.on_released(self.name)     # unconditional, see release()
        state = self._raw._release_save()
        now = time.perf_counter()
        for t0 in t0s:
            if t0 is not None:
                LOCK_HOLD.labels(lock=self.name).observe(now - t0)
        return state, len(t0s)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        self._raw._acquire_restore(state)
        if _WITNESS.enabled:
            _WITNESS.on_acquired(self.name)
        now = time.perf_counter() if _active() else None
        self._holds().extend([now] * max(depth, 1))


class InstrumentedCondition(threading.Condition):
    """``threading.Condition`` over an :class:`InstrumentedRLock`: every
    ``with cond:`` / ``acquire`` / ``wait`` reports the same wait/hold/
    contention series, so a condition-guarded subsystem (the model
    server's request queue) is observable like any other lock."""

    def __init__(self, name: str, lock: Optional[InstrumentedRLock] = None):
        self.name = str(name)
        super().__init__(lock if lock is not None
                         else InstrumentedRLock(name))


class WitnessedLock:
    """Witness-only ``threading.Lock`` shim for hot or short-lived
    locks (e.g. one per :class:`~deeplearning4j_tpu_torch.serving.server.
    ServingRequest`): participates in the lock-order witness under its
    role name but records NO wait/hold metrics and allocates no
    per-instance thread-local — construction is a raw Lock plus two
    slots, and the disabled-witness fast path is one flag read. Use
    :class:`InstrumentedLock` wherever the wait/hold series matter;
    use this where only deadlock ordering does."""

    __slots__ = ("name", "_raw")

    def __init__(self, name: str):
        self.name = str(name)
        self._raw = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._raw.acquire(blocking, timeout)
        if got and _WITNESS.enabled:
            try:
                _WITNESS.on_acquired(self.name)
            except BaseException:
                # witness raised (inversion): the lock IS held — release
                # so the failure does not strand waiters
                self._raw.release()
                raise
        return got

    def release(self) -> None:
        # unconditional pop (cheap no-op when nothing was pushed): see
        # InstrumentedLock.release for why
        _WITNESS.on_released(self.name)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> "WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return f"WitnessedLock({self.name!r})"


class InstrumentedQueue(_queue.Queue):
    """``queue.Queue`` whose internal mutex (and the three conditions
    built on it) is an :class:`InstrumentedRLock`: every put/get reports
    wait/hold/contention under the queue's name. The input pipeline's
    queues (``DevicePrefetcher``, ``AsyncDataSetIterator``) use it, so
    their contention shows in ``dl4j_lock_*{lock=...}`` like any other
    lock's."""

    def __init__(self, maxsize: int = 0, name: str = "queue"):
        super().__init__(maxsize)
        # replace the plain primitives queue.Queue.__init__ installed; a
        # Condition drives the lock through the _release_save/
        # _acquire_restore/_is_owned protocol InstrumentedRLock delegates
        lock = InstrumentedRLock(name)
        self.mutex = lock
        self.not_empty = threading.Condition(lock)
        self.not_full = threading.Condition(lock)
        self.all_tasks_done = threading.Condition(lock)


# the metrics registry's get-or-create lock is a hot path (observe_region
# resolves its histogram through it every train step): an instrumented
# lock, as in the JAX package. Safe against recursion: the dl4j_lock_*
# families above were registered BEFORE the swap, so recording a lock
# metric takes only per-family/child locks (plain threading.Lock), never
# the registry lock.
_REG._lock = InstrumentedLock("metrics_registry")
