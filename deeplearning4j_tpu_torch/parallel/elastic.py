"""Dispatch supervision — the port of the watchdog half of
``deeplearning4j_tpu/parallel/elastic.py``.

- :class:`DispatchWatchdog` — runs a blocking device dispatch on a
  watchdog-supervised thread with a SOFT deadline (exceeding it records
  a ``dl4j_dispatch_watchdog_timeouts_total`` timeout; if the dispatch
  then completes it is a straggler, observed in
  ``dl4j_dispatch_straggler_seconds``) and a HARD grace deadline
  (exceeding that abandons the dispatch and raises
  :class:`DispatchTimeoutError`). The model server runs every forward
  through one (``replica_timeout``).
- :class:`DispatchFence` — the commit fence between a recovery path and
  abandoned dispatch threads.
- :class:`DeviceLossError` — the structured device-loss error.

Not ported yet (ROADMAP.md): ``DeviceMonitor``, ``shrink_mesh_on_dead``,
the coordination services and ``fit_elastic`` — they need meshes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Set

from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock
from deeplearning4j_tpu_torch.profiler.metrics import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = get_registry()
WATCHDOG_TIMEOUTS = _REG.counter(
    "dl4j_dispatch_watchdog_timeouts_total",
    "Dispatches that exceeded the watchdog's soft deadline")
STRAGGLER_SECONDS = _REG.histogram(
    "dl4j_dispatch_straggler_seconds",
    "Wall time of dispatches that exceeded the watchdog deadline but "
    "eventually completed (stragglers)")


class DeviceLossError(RuntimeError):
    """One or more devices are dead. Carries ``dead`` (device ids) and
    ``surviving`` (live devices) so a shrink path can rebuild."""

    def __init__(self, dead: Set[int], surviving: List, step: int):
        self.dead = set(dead)
        self.surviving = list(surviving)
        self.step = int(step)
        super().__init__(
            f"device(s) {sorted(self.dead)} dead at step {step} "
            f"({len(self.surviving)} surviving)")


class DispatchTimeoutError(RuntimeError):
    """A dispatch exceeded the watchdog's hard grace deadline and was
    abandoned. The update for its step(s) never landed; model state is
    the last completed step's."""


class DispatchFence:
    """Commit fence between the elastic recovery path and abandoned
    dispatch threads. ``fit_elastic`` attaches one to the model as
    ``_dispatch_fence``; the fit functions read ``generation`` at entry
    and COMMIT their outputs (state assignment + bookkeeping) only if,
    under the lock, the generation is unchanged. The shrink path bumps
    the generation and performs its checkpoint-restore under the same
    lock — so a hung dispatch that un-hangs after the mesh shrank
    discards its result instead of overwriting the restored state (or
    checkpointing a stale step)."""

    def __init__(self):
        self.lock = InstrumentedLock("elastic:fence")
        self.generation = 0


class DispatchWatchdog:
    """Deadline supervision around a blocking device dispatch.

    ``run(fn, step)`` executes ``fn`` on a dispatch thread and waits:

    - within ``deadline`` s: normal completion.
    - past ``deadline`` but within ``grace`` (default ``4*deadline``):
      a TIMEOUT is recorded; if the dispatch then completes it counts
      as a straggler and its result is used — transient stalls do not
      kill training.
    - past ``grace``: the dispatch is abandoned (the thread is a
      daemon; a truly hung kernel cannot be interrupted from
      Python) and :class:`DispatchTimeoutError` is raised. The caller
      must treat the step as never applied.

    ``deadline=None`` disables supervision: the dispatch runs inline on
    the calling thread (fault-injection delays still honored).

    The first ``warmup`` dispatches after :meth:`begin_attempt` are
    UNSUPERVISED (no deadline): they may build kernels or capture a
    CUDA graph, whose wall time has nothing to do with device health —
    counting it against the deadline would flag every cold start as
    hung. Steady-state dispatches that capture (a new batch signature
    mid-run) should be covered by setting ``deadline`` above the
    worst-case capture time or raising ``grace``.
    """

    def __init__(self, deadline: Optional[float] = None,
                 grace: Optional[float] = None, plan=None, warmup: int = 2):
        self.deadline = deadline
        self.grace = grace if grace is not None else (
            None if deadline is None else deadline * 4)
        self.plan = plan
        self.warmup = int(warmup)
        self._lenient = self.warmup
        self.timeouts = 0
        self.stragglers = 0

    def begin_attempt(self, count: Optional[int] = None):
        """The next ``warmup`` dispatches will compile (fresh program):
        run them unsupervised. ``count`` overrides the leniency for
        callers whose steady-state ``warmup`` is 0 (the model server
        captures every bucket at warmup, but its pre-warmup traffic
        legitimately runs cold)."""
        self._lenient = max(self._lenient,
                            self.warmup if count is None else int(count))

    def _hold(self, step: int) -> bool:
        """Fault seam: returns False when the planned hang says the
        dispatch never completes."""
        if self.plan is None:
            return True
        return self.plan.dispatch_hold(step)

    def run(self, fn, step: int):
        lenient = self._lenient > 0
        if lenient:
            self._lenient -= 1
        if self.deadline is None or lenient:
            if self._hold(step):
                return fn()
            raise DispatchTimeoutError(
                f"dispatch for step {step} never completed (injected hang "
                "outside watchdog supervision)")
        done = threading.Event()
        result: list = []
        error: list = []

        def work():
            try:
                if self._hold(step):
                    result.append(fn())
            except BaseException as e:      # re-raised on the caller
                error.append(e)
            finally:
                done.set()

        t = threading.Thread(target=work, daemon=True,
                             name=f"dl4j-dispatch-{step}")
        t0 = time.perf_counter()
        t.start()
        timed_out = False
        if not done.wait(self.deadline):
            timed_out = True
            self.timeouts += 1
            WATCHDOG_TIMEOUTS.inc()
            logger.warning("dispatch watchdog: step %d exceeded the %.3gs "
                           "deadline", step, self.deadline)
            remaining = None if self.grace is None \
                else max(self.grace - self.deadline, 0.0)
            if not done.wait(remaining):
                if self.plan is not None:
                    # let an injected hard hang exit WITHOUT dispatching
                    self.plan.release_hangs()
                raise DispatchTimeoutError(
                    f"dispatch for step {step} still running after the "
                    f"{self.grace:.3g}s grace deadline — abandoning it "
                    "(state is the last completed step's)")
        if error:
            raise error[0]
        dt = time.perf_counter() - t0
        if not result:
            # the injected hang was released without dispatching: the
            # step never completed even though the thread exited
            raise DispatchTimeoutError(
                f"dispatch for step {step} never completed")
        if timed_out:
            self.stragglers += 1
            STRAGGLER_SECONDS.observe(dt)
            logger.warning("dispatch watchdog: step %d completed late "
                           "(%.3fs) — straggler recorded", step, dt)
        return result[0]
