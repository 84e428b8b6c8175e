"""Thread-safe span tracer with Chrome Trace Event Format export — a
copy of the JAX package's jax-free ``profiler/tracer.py`` (the port
imports nothing of that package).

- ``trace_span("op:conv2d", shape=(8, 256))`` is a context manager AND a
  decorator; spans nest (begin/end timestamps carry the nesting).
- Near-zero cost when disabled: a module-level ``_ENABLED`` flag is
  checked before ANY allocation; a disabled span is one attribute read.
- Completed spans go into a bounded ring buffer (oldest evicted first).
- ``stream_to(path)`` additionally appends every span to a Chrome-trace
  JSON file as it completes; ``stop_stream()`` finalizes the file.
- Export is Chrome Trace Event Format JSON ("X" complete events + "M"
  thread-name metadata), loadable in Perfetto and chrome://tracing.

The tracer traces the *framework* (admission, queueing, dispatch,
retries); ``torch.profiler`` traces the card.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# module-level fast path: checked before span allocation (see trace_span)
_ENABLED = False

# one monotonic epoch per process so spans from every thread share a
# timebase (Chrome trace ts is in microseconds from an arbitrary origin)
_EPOCH_NS = time.perf_counter_ns()

# streamed-trace flush cadence: every N events (the file is also closed
# cleanly by stop_stream; a killed process loses at most one buffer)
_STREAM_FLUSH_EVERY = 256

# ambient trace-context stamp (set by profiler.tracecontext on import):
# returns a small dict of args (e.g. {"trace_id": ...}) merged into every
# recorded span that does not already carry them — how ordinary op/fit
# spans correlate with the distributed request/run trace they ran under
_CTX_ARGS_FN = None


def set_context_args_fn(fn) -> None:
    """Install the ambient-context stamper (``None`` uninstalls). The
    callable must be cheap (one contextvar read) and return a dict of
    span args or None."""
    global _CTX_ARGS_FN
    _CTX_ARGS_FN = fn


def enable_tracing() -> None:
    """Turn span recording on (module-level flag)."""
    global _ENABLED
    _ENABLED = True


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def tracing_enabled() -> bool:
    return _ENABLED


def _now_us() -> float:
    return (time.perf_counter_ns() - _EPOCH_NS) / 1000.0


#: public alias — call sites that time a region themselves use this to
#: stamp after-the-fact events on the tracer's timebase
now_us = _now_us


class SpanTracer:
    """Bounded ring buffer of completed spans (thread-safe)."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()   # per-thread open-span stack
        self._stream = None             # open file: see stream_to()
        self._stream_path: Optional[str] = None
        self._stream_count = 0
        self._stream_flush_every = _STREAM_FLUSH_EVERY
        self._stream_tids: set = set()  # every (pid, tid) EVER streamed —
        # the ring may have evicted a thread's spans by stop_stream time,
        # but its thread_name metadata must still land in the file

    # ------------------------------------------------------------- recording
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def begin(self, name: str, args: Optional[Dict[str, Any]] = None) -> tuple:
        token = (name, _now_us(), args)
        self._stack().append(token)
        return token

    def end(self, token: tuple) -> None:
        st = self._stack()
        if st and st[-1] is token:
            st.pop()
        name, ts, args = token
        self.add_event(name, ts, _now_us() - ts, args, depth=len(st))

    def add_event(self, name: str, ts_us: float, dur_us: float,
                  args: Optional[Dict[str, Any]] = None,
                  depth: int = 0) -> None:
        """Record one completed span directly (after-the-fact API for call
        sites that measured a region without holding a context manager)."""
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        if depth:
            ev.setdefault("args", {})["depth"] = depth
        if _CTX_ARGS_FN is not None:
            extra = _CTX_ARGS_FN()
            if extra:
                a = ev.setdefault("args", {})
                for k, v in extra.items():
                    a.setdefault(k, v)
        with self._lock:
            self._events.append(ev)
            if self._stream is not None:
                # streamed BEFORE ring eviction can drop it: long fits
                # keep every span on disk while host memory stays bounded
                try:
                    prefix = ",\n" if self._stream_count else ""
                    self._stream.write(prefix + json.dumps(ev))
                    self._stream_count += 1
                    self._stream_tids.add((ev["pid"], ev["tid"]))
                    if self._stream_count % self._stream_flush_every == 0:
                        self._stream.flush()
                except OSError as e:
                    stream, self._stream = self._stream, None
                    try:
                        stream.close()
                    except OSError:
                        pass
                    import warnings
                    warnings.warn(
                        f"trace stream to {self._stream_path} failed "
                        f"({e}) — streaming disabled, ring buffer "
                        "retention continues", stacklevel=3)

    def current_depth(self) -> int:
        """Open-span nesting depth on the calling thread."""
        return len(self._stack())

    # --------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[dict]:
        """Snapshot of recorded spans (oldest first)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # ---------------------------------------------------------------- export
    def to_chrome_trace(self) -> dict:
        """Chrome Trace Event Format document (perfetto-loadable)."""
        evs = self.events()
        # thread-name metadata so Perfetto labels rows usefully
        seen = {}
        for ev in evs:
            seen.setdefault((ev["pid"], ev["tid"]), None)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": _thread_name(tid)}}
                for pid, tid in seen]
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Serialize to Chrome trace JSON; write to ``path`` if given."""
        doc = json.dumps(self.to_chrome_trace())
        if path:
            with open(path, "w") as f:
                f.write(doc)
        return doc

    # ------------------------------------------------------------- streaming
    def stream_to(self, path: str,
                  flush_every: int = _STREAM_FLUSH_EVERY) -> "SpanTracer":
        """Append every completed span to ``path`` as it is recorded —
        the disk-resident escape hatch from the ring buffer's horizon: a
        long fit's early spans survive on disk after the ring evicted
        them. The file is the Chrome Trace Event JSON-array format
        (Perfetto loads a truncated array from a killed process too);
        :meth:`stop_stream` terminates it properly with the thread-name
        metadata. Idempotent per path; a second call with a different
        path closes the first stream. ``flush_every`` tunes the flush
        cadence — a crash-forensics stream (the flight recorder's) sets
        1 so a killed process loses nothing buffered."""
        with self._lock:
            if self._stream is not None:
                if self._stream_path == path:
                    return self
                self._close_stream_locked()
            f = open(path, "w", buffering=1 << 16)
            f.write("[\n")
            self._stream = f
            self._stream_path = path
            self._stream_count = 0
            self._stream_flush_every = max(int(flush_every), 1)
            self._stream_tids = set()
        return self

    def stop_stream(self) -> Optional[str]:
        """Finish the streamed trace (thread-name metadata + closing
        bracket) and close the file. Returns the path, or None when no
        stream was active."""
        with self._lock:
            return self._close_stream_locked()

    def _close_stream_locked(self) -> Optional[str]:
        # contract: caller holds self._lock (the _locked suffix) — the
        # static linter cannot see a caller-held lock, hence the noqas
        if self._stream is None:
            return None
        path, stream = self._stream_path, self._stream
        self._stream = None               # dl4j: noqa=E201
        self._stream_path = None          # dl4j: noqa=E201
        try:
            # every (pid, tid) that EVER streamed — not just the ring's
            # survivors: early-epoch threads whose spans aged out of the
            # ring still get their Perfetto row labelled
            seen = set(self._stream_tids)
            self._stream_tids = set()     # dl4j: noqa=E201 (lock held)
            for ev in self._events:
                seen.add((ev["pid"], ev["tid"]))
            for pid, tid in sorted(seen):
                prefix = ",\n" if self._stream_count else ""
                stream.write(prefix + json.dumps(
                    {"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": _thread_name(tid)}}))
                self._stream_count += 1   # dl4j: noqa=E202
            stream.write("\n]\n")
        except OSError as e:
            # same contract as the recording path: a full disk at
            # teardown warns — a truncated array is Perfetto-loadable,
            # and stop_stream must never crash the end-of-fit path
            import warnings
            warnings.warn(
                f"trace stream finalize to {path} failed ({e}) — the "
                "streamed file is a truncated (still loadable) array",
                stacklevel=3)
        finally:
            try:
                stream.close()
            except OSError:
                pass
        self._stream_count = 0            # dl4j: noqa=E201
        return path


def _thread_name(tid: int) -> str:
    for t in threading.enumerate():
        if t.ident == tid:
            return t.name
    return f"thread-{tid}"


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    """Process-wide tracer singleton (what ``GET /trace`` serves)."""
    return _TRACER


class trace_span:
    """Context manager / decorator recording one span on the global tracer.

    ::

        with trace_span("op:conv2d", args_shape=(8, 1, 16, 16)):
            ...
        @trace_span("data:augment")
        def augment(batch): ...

    When tracing is disabled the context manager is a no-op (one flag
    read, no allocation beyond the object itself) and the decorated
    function adds a single flag check per call.
    """

    __slots__ = ("name", "args", "_token", "_tracer")

    def __init__(self, name: str, tracer: Optional[SpanTracer] = None,
                 **args):
        self.name = name
        self.args = args or None
        self._token = None
        self._tracer = tracer

    def _t(self) -> SpanTracer:
        # explicit None check: SpanTracer.__len__ makes an empty tracer
        # falsy, so `self._tracer or _TRACER` would silently misroute
        return self._tracer if self._tracer is not None else _TRACER

    def __enter__(self):
        if _ENABLED:
            self._token = self._t().begin(self.name, self.args)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            self._t().end(self._token)
            self._token = None
        return False

    def __call__(self, fn):
        name, args = self.name, self.args

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _ENABLED:
                return fn(*a, **kw)
            t = self._t()
            token = t.begin(name, args)
            try:
                return fn(*a, **kw)
            finally:
                t.end(token)
        return wrapper
