"""Crash flight recorder: always-on event ring + debug bundle dump — the
port of ``deeplearning4j_tpu/profiler/flightrec.py``.

- :meth:`FlightRecorder.record` appends a structured event (kind +
  fields + monotonic timestamp) to a bounded ring. It is always on (no
  tracing flag): one deque append per event, at low-frequency seams
  (dispatch signatures, retries, failures, registry rolls), never per
  kernel.
- :meth:`FlightRecorder.dump` writes a debug bundle directory on
  trigger: ``events.json`` (the ring), ``trace.json`` (the process
  tracer's recent spans — Perfetto-loadable), ``metrics.txt`` (full
  registry exposition), ``config.json`` (torch/CUDA and the card,
  captured-dispatch statistics, pid/python), and ``reason.txt``
  (trigger type, message, traceback). Dumps are rate-limited per reason
  and never raise — a recorder failure must not mask the crash it is
  documenting.

Triggers wired in the port: the serving loop's death path,
:class:`~deeplearning4j_tpu_torch.parallel.elastic.DispatchTimeoutError`
retries and a crashing fit (``fit:<ErrorName>``, from
``train.resilience.fit_scope``). The bundle directory defaults to ``$DL4J_FLIGHTREC_DIR`` or
``<tempdir>/dl4j-flightrec``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import tempfile
import threading
import time
import traceback
from typing import Deque, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

_ENV_DIR = "DL4J_FLIGHTREC_DIR"


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x) for x in v]
    return repr(v)


class FlightRecorder:
    """Bounded ring of structured events plus the bundle dumper.

    ``capacity`` bounds memory (a deque of dicts); ``min_dump_interval``
    rate-limits dumps *per reason* so a retry storm produces one bundle,
    not hundreds; ``clock`` is injectable for tests.
    """

    def __init__(self, capacity: int = 4096,
                 directory: Optional[str] = None,
                 min_dump_interval: float = 5.0,
                 clock=time.monotonic):
        self.capacity = int(capacity)
        self.directory = directory
        self.min_dump_interval = float(min_dump_interval)
        self._clock = clock
        self._ring: Deque[dict] = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_dump: dict = {}
        self._seq = 0
        self.dumps: List[str] = []

    # ---------------------------------------------------------- record
    def record(self, kind: str, **fields) -> None:
        """Append one event to the ring (always-on; one lock + deque
        append). ``fields`` must be cheap — repr() is applied lazily
        only at dump time for non-JSON values."""
        ev = {"t": self._clock(), "kind": str(kind)}
        if fields:
            ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    def events(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            evs = list(self._ring)
        return evs if last is None else evs[-int(last):]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------ dump
    def _resolve_dir(self, directory: Optional[str]) -> str:
        return (directory or self.directory or os.environ.get(_ENV_DIR)
                or os.path.join(tempfile.gettempdir(), "dl4j-flightrec"))

    def _config(self) -> dict:
        cfg: dict = {"pid": os.getpid(), "python": sys.version,
                     "argv": list(sys.argv)}
        try:
            from deeplearning4j_tpu_torch.nn import compilecache as _cc
            cfg["compile_cache"] = {"stats": _jsonable(_cc.cache_stats())}
        except Exception as e:                      # pragma: no cover
            cfg["compile_cache"] = {"error": repr(e)}
        try:
            # guarded: the card may be mid-crash or unreachable — a
            # bundle without topology beats no bundle
            import torch
            cfg["torch"] = torch.__version__
            cfg["cuda"] = torch.version.cuda
            if torch.cuda.is_available():
                cfg["devices"] = [torch.cuda.get_device_name(i) for i in
                                  range(torch.cuda.device_count())]
        except Exception as e:
            cfg["torch_error"] = repr(e)
        return cfg

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             directory: Optional[str] = None) -> Optional[str]:
        """Write a debug bundle; returns its path, or None when
        rate-limited or the write failed. NEVER raises."""
        try:
            now = self._clock()
            with self._lock:
                last = self._last_dump.get(reason)
                if last is not None \
                        and now - last < self.min_dump_interval:
                    return None
                self._last_dump[reason] = now
                self._seq += 1
                seq = self._seq
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in str(reason))[:64]
            root = self._resolve_dir(directory)
            path = os.path.join(root,
                                f"flightrec-{os.getpid()}-{seq}-{safe}")
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "events.json"), "w") as f:
                json.dump([_jsonable(ev) for ev in self.events()], f,
                          indent=1)
            try:
                from deeplearning4j_tpu_torch.profiler import tracer as _tracer
                with open(os.path.join(path, "trace.json"), "w") as f:
                    json.dump(_tracer.get_tracer().to_chrome_trace(), f)
            except Exception as e:
                with open(os.path.join(path, "trace.json"), "w") as f:
                    json.dump({"error": repr(e)}, f)
            try:
                from deeplearning4j_tpu_torch.profiler import metrics as _m
                with open(os.path.join(path, "metrics.txt"), "w") as f:
                    f.write(_m.get_registry().exposition())
            except Exception as e:
                with open(os.path.join(path, "metrics.txt"), "w") as f:
                    f.write(f"# exposition failed: {e!r}\n")
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(_jsonable(self._config()), f, indent=1)
            with open(os.path.join(path, "reason.txt"), "w") as f:
                f.write(f"reason: {reason}\n")
                if exc is not None:
                    f.write(f"exception: {type(exc).__name__}: {exc}\n\n")
                    f.write("".join(traceback.format_exception(
                        type(exc), exc, exc.__traceback__)))
            with self._lock:
                self.dumps.append(path)
            logger.warning("flight recorder dumped %s bundle: %s",
                           reason, path)
            return path
        except Exception:                           # pragma: no cover
            logger.warning("flight recorder dump failed", exc_info=True)
            return None


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """Process-wide recorder singleton (what the serving loop,
    fit_scope, and the coordinator record into)."""
    return _RECORDER


def configure(directory: Optional[str] = None,
              capacity: Optional[int] = None,
              min_dump_interval: Optional[float] = None) -> FlightRecorder:
    """Adjust the singleton in place (events already recorded are kept
    unless capacity shrinks below the ring's length)."""
    r = _RECORDER
    if directory is not None:
        r.directory = directory
    if capacity is not None:
        r.capacity = int(capacity)
        with r._lock:
            r._ring = collections.deque(r._ring, maxlen=r.capacity)
    if min_dump_interval is not None:
        r.min_dump_interval = float(min_dump_interval)
    return r
