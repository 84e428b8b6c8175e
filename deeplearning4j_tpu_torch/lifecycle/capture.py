"""Seeded live-traffic capture on the serve path.

A :class:`TrafficCapture` hangs off ``ModelServer(capture=...)`` and
samples requests at admission into a JSONL file in the
:class:`~deeplearning4j_tpu_torch.faults.ServingLoad` replay format
(arrival offset + rows + deadline), plus the actual feature values —
the JAX package's record, so a file written by either package loads in
the other. (This records traffic; it has nothing to do with the CUDA-graph
capture of a forward.) The one stream serves three masters:

- **eval set** — :meth:`eval_features` stacks the captured rows into
  the held-out matrix the lifecycle gate scores candidates on, so the
  gate judges on exactly the traffic production sees, not a synthetic
  distribution;
- **chaos input** — :meth:`to_serving_load` rebuilds a ``ServingLoad``
  whose replay reproduces the captured arrival process against any
  server, deterministic end to end;
- **flight evidence** — capture survives the process it ran in:
  :meth:`load` tolerates a truncated trailing record (the crash case)
  the same way the flight recorder does, parsing every complete line
  and skipping the torn tail instead of refusing the file.

Capture must never hurt the serve path: sampling is a seeded counter
(deterministic, like the registry's canary accumulator — exactly
``round(n * sample_rate)`` of any n requests), records are appended
and flushed under a lock, the file is bounded by ``max_records``, and
ANY write failure increments a drop counter instead of raising into
``submit``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch import profiler as _prof

_REG = _prof.get_registry()
CAPTURED = _REG.counter(
    "dl4j_lifecycle_captured_requests_total",
    "Requests sampled into the traffic-capture file")
CAPTURE_DROPPED = _REG.counter(
    "dl4j_lifecycle_capture_dropped_total",
    "Capture records lost to write errors or the max_records bound "
    "(the serve path never pays for a failing capture)")


class TrafficCapture:
    """Append-only JSONL capture of sampled serve-path requests.

    Parameters
    ----------
    path : the JSONL file (created/appended; parent dir must exist).
    sample_rate : fraction of requests to record, applied as a
        deterministic credit accumulator (1.0 = everything).
    max_records : stop recording past this many (bounds disk + replay
        length); excess requests count as dropped.
    clock : injectable monotonic clock for the arrival offsets.
    """

    def __init__(self, path: str, sample_rate: float = 1.0,
                 max_records: int = 10000, clock=None):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate!r}")
        import time as _time
        self.path = path
        self.sample_rate = float(sample_rate)
        self.max_records = int(max_records)
        self._clock = clock or _time.monotonic
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._acc = 0.0
        self.captured = 0
        self.dropped = 0

    # ------------------------------------------------------------ record
    def record(self, features, deadline: Optional[float] = None) -> bool:
        """Maybe-record one request (called from ``ModelServer.submit``
        after validation). Returns True when the record was written.
        NEVER raises — a broken capture disk must not fail admission."""
        try:
            with self._lock:
                now = self._clock()
                if self._t0 is None:
                    self._t0 = now
                self._acc += self.sample_rate
                if self._acc < 1.0 - 1e-9:
                    return False
                self._acc -= 1.0
                if self.captured >= self.max_records:
                    self.dropped += 1
                    CAPTURE_DROPPED.inc()
                    return False
                x = np.asarray(features)
                rec = {"at": now - self._t0, "rows": int(x.shape[0]),
                       "deadline": deadline,
                       "features": x.tolist()}
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                self.captured += 1
                CAPTURED.inc()
                return True
        except Exception:
            # count, never raise: the serve path owns the caller's thread
            with self._lock:
                self.dropped += 1
            CAPTURE_DROPPED.inc()
            return False

    # ------------------------------------------------------------- load
    @staticmethod
    def load(path: str) -> List[dict]:
        """Parse every COMPLETE record; a truncated trailing line (the
        process died mid-append) is skipped, flight-recorder style —
        a crash must not poison the eval set it left behind."""
        if not os.path.exists(path):
            return []
        out: List[dict] = []
        with open(path, "rb") as f:
            data = f.read()
        for line in data.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue        # torn tail (or garbage) — skip, keep rest
            if isinstance(rec, dict) and "rows" in rec and "at" in rec:
                out.append(rec)
        return out

    @classmethod
    def to_serving_load(cls, path: str):
        """Rebuild the captured arrival process as a
        :class:`~deeplearning4j_tpu_torch.faults.ServingLoad` — replayable
        against any server/registry as deterministic chaos input."""
        from deeplearning4j_tpu_torch.faults import RequestSpec, ServingLoad
        specs = [RequestSpec(rec["at"], rec["rows"], rec.get("deadline"))
                 for rec in cls.load(path)]
        return ServingLoad(specs)

    @classmethod
    def eval_features(cls, path: str, max_rows: Optional[int] = None
                      ) -> Optional[np.ndarray]:
        """Stack the captured feature rows into one [n, ...] eval
        matrix (None when the capture is empty or held no features)."""
        rows = []
        for rec in cls.load(path):
            feats = rec.get("features")
            if feats is None:
                continue
            x = np.asarray(feats, dtype=np.float32)
            if x.ndim >= 1:
                rows.append(x)
            if max_rows is not None and sum(r.shape[0] for r in rows) \
                    >= max_rows:
                break
        if not rows:
            return None
        out = np.concatenate(rows, axis=0)
        return out[:max_rows] if max_rows is not None else out
