"""Stats storage — the persistence layer of the training dashboard.

Reference parity: ``org.deeplearning4j.api.storage.StatsStorage`` with
``InMemoryStatsStorage`` / ``FileStatsStorage`` implementations and
``StatsStorageRouter`` (the StatsListener -> StatsStorage -> UIServer
chain).

Records are plain JSON-able dicts with reserved keys:
``session_id``, ``type_id`` ("static" | "update"), ``worker_id``,
``timestamp``, ``iteration``. Everything else is payload. The storage is
append-only; readers query by session and iteration watermark — exactly
the access pattern the dashboard polls with.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock


class StatsStorageEvent:
    """ref: StatsStorageEvent — notification unit for attached listeners."""

    def __init__(self, kind: str, session_id: str, record: Dict):
        self.kind = kind            # "new_session" | "static" | "update"
        self.session_id = session_id
        self.record = record


class StatsStorage:
    """Abstract storage (ref: org.deeplearning4j.api.storage.StatsStorage)."""

    def __init__(self):
        self._listeners: List[Callable[[StatsStorageEvent], None]] = []
        self._lock = InstrumentedLock("ui:stats")

    # ---------------------------------------------------------------- write
    def putStaticInfo(self, record: Dict):
        record = dict(record)
        record.setdefault("type_id", "static")
        record.setdefault("timestamp", time.time())
        is_new = self._store(record, static=True)
        if is_new:
            self._notify(StatsStorageEvent("new_session",
                                           record["session_id"], record))
        self._notify(StatsStorageEvent("static", record["session_id"], record))

    def putUpdate(self, record: Dict):
        record = dict(record)
        record.setdefault("type_id", "update")
        record.setdefault("timestamp", time.time())
        self._store(record, static=False)
        self._notify(StatsStorageEvent("update", record["session_id"], record))

    # ----------------------------------------------------------------- read
    def listSessionIDs(self) -> List[str]:
        raise NotImplementedError

    def getStaticInfo(self, session_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def getAllUpdates(self, session_id: str) -> List[Dict]:
        raise NotImplementedError

    def getLatestUpdate(self, session_id: str) -> Optional[Dict]:
        ups = self.getAllUpdates(session_id)
        return ups[-1] if ups else None

    def getAllUpdatesAfter(self, session_id: str, iteration: int) -> List[Dict]:
        return [u for u in self.getAllUpdates(session_id)
                if u.get("iteration", -1) > iteration]

    # ------------------------------------------------------------ listeners
    def registerStatsStorageListener(self, cb: Callable[[StatsStorageEvent], None]):
        # registration can race a training thread mid-_notify: mutate
        # and snapshot the listener list under the storage lock
        with self._lock:
            self._listeners.append(cb)

    def _notify(self, event: StatsStorageEvent):
        with self._lock:
            listeners = list(self._listeners)
        for cb in listeners:
            cb(event)

    def _store(self, record: Dict, static: bool) -> bool:
        """Persist; returns True if this opened a new session."""
        raise NotImplementedError

    def close(self):
        pass


class InMemoryStatsStorage(StatsStorage):
    """ref: InMemoryStatsStorage — dict-backed, process-local."""

    def __init__(self):
        super().__init__()
        self._static: Dict[str, Dict] = {}
        self._updates: Dict[str, List[Dict]] = {}

    def _store(self, record, static):
        sid = record["session_id"]
        with self._lock:
            is_new = sid not in self._static and sid not in self._updates
            if static:
                self._static[sid] = record
            else:
                self._updates.setdefault(sid, []).append(record)
        return is_new

    def listSessionIDs(self):
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def getStaticInfo(self, session_id):
        # UI request threads read while the training thread stores
        with self._lock:
            return self._static.get(session_id)

    def getAllUpdates(self, session_id):
        with self._lock:
            return list(self._updates.get(session_id, []))


class FileStatsStorage(InMemoryStatsStorage):
    """ref: FileStatsStorage — the in-memory index plus an append-only
    JSONL file, reloaded on open (the UI can be pointed at the file of a
    finished or remote run)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    sid = rec.get("session_id", "?")
                    if rec.get("type_id") == "static":
                        self._static[sid] = rec
                    else:
                        self._updates.setdefault(sid, []).append(rec)
        else:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a")

    def _store(self, record, static):
        is_new = super()._store(record, static)
        with self._lock:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        return is_new

    def close(self):
        with self._lock:        # a racing _store must not hit a closed fh
            self._fh.close()


class StatsStorageRouter:
    """ref: StatsStorageRouter — fan records out to several storages
    (e.g. in-memory for the live UI + file for archival)."""

    def __init__(self, *storages: StatsStorage):
        self.storages = list(storages)

    def putStaticInfo(self, record):
        for s in self.storages:
            s.putStaticInfo(record)

    def putUpdate(self, record):
        for s in self.storages:
            s.putUpdate(record)
