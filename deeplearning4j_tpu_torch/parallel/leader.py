"""One leader, the other ranks its followers: the dispatch a server
(``serving.ModelServer``) and ``parallel.ParallelInference`` run over a
mesh of more than one rank.

The mesh's first rank admits requests, batches them and replies; every
other rank runs the same server in follower mode (:meth:`MeshDispatch.
follow`). A dispatch is:

1. the leader broadcasts a header (the operation, the target's key, the
   batch index, the bucket's shape and dtype) and then the bucket's
   features, over a group of the whole mesh;
2. every rank takes its rows of the bucket (split over the ``data``
   axis; the ranks of a ``model`` or ``seq`` line take the same rows and
   join one collective forward), checks the fault plan
   (``FaultPlan.serving_forward``, the same decision on every rank) and
   runs its local forward;
3. one all-gather of every rank's ``(ok, result)`` to every rank: the
   leader joins the results of each data line's first rank in data
   order; a failure anywhere fails the dispatch on every rank alike.

After a failed dispatch every rank calls :meth:`MeshDispatch.recover`
at the same point: a rank the fault plan reads as dead leaves (its
:meth:`follow` returns ``"lost"``), the survivors form a smaller group
(``parallel.elastic.shrink_mesh_on_dead``, which keeps a mesh with model
or seq axes as it is) and the leader retries on them. The leader's
dispatches of every target on one group are serialized by one lock, so
a retry waits for a dispatch its watchdog abandoned.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import collectives

OP_STOP, OP_FORWARD, OP_CAPTURE = 0, 1, 2
_HDR = 16           # op, key, batch, ndim, dtype, then up to 11 dims
_DTYPES = (np.float32, np.float64, np.float16, np.int64, np.int32,
           np.uint8, np.int8, np.bool_)

#: one lock a process group: the leader's dispatches on it, whatever
#: their target, go one at a time
_GROUP_LOCKS: Dict[int, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _key(name: str) -> int:
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


class DispatchFailed(RuntimeError):
    """A dispatch failed on some rank (every rank raises it alike)."""


class MeshDispatch:
    """The leader/follower dispatch of one target (a server's forward)
    over ``mesh`` (module note). ``forward(x, capture)`` runs a rank's
    rows (a numpy array) and returns its host result; ``faults`` is the
    fault plan every rank consults; ``on_shrink(mesh)`` runs on every
    survivor after a shrink."""

    def __init__(self, mesh, forward: Callable, name: str, faults=None,
                 context: str = "serving", on_shrink: Callable = None):
        self.mesh = mesh
        self.forward = forward
        self.key = _key(name)
        self.faults = faults
        self.context = context
        self.on_shrink = on_shrink
        self.last_shrink_seconds: Optional[float] = None
        self._group = None

    # ------------------------------------------------------------ the mesh
    @property
    def multi(self) -> bool:
        return self.mesh.size() > 1 and dist.is_initialized()

    @property
    def is_leader(self) -> bool:
        return not self.multi or dist.get_rank() == self.mesh.leader()

    def group(self):
        """A group of the whole mesh (the default group when the mesh
        spans it)."""
        if self._group is None:
            if len(self.mesh.ranks) == dist.get_world_size():
                self._group = dist.group.WORLD
            else:
                self._group = self.mesh.group_over(self.mesh.axis_names)
        return self._group

    def _lock(self) -> threading.Lock:
        with _LOCKS_LOCK:
            return _GROUP_LOCKS.setdefault(id(self.group()),
                                           threading.Lock())

    def _members(self):
        return [d.id for d in self.mesh.devices]

    # ------------------------------------------------------------- leader
    def run(self, feats: np.ndarray, batch: int,
            capture: bool = False):
        """The leader's dispatch of one bucket: the joined host result
        of every data line, or :class:`DispatchFailed`."""
        if not self.multi:
            if not capture:
                self._check_faults(batch)
            return self.forward(feats, capture)
        feats = np.ascontiguousarray(feats)
        with self._lock():
            hdr = [OP_CAPTURE if capture else OP_FORWARD, self.key,
                   int(batch), feats.ndim,
                   _DTYPES.index(feats.dtype.type)] + list(feats.shape)
            self._bcast_header(hdr)
            x = torch.from_numpy(feats).to(self._wire())
            collectives.broadcast(x, self.group())
            return self._local(x, batch, capture)

    def wait_idle(self) -> None:
        """Block until no dispatch of this group is in flight (one a
        watchdog abandoned finishes first): a retry waits here, outside
        its own deadline."""
        if self.multi:
            with self._lock():
                pass

    def stop(self) -> None:
        """Release the followers of this target."""
        if not self.multi:
            return
        with self._lock():
            self._bcast_header([OP_STOP, self.key])

    # ----------------------------------------------------------- follower
    def follow(self) -> str:
        """Serve the leader's dispatches of this target until it stops
        them (``"stopped"``) or the fault plan takes this rank
        (``"lost"``)."""
        return follow_all(self.mesh, {self.key: self})

    # ------------------------------------------------------------ helpers
    def _wire(self) -> torch.device:
        return self.mesh.device

    def _bcast_header(self, fields) -> None:
        hdr = torch.zeros(_HDR, dtype=torch.int64)
        hdr[:len(fields)] = torch.tensor(fields, dtype=torch.int64)
        h = hdr.to(self._wire())
        collectives.broadcast(h, self.group())

    def _check_faults(self, batch: int) -> None:
        if self.faults is not None:
            self.faults.serving_forward(batch, self._members())

    def _local(self, x: torch.Tensor, batch: int, capture: bool):
        """Every rank's half of a dispatch: its rows, the fault check,
        the forward, and the all-gather of the outcomes."""
        w = self.mesh.size("data")
        c = x.shape[0] // w
        r = self.mesh.coordinate("data")
        first = all(self.mesh.coordinate(a) == 0
                    for a in self.mesh.axis_names if a != "data")
        try:
            if not capture:     # a warmup is no serving batch
                self._check_faults(batch)
            out = self.forward(x[r * c:(r + 1) * c].cpu().numpy(), capture)
            mine = (True, r, first, out)
        except Exception as e:          # reported to every rank
            mine = (False, r, first, f"{type(e).__name__}: {e}")
        got = [None] * dist.get_world_size(self.group())
        dist.all_gather_object(got, mine, group=self.group())
        bad = [m for m in got if not m[0]]
        if bad:
            raise DispatchFailed(f"{self.context} dispatch failed on "
                                 f"{len(bad)} rank(s): {bad[0][3]}")
        parts = sorted((m for m in got if m[2]), key=lambda m: m[1])
        return _join([m[3] for m in parts])

    def recover(self) -> bool:
        """After a failed dispatch, on every rank at the same point: is
        this rank lost (True: it leaves)? Otherwise shrink onto the
        survivors when some are dead (``on_shrink`` then runs)."""
        from deeplearning4j_tpu_torch.parallel import init as _init
        from deeplearning4j_tpu_torch.parallel.elastic import \
            shrink_mesh_on_dead
        if not self.multi:
            return False
        shrinkable = self.mesh.size() == self.mesh.size("data")
        if shrinkable and self.faults is not None and \
                _init.member_id() in self.faults.dead_devices():
            return True
        t0 = time.perf_counter()
        new = shrink_mesh_on_dead(self.mesh, plan=self.faults,
                                  context=self.context)
        if new is not None:
            self.mesh = new
            self._group = None
            if self.on_shrink is not None:
                self.on_shrink(new)
            self.last_shrink_seconds = time.perf_counter() - t0
        return False


def _join(parts):
    """The data lines' results in order, joined along the rows."""
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_join([p[i] for p in parts])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _join([p[k] for p in parts]) for k in first}
    if len(parts) == 1:
        return first
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def follow_all(mesh, targets: Dict[int, MeshDispatch]) -> str:
    """A follower's loop over the leader's dispatches of several targets
    (by key; a registry's versions): ``OP_STOP`` of one target drops it
    and the loop ends with the last. Returns ``"stopped"``, or
    ``"lost"`` when the fault plan takes this rank."""
    targets = dict(targets)
    any_t = next(iter(targets.values()))
    while targets:
        hdr = torch.zeros(_HDR, dtype=torch.int64).to(any_t._wire())
        collectives.broadcast(hdr, any_t.group())
        h = hdr.cpu().tolist()
        op, key = h[0], h[1]
        t = targets.get(key)
        if t is None:
            raise RuntimeError(f"follower: no target with key {key} "
                               f"(have {sorted(targets)})")
        if op == OP_STOP:
            del targets[key]
            continue
        batch, ndim, code = h[2], h[3], h[4]
        shape = tuple(h[5:5 + ndim])
        x = torch.empty(shape, dtype=torch.from_numpy(
            np.zeros(0, _DTYPES[code])).dtype, device=t._wire())
        collectives.broadcast(x, t.group())
        try:
            t._local(x, batch, op == OP_CAPTURE)
        except DispatchFailed:
            if t.recover():
                return "lost"
            for other in targets.values():
                other.mesh, other._group = t.mesh, None
            any_t = t
    return "stopped"
