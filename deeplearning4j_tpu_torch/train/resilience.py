"""Fault-tolerant training — the port of
``deeplearning4j_tpu/train/resilience.py``: checkpoints and resume,
preemption, recovery from a non-finite loss.

- :class:`CheckpointConfig` + :class:`CheckpointManager` — periodic
  atomic checkpoints of the whole training state: params, updater state,
  layer states, the step clock (the dropout and augmentation draws are a
  function of it), epoch and step, the iterator's normalizer and cursor,
  the learning-rate scale and the dynamic loss-scale state. Writes go to
  a temporary directory finished by ONE ``os.replace``; every file is
  SHA-256'd into the manifest; ``keep_last`` rotation; resume takes the
  newest checkpoint that validates and QUARANTINES a corrupt one. The
  layout is the JAX package's (``model.zip`` through
  ``train.serializer``, ``extra.json``, ``normalizer.npz``,
  ``manifest.json``), so a checkpoint written by either package resumes
  in the other.
- Preemption — SIGTERM/SIGINT (:class:`SignalPreemption`) or a
  :class:`PreemptionSignal` (:class:`StepPreemption` in tests), polled
  after each dispatch: the in-flight dispatch completes, a checkpoint
  marked ``"preempted"`` is written, and ``fit`` returns cleanly.
- :class:`NanPolicy` — ``RAISE``, ``SKIP_STEP`` (drop the dispatch's
  update), ``BACKOFF_LR`` (drop it and halve the learning rate, which
  recovers after a cooldown of clean steps), ``ROLLBACK`` (restore the
  last good checkpoint); tuned by :class:`NanRecovery`.
- Transient I/O is retried with backoff (:func:`retry_io`) around
  checkpoint reads and writes; data pulls through
  ``data.dataset.RetryingDataSetIterator``.

On the card every restore writes into the SAME storage (the snapshot of
a skipped dispatch, a checkpoint, a rollback), and the learning-rate
scale is a device tensor written in place, so every captured step stays
valid and nothing is captured again. A non-finite step is found by one
host read of the dispatch's K losses, only when ``nan_policy`` is set;
the whole dispatch is dropped, as in the JAX package. Resume is bit-exact
(``fit(N)`` equals ``fit(k)`` + preemption + resume, for both networks
and for K steps a dispatch). With ``async_write`` the state is copied on
the training stream into preallocated device buffers (an event marks the
copy's end); a writer thread waits on the event, copies to pinned host
memory on a stream of its own and writes; a buffer set is reused only
once the writer has released it, the queue is bounded
(``async_queue``), and a failed write raises
:class:`AsyncCheckpointError` at the next step.

Metrics: ``dl4j_nonfinite_steps_total``, ``dl4j_rollbacks_total``,
``dl4j_checkpoint_seconds``, ``dl4j_resume_total``,
``dl4j_preemptions_total``, ``dl4j_checkpoint_quarantined_total``,
``dl4j_lr_backoffs_total``, ``dl4j_checkpoint_async_queue_depth``.

Every restore (a checkpoint, a skipped dispatch's snapshot) and a
planned layer poison (``FaultPlan(nan_layer_params_at=)``, applied in
:meth:`TrainingSession.before_step`) void the provenance sanitizer's
window (``profiler.sanitizer.invalidate``): the next dispatch takes a
fresh snapshot.

A resumed session warms the batch signature its checkpoint recorded
(:meth:`TrainingSession.warm_after_resume`) when the compile cache's disk
tier is configured.

:func:`fit_scope` runs every fit under the root span ``train:run`` and
dumps the flight recorder as ``fit:<ErrorName>`` when a fit crashes.
:class:`DriverStateStore` persists the lifecycle driver's state machine
(``lifecycle/``) with the same atomic, checksummed, quarantining
contract, in the JAX package's file format.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue as _queue
import shutil
import signal as _signal
import sys
import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import RetryingDataSetIterator
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.profiler.metrics import get_registry
from deeplearning4j_tpu_torch.utils.concurrent import ErrorLatch
from deeplearning4j_tpu_torch.utils.environment import NumericsPanicError

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = get_registry()
NONFINITE_STEPS = _REG.counter(
    "dl4j_nonfinite_steps_total",
    "Update steps whose loss came back NaN/Inf (one per poisoned step, "
    "whatever the recovery policy did about it)")
ROLLBACKS = _REG.counter(
    "dl4j_rollbacks_total",
    "Checkpoint rollbacks performed by NanPolicy.ROLLBACK")
CKPT_SECONDS = _REG.histogram(
    "dl4j_checkpoint_seconds",
    "Wall time to write one atomic training checkpoint")
RESUMES = _REG.counter(
    "dl4j_resume_total",
    "Successful auto-resumes from a validated checkpoint")
PREEMPTIONS = _REG.counter(
    "dl4j_preemptions_total",
    "Preemption requests honored (signal or synthetic); each wrote a "
    "'preempted' checkpoint when a CheckpointConfig was active")
QUARANTINED = _REG.counter(
    "dl4j_checkpoint_quarantined_total",
    "Checkpoints failing checksum/manifest validation at resume, moved "
    "aside instead of loaded")
LR_BACKOFFS = _REG.counter(
    "dl4j_lr_backoffs_total",
    "Learning-rate halvings performed by NanPolicy.BACKOFF_LR")
CKPT_ASYNC_QUEUE = _REG.gauge(
    "dl4j_checkpoint_async_queue_depth",
    "Snapshots queued for the background checkpoint writer (a full "
    "queue means the writer cannot keep up and save() waits)")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed validation: unreadable or missing manifest, a
    file it names absent, or a SHA-256 mismatch. Resume quarantines it
    and falls back to the previous one."""


class PreemptionRequested(Exception):
    """Internal control flow: a PreemptionSignal fired; the loop
    unwinds to its boundary and returns cleanly."""


class AsyncCheckpointError(RuntimeError):
    """A background checkpoint write failed after its retries; raised on
    the training thread at the next step (or at the end of the fit)."""


# --------------------------------------------------------------- I/O retry
def retry_io(fn: Callable, retries: int = 3, backoff: float = 0.05,
             exc=(OSError,)):
    """Run ``fn``, retrying transient I/O failures with exponential
    backoff."""
    attempt = 0
    while True:
        try:
            return fn()
        except exc:
            if attempt >= retries:
                raise
            time.sleep(backoff * (2 ** attempt))
            attempt += 1


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ------------------------------------------------------------ NaN policies
class NanPolicy(Enum):
    """What to do when a step's loss comes back non-finite."""

    RAISE = "raise"            # fail fast (NumericsPanicError)
    SKIP_STEP = "skip_step"    # drop the poisoned update, keep training
    BACKOFF_LR = "backoff_lr"  # drop it and halve the LR (cooldown recovery)
    ROLLBACK = "rollback"      # restore the last good checkpoint


@dataclass
class NanRecovery:
    """A NanPolicy and its tuning; ``fit(nan_policy=...)`` takes either."""

    policy: NanPolicy
    backoff_factor: float = 0.5   # LR multiplier per BACKOFF_LR event
    cooldown_steps: int = 50      # clean steps before LR recovers one notch
    min_scale: float = 2.0 ** -16  # LR-scale floor: below this, raise
    max_rollbacks: int = 3        # consecutive ROLLBACKs before raising


@dataclass
class CheckpointConfig:
    """Where, when and how to checkpoint. ``every_steps=0`` disables
    periodic saves (preemption and ``every_epochs`` still checkpoint).
    ``async_write=True`` writes on a background thread from a device copy
    of the state; ``async_queue`` bounds the snapshots waiting."""

    dir: str
    every_steps: int = 0
    every_epochs: int = 0
    resume: bool = False
    keep_last: int = 3
    io_retries: int = 3
    io_backoff: float = 0.05
    async_write: bool = False
    async_queue: int = 2


# ---------------------------------------------------------- preemption
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


# ------------------------------------------------------------ snapshots
def _skeleton(tree):
    """The nesting of dicts and lists of a state tree, leaves as None."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return [_skeleton(v) for v in tree]


def _fill(skeleton, leaves):
    """A tree of ``skeleton``'s nesting with the next ``leaves`` in
    :func:`~deeplearning4j_tpu_torch.nn.compilecache.state_tensors`
    order."""
    if skeleton is None:
        return next(leaves)
    if isinstance(skeleton, dict):
        return {k: _fill(v, leaves) for k, v in skeleton.items()}
    return [_fill(v, leaves) for v in skeleton]


class _Buffers:
    """One set of preallocated device buffers shaped like a model's
    params, layer states and updater state, and (on the card, made by
    the writer) its pinned host copy."""

    __slots__ = ("dev", "host")

    def __init__(self, tensors: List[torch.Tensor]):
        self.dev = [t.detach().clone() for t in tensors]
        self.host = None


class _SnapshotPool:
    """At most ``size`` buffer sets; :meth:`acquire` waits for the writer
    to release one once all are in use (backpressure instead of more
    device memory)."""

    def __init__(self, size: int):
        self.size = max(1, int(size))
        self._free: "_queue.Queue[_Buffers]" = _queue.Queue()
        self._made = 0
        self._lock = threading.Lock()

    def acquire(self, tensors) -> _Buffers:
        """A free buffer set shaped like ``tensors`` (one model's, which
        keep their shapes for the pool's life)."""
        try:
            return self._free.get_nowait()
        except _queue.Empty:
            pass
        with self._lock:
            if self._made < self.size:
                self._made += 1
                return _Buffers(tensors)
        return self._free.get()

    def release(self, bufs: _Buffers) -> None:
        self._free.put(bufs)


class _StateSnapshot:
    """A device copy of one model's training state, shaped for the
    networks' ``save()`` (which reads ``conf``, ``_params``/``_states``/
    ``_opt_state`` and the counters). The copy runs on the training
    stream and an event marks its end; the writer thread waits on that
    event, copies to pinned host memory on its own stream, and releases
    the buffers to the pool when the write is done."""

    def __init__(self, model, pool: _SnapshotPool):
        self._model_cls = type(model)
        self.conf = model.conf
        self._iteration = int(model._iteration)
        self._epoch = int(model._epoch)
        self._skel = [_skeleton(model._params), _skeleton(model._states),
                      _skeleton(model._opt_state)]
        live = model._snapshot_tensors()
        self._pool = pool
        self._bufs = pool.acquire(live)
        with torch.no_grad():
            torch._foreach_copy_(self._bufs.dev, live)
        self._event = None
        if self._bufs.dev and self._bufs.dev[0].is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def _host_tensors(self) -> List[torch.Tensor]:
        bufs = self._bufs
        if self._event is None:
            return bufs.dev
        if bufs.host is None:
            bufs.host = [torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in bufs.dev]
        stream = torch.cuda.Stream(bufs.dev[0].device)
        stream.wait_event(self._event)
        with torch.cuda.stream(stream):
            for h, d in zip(bufs.host, bufs.dev):
                h.copy_(d, non_blocking=True)
        stream.synchronize()
        return bufs.host

    def save(self, path: str, save_updater: bool = True):
        """Write the snapshot as the model's archive."""
        leaves = iter(self._host_tensors())
        shell = object.__new__(self._model_cls)
        shell.conf = self.conf
        shell._params, shell._states, shell._opt_state = (
            _fill(s, leaves) for s in self._skel)
        shell._iteration, shell._epoch = self._iteration, self._epoch
        shell._initialized = True
        self._model_cls.save(shell, path, save_updater)

    def release(self) -> None:
        if self._bufs is not None:
            self._pool.release(self._bufs)
            self._bufs = None


class _AsyncWriter:
    """Bounded-queue background checkpoint writer. ``submit`` blocks when
    the queue is full; the first write failure is kept for
    :meth:`CheckpointManager.raise_async_errors`."""

    _STOP = object()

    def __init__(self, manager: "CheckpointManager", depth: int):
        self.manager = manager
        self.queue: "_queue.Queue" = _queue.Queue(maxsize=max(1, int(depth)))
        self._pending = ErrorLatch()   # writer thread vs fit thread
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dl4j-ckpt-writer")
        self._thread.start()

    def take_error(self) -> Optional[BaseException]:
        """Pop the first unreported write failure (fit-thread side)."""
        return self._pending.take()

    def submit(self, job):
        self.queue.put(job)
        CKPT_ASYNC_QUEUE.set(self.queue.qsize())

    def _loop(self):
        while True:
            job = self.queue.get()
            try:
                if job is self._STOP:
                    return
                snap, status, cursor, normalizer, extra = job
                try:
                    self.manager._write(snap, status=status, cursor=cursor,
                                        normalizer=normalizer, extra=extra)
                finally:
                    snap.release()
            except BaseException as e:
                self._pending.record(e)   # first failure wins
            finally:
                self.queue.task_done()
                CKPT_ASYNC_QUEUE.set(self.queue.qsize())

    def flush(self):
        self.queue.join()

    def close(self):
        if self._thread.is_alive():
            self.queue.put(self._STOP)
            self._thread.join(timeout=30.0)


# ------------------------------------------------------------- manager
class CheckpointManager:
    """Atomic, checksummed, rotated training checkpoints (the JAX
    package's layout, one directory a checkpoint, finished by one
    ``os.replace``)::

        <dir>/ckpt_0000000042/model.zip        the model archive (params,
                                               layer states, updater
                                               state, step and epoch)
        <dir>/ckpt_0000000042/extra.json       iterator cursor + extra
                                               state (the session's,
                                               early stopping's)
        <dir>/ckpt_0000000042/normalizer.npz   the iterator's normalizer
        <dir>/ckpt_0000000042/manifest.json    step/epoch/status + each
                                               file's SHA-256
        <dir>/quarantine_ckpt_.../             failed validation at resume

    ``status`` in the manifest is ``"complete"`` or ``"preempted"``.
    """

    PREFIX = "ckpt_"

    def __init__(self, config: CheckpointConfig, fault_plan=None):
        self.config = config
        self.faults = fault_plan
        self._writer: Optional[_AsyncWriter] = None
        self._pool: Optional[_SnapshotPool] = None
        os.makedirs(config.dir, exist_ok=True)

    # ------------------------------------------------------------- naming
    def _name(self, step: int) -> str:
        return f"{self.PREFIX}{step:010d}"

    def checkpoints(self):
        """``[(step, path)]`` ascending by step (quarantined and temporary
        directories excluded)."""
        out = []
        for entry in os.listdir(self.config.dir):
            if not entry.startswith(self.PREFIX):
                continue
            suffix = entry[len(self.PREFIX):]
            if not suffix.isdigit():
                continue
            out.append((int(suffix), os.path.join(self.config.dir, entry)))
        return sorted(out)

    # --------------------------------------------------------------- save
    def save(self, model, status: str = "complete", cursor=None,
             normalizer=None, extra: Optional[dict] = None) -> str:
        """Write one checkpoint. With ``async_write`` the state is copied
        on the device and written by the background writer; the returned
        path is where it WILL land (:meth:`flush` waits for it)."""
        if self.config.async_write:
            self.raise_async_errors()
            if self._pool is None:
                self._pool = _SnapshotPool(self.config.async_queue + 1)
            snap = _StateSnapshot(model, self._pool)
            if self._writer is None:
                self._writer = _AsyncWriter(self, self.config.async_queue)
            self._writer.submit((snap, status, cursor, normalizer, extra))
            return os.path.join(self.config.dir, self._name(snap._iteration))
        return self._write(model, status, cursor, normalizer, extra)

    def _write(self, model, status: str = "complete", cursor=None,
               normalizer=None, extra: Optional[dict] = None) -> str:
        cfg = self.config
        step, epoch = int(model._iteration), int(model._epoch)
        t0 = time.perf_counter()
        name = self._name(step)
        final = os.path.join(cfg.dir, name)
        tmp = os.path.join(cfg.dir, f".tmp_{name}_{os.getpid()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def write_model():
            if self.faults is not None \
                    and self.faults.checkpoint_write_error(step):
                raise OSError(
                    f"injected checkpoint write failure at step {step}")
            model.save(os.path.join(tmp, "model.zip"), save_updater=True)
        retry_io(write_model, cfg.io_retries, cfg.io_backoff)
        if normalizer is not None:
            try:
                from deeplearning4j_tpu_torch.train.serializer import (
                    ModelSerializer)
                ModelSerializer.writeNormalizer(
                    normalizer, os.path.join(tmp, "normalizer.npz"))
            except Exception as e:   # a normalizer that cannot serialize
                warnings.warn(       # must not kill the checkpoint
                    f"checkpoint: could not serialize normalizer: {e}",
                    stacklevel=2)
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump({"cursor": cursor, "extra": extra or {}}, f)
        files = {fn: _sha256_file(os.path.join(tmp, fn))
                 for fn in sorted(os.listdir(tmp))}
        manifest = {"format": 1, "step": step, "epoch": epoch,
                    "status": status, "files": files,
                    "unix_time": time.time()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):     # a re-save of the same step
            shutil.rmtree(final)     # (preemption right after a save)
        retry_io(lambda: os.replace(tmp, final), cfg.io_retries,
                 cfg.io_backoff)
        if self.faults is not None:
            self.faults.corrupt_checkpoint(step, final)
        CKPT_SECONDS.observe(time.perf_counter() - t0)
        self._rotate()
        return final

    def _rotate(self):
        cps = self.checkpoints()
        while len(cps) > max(1, self.config.keep_last):
            _, path = cps.pop(0)
            retry_io(lambda p=path: shutil.rmtree(p, ignore_errors=False),
                     self.config.io_retries, self.config.io_backoff)

    # ----------------------------------------------------- async lifecycle
    def flush(self):
        """Wait until every queued background write has been attempted
        (a failure is reported by :meth:`raise_async_errors`)."""
        if self._writer is not None:
            self._writer.flush()
            CKPT_ASYNC_QUEUE.set(0)

    def raise_async_errors(self):
        """Re-raise the first background-write failure (once) as
        AsyncCheckpointError on the calling thread."""
        w = self._writer
        err = w.take_error() if w is not None else None
        if err is not None:
            raise AsyncCheckpointError(
                f"background checkpoint write failed: {err}") from err

    def close_writer(self):
        """Flush and stop the background writer (idempotent)."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            CKPT_ASYNC_QUEUE.set(0)

    # ----------------------------------------------------------- validate
    def validate(self, path: str) -> dict:
        """Manifest and per-file SHA-256 validation: the manifest, or
        CorruptCheckpointError naming the failing entry."""
        man_path = os.path.join(path, "manifest.json")
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CorruptCheckpointError(
                f"{path}: unreadable manifest ({e})") from e
        files = manifest.get("files") or {}
        if "model.zip" not in files:
            raise CorruptCheckpointError(
                f"{path}: manifest lists no model.zip")
        for fn, digest in files.items():
            fp = os.path.join(path, fn)
            if not os.path.exists(fp):
                raise CorruptCheckpointError(f"{path}: missing file {fn}")
            actual = _sha256_file(fp)
            if actual != digest:
                raise CorruptCheckpointError(
                    f"{path}: checksum mismatch for {fn} (manifest "
                    f"{digest[:12]}..., actual {actual[:12]}...)")
        return manifest

    def latest_valid(self):
        """The newest checkpoint passing validation as ``(path,
        manifest)``, or None; corrupt ones on the way are quarantined."""
        self.flush()    # never resume past a queued write
        for _, path in reversed(self.checkpoints()):
            try:
                return path, self.validate(path)
            except CorruptCheckpointError as e:
                self._quarantine(path, str(e))
        return None

    def _quarantine(self, path: str, reason: str):
        dst = os.path.join(os.path.dirname(path),
                           "quarantine_" + os.path.basename(path))
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.replace(path, dst)
        QUARANTINED.inc()
        warnings.warn(f"quarantined corrupt checkpoint {path}: {reason}",
                      stacklevel=3)

    # ------------------------------------------------------------ restore
    def valid_at_step(self, step: int):
        """The checkpoint of exactly ``step`` as ``(path, manifest)``, or
        None when absent or corrupt (a corrupt one is quarantined)."""
        self.flush()
        for s, path in self.checkpoints():
            if s == int(step):
                try:
                    return path, self.validate(path)
                except CorruptCheckpointError as e:
                    self._quarantine(path, str(e))
                return None
        return None

    def restore(self, model, normalizer=None, count_resume: bool = True,
                step: Optional[int] = None):
        """Load the newest valid checkpoint (or, with ``step=``, that
        step's) INTO ``model``: params, layer states, updater state,
        step, epoch and the device clock, each copied into the tensor it
        replaces (captured steps stay valid). Returns ``{"path",
        "manifest", "cursor", "extra"}``, or None when there is none."""
        from deeplearning4j_tpu_torch.train.serializer import (
            ModelSerializer, load_into)
        found = self.latest_valid() if step is None \
            else self.valid_at_step(step)
        if found is None:
            return None
        path, manifest = found
        cfg = self.config
        retry_io(lambda: load_into(model, os.path.join(path, "model.zip")),
                 cfg.io_retries, cfg.io_backoff)
        # out of band for the sanitizer's replay window
        from deeplearning4j_tpu_torch.profiler import sanitizer
        sanitizer.invalidate(model)
        extra_payload: dict = {}
        extra_path = os.path.join(path, "extra.json")
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra_payload = json.load(f)
        norm_path = os.path.join(path, "normalizer.npz")
        if normalizer is not None and os.path.exists(norm_path):
            try:
                restored = retry_io(
                    lambda: ModelSerializer.restoreNormalizer(norm_path),
                    cfg.io_retries, cfg.io_backoff)
                for k, v in restored.__dict__.items():
                    setattr(normalizer, k, v)
            except Exception as e:
                warnings.warn(f"resume: could not restore normalizer: {e}",
                              stacklevel=2)
        if count_resume:
            RESUMES.inc()
        return {"path": path, "manifest": manifest,
                "cursor": extra_payload.get("cursor"),
                "extra": extra_payload.get("extra") or {}}


# ------------------------------------------------------------- session
def _find_preprocessor(it):
    """The innermost iterator's preprocessor, through a chain of wrappers
    (retry, fault and async wrappers expose ``.base``)."""
    seen = set()
    while it is not None and id(it) not in seen:
        seen.add(id(it))
        pre = getattr(it, "_pre", None)
        if pre is not None:
            return pre
        it = getattr(it, "base", None)
    return None


def _host_losses(losses) -> np.ndarray:
    """The one host read a dispatch under a NaN policy: its losses."""
    if isinstance(losses, torch.Tensor):
        return losses.detach().float().cpu().numpy()
    return np.asarray(losses, dtype=np.float32)


class TrainingSession:
    """The resilience driver of one ``fit()``, attached as
    ``model._resilience`` while it runs. The fit loops call:

    - ``before_step()`` / ``before_dispatch()`` — under SKIP_STEP and
      BACKOFF_LR, a copy of (params, layer states, updater state) into
      buffers allocated once (``torch._foreach_copy_``).
    - ``after_step()`` / ``after_dispatch(losses, k)`` — non-finite
      detection and recovery, the periodic checkpoint, the preemption
      poll.
    - ``on_epoch_end()`` — epoch checkpoints; ``on_preempt()`` — the
      ``"preempted"`` checkpoint.

    With ``steps_per_dispatch=K`` recovery acts on the whole dispatch (a
    poisoned step skips or rolls back all K)."""

    def __init__(self, model, checkpoint: Optional[CheckpointConfig] = None,
                 nan_policy=None, faults=None, iterator=None):
        self.model = model
        self.config = checkpoint
        self.manager = (CheckpointManager(checkpoint, fault_plan=faults)
                        if checkpoint is not None else None)
        if isinstance(nan_policy, NanPolicy):
            nan_policy = NanRecovery(nan_policy)
        self.recovery: Optional[NanRecovery] = nan_policy
        self.faults = faults
        self.iterator = iterator
        self.normalizer = _find_preprocessor(iterator)
        self._signals: List[PreemptionSignal] = []
        self._sig_handler: Optional[SignalPreemption] = None
        if faults is not None:
            sig = faults.preemption_signal()
            if sig is not None:
                self._signals.append(sig)
        self._cursors = deque()
        self._cursor_at_step = None
        self._last_batch_sig = None
        self._snap_bufs: Optional[List[torch.Tensor]] = None
        self._snapshot_valid = False
        self._skip_reset = False
        self._next_save = None
        self._good_steps = 0
        self._rollbacks_in_row = 0
        self.resumed = False
        self.restored = None
        self.preempted = False

    # ----------------------------------------------------------- lifecycle
    def start(self):
        if self.manager is not None:
            self._sig_handler = SignalPreemption()
            if self._sig_handler.install():
                self._signals.append(self._sig_handler)
            else:
                self._sig_handler = None
        if self.recovery is not None \
                and self.recovery.policy is NanPolicy.BACKOFF_LR:
            # the learning-rate scale becomes dispatch state before the
            # first step, so a backoff needs no new capture
            self.model._ensure_lr_scale()

    def close(self, raise_errors: bool = True):
        """End-of-fit teardown: restore the signal handlers, detach from
        the model, drain the async writer. ``raise_errors=False`` (while
        another exception unwinds) turns a writer failure into a
        warning."""
        if self._sig_handler is not None:
            self._sig_handler.uninstall()
            self._sig_handler = None
        if getattr(self.model, "_resilience", None) is self:
            self.model._resilience = None
        if self.manager is not None:
            try:
                self.manager.flush()
                self.manager.raise_async_errors()
            except BaseException as e:
                if raise_errors:
                    raise
                warnings.warn(f"async checkpoint writer failed during "
                              f"teardown: {e}", stacklevel=2)
            finally:
                self.manager.close_writer()

    def resume(self) -> bool:
        """With ``resume=True``: restore the newest valid checkpoint and
        seek the iterator to its cursor. True when one was restored."""
        if self.manager is None or not self.config.resume:
            self._arm_next_save()
            return False
        m = self.model
        m._ensure_step_state()
        info = self.manager.restore(m, normalizer=self.normalizer)
        if info is None:
            self._arm_next_save()
            return False
        cursor = info.get("cursor")
        if cursor is not None and self.iterator is not None:
            try:
                self.iterator.seek(cursor)
                self._skip_reset = True
            except NotImplementedError:
                warnings.warn(
                    "resume: iterator does not support seek(); replaying "
                    "the interrupted epoch from its start", stacklevel=2)
        res_state = (info.get("extra") or {}).get("resilience") or {}
        lr_scale = float(res_state.get("lr_scale", 1.0))
        if lr_scale != m.lr_scale():
            m._set_lr_scale(lr_scale)
        self._good_steps = int(res_state.get("good_steps", 0))
        lss = res_state.get("loss_scale_state")
        if lss is not None and m._dynamic_scaling():
            # the automaton resumes where the checkpoint left it
            with torch.no_grad():
                m._ensure_scale_state().copy_(
                    torch.tensor(lss, dtype=torch.float32))
        self.resumed = True
        self.restored = info
        logger.info("resumed from %s (step %d, status=%s)", info["path"],
                    m._iteration, info["manifest"].get("status"))
        self._arm_next_save()
        return True

    def warm_after_resume(self, steps_per_dispatch: int = 1) -> bool:
        """With the compile cache's disk tier configured, capture the train
        step for the batch signature the restored checkpoint recorded
        before the first batch (a no-op otherwise, and without a
        resume)."""
        from deeplearning4j_tpu_torch.nn import compilecache as cc
        if not self.resumed or cc.cache_dir() is None:
            return False
        sig = ((self.restored.get("extra") or {}).get("resilience")
               or {}).get("batch_signature")
        return cc.warm_from_batch_signature(
            self.model, sig, steps_per_dispatch=steps_per_dispatch)

    def _arm_next_save(self):
        if self.manager is not None and self.config.every_steps:
            self._next_save = self.model._iteration + self.config.every_steps

    def consume_skip_reset(self) -> bool:
        """True exactly once after a cursor seek: the first epoch's
        ``reset()`` must not wipe the restored position."""
        if self._skip_reset:
            self._skip_reset = False
            return True
        return False

    # ------------------------------------------------------------- batches
    def wrap_batches(self, stream):
        """Record the iterator's cursor as each batch is pulled (pull
        order is apply order, so cursor j is the resume point after step
        j), and inject the plan's data faults for fits fed by DataSets or
        arrays (an iterator injects them in its wrapper)."""
        it = self.iterator
        plan = self.faults if it is None else None
        for ds in stream:
            if plan is not None and plan._on_pull():
                from deeplearning4j_tpu_torch.faults import _poison
                ds = _poison(ds)
            self._cursors.append(None if it is None else it.cursor())
            if self.manager is not None:
                self._last_batch_sig = cc.describe_batch(ds)
            yield ds

    # --------------------------------------------------------------- hooks
    def before_step(self):
        if self.faults is not None:
            # a planned layer poison lands before the recovery snapshot
            # and the sanitizer's, so both see it
            self.faults.poison_layer_params(self.model,
                                            self.model._iteration + 1)
        rec = self.recovery
        if rec is not None and rec.policy in (NanPolicy.SKIP_STEP,
                                              NanPolicy.BACKOFF_LR):
            live = self.model._snapshot_tensors()
            with torch.no_grad():
                if self._snap_bufs is None:
                    self._snap_bufs = [t.detach().clone() for t in live]
                else:
                    torch._foreach_copy_(self._snap_bufs, live)
            self._snapshot_valid = True

    before_dispatch = before_step

    def after_step(self):
        self._after(1, self.model._score)

    def after_dispatch(self, losses, steps: int, pulls: int = None):
        """``steps`` update steps landed in one dispatch; ``pulls`` is the
        batch pulls they took (``steps`` for a megastep, 1 for a TBPTT
        batch), so the cursor queue stays aligned with the iterator."""
        self._after(steps, losses, pulls)

    def _after(self, k: int, losses, pulls: int = None):
        for _ in range(min(k if pulls is None else pulls,
                           len(self._cursors))):
            self._cursor_at_step = self._cursors.popleft()
        if self.manager is not None:
            # a failed background write surfaces here, on the training
            # thread
            self.manager.raise_async_errors()
        if self.recovery is not None:
            vals = _host_losses(losses)
            bad = int(vals.size - np.count_nonzero(np.isfinite(vals)))
            if bad:
                self._handle_nonfinite(k, bad)
            else:
                self._snapshot_valid = False
                self._rollbacks_in_row = 0
                self._recover_lr(k)
        else:
            self._snapshot_valid = False
        m = self.model
        if self._next_save is not None and m._iteration >= self._next_save:
            self.checkpoint()
        if any(s.requested(m._iteration) for s in self._signals):
            raise PreemptionRequested(m._iteration)

    def on_epoch_end(self):
        # an epoch-boundary checkpoint resumes at the START of the next
        # epoch: the last step's cursor points at the end of the finished
        # one, and seeking there would make the resumed epoch empty
        self._cursor_at_step = None
        self._cursors.clear()
        if (self.manager is not None and self.config.every_epochs
                and self.model._epoch % self.config.every_epochs == 0):
            self.checkpoint()

    def on_preempt(self):
        """A PreemptionSignal fired (the in-flight dispatch completed):
        record it and write the ``"preempted"`` checkpoint."""
        self.preempted = True
        self.model._preempted = True
        PREEMPTIONS.inc()
        if self.manager is not None:
            self.checkpoint(status="preempted")

    # --------------------------------------------------------- checkpoints
    def checkpoint(self, status: str = "complete"):
        if self.manager is None:
            return None
        # the BACKOFF_LR scale and the dynamic loss-scale automaton are
        # training state: a resume at full LR mid-backoff, or at the
        # policy's initial scale, would replay what they suppressed
        m = self.model
        res_extra = {
            "lr_scale": float(m.lr_scale()),
            "good_steps": int(self._good_steps),
            "batch_signature": self._last_batch_sig}
        scale_state = getattr(m, "_scale_state", None)
        if scale_state is not None:
            res_extra["loss_scale_state"] = [
                float(v) for v in scale_state.detach().cpu().numpy()]
        path = self.manager.save(
            m, status=status, cursor=self._cursor_at_step,
            normalizer=self.normalizer, extra={"resilience": res_extra})
        if self.config.every_steps:
            self._next_save = m._iteration + self.config.every_steps
        return path

    # ---------------------------------------------------------- nonfinite
    def _restore_snapshot(self):
        if not self._snapshot_valid:
            return
        with torch.no_grad():
            torch._foreach_copy_(self.model._snapshot_tensors(),
                                 self._snap_bufs)
        self._snapshot_valid = False
        from deeplearning4j_tpu_torch.profiler import sanitizer
        sanitizer.invalidate(self.model)

    def _recover_lr(self, k: int):
        rec = self.recovery
        if rec.policy is not NanPolicy.BACKOFF_LR:
            return
        m = self.model
        scale = m.lr_scale()
        if scale >= 1.0:
            return
        self._good_steps += k
        if self._good_steps >= rec.cooldown_steps:
            m._set_lr_scale(min(scale / rec.backoff_factor, 1.0))
            self._good_steps = 0
            logger.info("BACKOFF_LR cooldown elapsed: lr scale %.2g -> %.2g",
                        scale, m.lr_scale())

    def _handle_nonfinite(self, k: int, bad: int):
        NONFINITE_STEPS.inc(bad)
        rec = self.recovery
        m = self.model
        where = f"iteration {m._iteration}" if k == 1 else \
            f"iterations {m._iteration - k + 1}..{m._iteration} " \
            f"({bad} non-finite)"
        if rec.policy is NanPolicy.RAISE:
            raise NumericsPanicError(
                f"non-finite loss at {where} (NanPolicy.RAISE)")
        if rec.policy is NanPolicy.SKIP_STEP:
            self._restore_snapshot()
            logger.warning("non-finite loss at %s: update skipped "
                           "(NanPolicy.SKIP_STEP)", where)
            return
        if rec.policy is NanPolicy.BACKOFF_LR:
            self._restore_snapshot()
            scale = m.lr_scale() * rec.backoff_factor
            if scale < rec.min_scale:
                raise NumericsPanicError(
                    f"non-finite loss at {where}: BACKOFF_LR reached the "
                    f"lr-scale floor ({rec.min_scale:g}): training cannot "
                    "make progress")
            m._set_lr_scale(scale)
            LR_BACKOFFS.inc()
            self._good_steps = 0
            logger.warning("non-finite loss at %s: update skipped, lr scale "
                           "-> %.2g (NanPolicy.BACKOFF_LR)", where, scale)
            return
        # ROLLBACK
        if self.manager is None:
            raise NumericsPanicError(
                f"non-finite loss at {where}: NanPolicy.ROLLBACK requires a "
                "CheckpointConfig (no checkpoint to restore)")
        self._rollbacks_in_row += 1
        if self._rollbacks_in_row > rec.max_rollbacks:
            raise NumericsPanicError(
                f"non-finite loss at {where}: {rec.max_rollbacks} "
                "consecutive rollbacks without a clean step; giving up")
        info = self.manager.restore(m, normalizer=self.normalizer,
                                    count_resume=False)
        if info is None:
            raise NumericsPanicError(
                f"non-finite loss at {where}: NanPolicy.ROLLBACK found no "
                "valid checkpoint to restore")
        self._snapshot_valid = False
        ROLLBACKS.inc()
        logger.warning("non-finite loss at %s: rolled back to %s "
                       "(NanPolicy.ROLLBACK)", where, info["path"])


def epoch_target(session: Optional[TrainingSession], model,
                 epochs: int) -> int:
    """The epoch a fit runs to: ``epochs`` counts from zero for a RESUMED
    session (the checkpoint banked ``model._epoch`` of them) and from the
    model's current epoch otherwise."""
    if session is not None and session.resumed:
        return epochs
    return model._epoch + epochs


@contextmanager
def fit_scope(session: Optional[TrainingSession], model, epochs: int):
    """The resilience envelope around a fit's epoch loop: yields the
    number of epochs left to run, turns a PreemptionRequested unwind into
    the ``"preempted"`` checkpoint and a clean return, and closes the
    session (restoring signal handlers) on every exit path.

    The loop runs under the run's root span ``train:run``, whose
    ``trace_id`` is the ``run_id`` every span of the fit carries. Any
    other exception (a NonfiniteAttributionError, an out-of-memory error,
    a dead dispatch) dumps the flight recorder as ``fit:<ErrorName>``
    before it propagates, while the evidence is still in the ring."""
    from deeplearning4j_tpu_torch.profiler import flightrec as _flightrec
    from deeplearning4j_tpu_torch.profiler import tracecontext as _tracectx
    n_epochs = max(epoch_target(session, model, epochs) - model._epoch, 0)
    try:
        with _tracectx.run_span("train:run", model=type(model).__name__,
                                epochs=n_epochs):
            yield n_epochs
    except PreemptionRequested:
        if session is None:
            raise
        session.on_preempt()
    except BaseException as e:
        _flightrec.get_flight_recorder().dump(
            f"fit:{type(e).__name__}", exc=e)
        raise
    finally:
        if session is not None:
            # surface a failed async write at fit exit, unless another
            # exception is already unwinding
            session.close(raise_errors=sys.exc_info()[1] is None)


def begin_session(model, data, checkpoint=None, nan_policy=None, faults=None):
    """Build and start the TrainingSession of one ``fit()``: wrap a
    DataSetIterator-style source in the fault-injection iterator (with a
    FaultPlan) and the transient-error retry; attach the session as
    ``model._resilience``; install the signal handler; resume. Returns
    ``(session, data)``, ``data`` the (possibly wrapped) source the fit
    must consume."""
    from deeplearning4j_tpu_torch.data.dataset import AsyncDataSetIterator
    iterator = data if hasattr(data, "hasNext") else None
    wrapped = data
    if iterator is not None:
        if checkpoint is not None and isinstance(iterator,
                                                 AsyncDataSetIterator):
            # the worker pulls ahead of the applied step: cursor()
            # overstates the position by up to prefetch + 1 batches
            warnings.warn(
                "checkpointing with an AsyncDataSetIterator source: resume "
                "cursors are APPROXIMATE (the prefetch worker runs ahead of "
                "the applied step). Pass the un-wrapped iterator for exact "
                "resume; fit() overlaps host prep through its own "
                "prefetch.", stacklevel=3)
        if faults is not None:
            wrapped = faults.wrap_iterator(wrapped)
        retries = checkpoint.io_retries if checkpoint is not None else 3
        backoff = checkpoint.io_backoff if checkpoint is not None else 0.05
        wrapped = RetryingDataSetIterator(wrapped, max_retries=retries,
                                          backoff=backoff)
    session = TrainingSession(
        model, checkpoint=checkpoint, nan_policy=nan_policy, faults=faults,
        iterator=wrapped if iterator is not None else None)
    model._resilience = session
    try:
        session.start()
        session.resume()
    except BaseException:
        # a failed restore must not leak the signal handlers or leave a
        # dead session on the model
        session.close()
        raise
    return session, wrapped


# ------------------------------------------------- lifecycle driver state
class DriverStateStore:
    """Atomic, checksummed persistence for the lifecycle driver's state
    machine — the durability contract of a training checkpoint, scaled
    down to one JSON document: a crash mid-write never leaves half a
    state under the real name (a temporary file and one ``os.replace``),
    every load checks a SHA-256 over the canonical payload, and a corrupt
    file is QUARANTINED (renamed aside) rather than trusted, so a resumed
    driver starts from "no state" instead of from garbage. Writes go
    through :func:`retry_io`.

    The file is the JAX package's (``{"state": ..., "sha256": ...}``
    under :attr:`FILENAME`), so a state written by either package loads
    in the other. The driver persists at every phase transition, so
    after a SIGKILL its successor knows which round, phase and candidate
    were in flight and whether a canary must be aborted first.
    """

    FILENAME = "lifecycle_driver_state.json"

    def __init__(self, state_dir: str, io_retries: int = 3,
                 io_backoff: float = 0.05):
        self.dir = state_dir
        self.path = os.path.join(state_dir, self.FILENAME)
        self._retries = int(io_retries)
        self._backoff = float(io_backoff)
        os.makedirs(state_dir, exist_ok=True)

    @staticmethod
    def _digest(state: dict) -> str:
        canon = json.dumps(state, sort_keys=True,
                           separators=(",", ":")).encode()
        return hashlib.sha256(canon).hexdigest()

    def save(self, state: dict) -> None:
        """Persist ``state`` atomically (JSON-serializable values only)."""
        doc = {"state": state, "sha256": self._digest(state)}
        tmp = self.path + ".tmp"

        def write():
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

        retry_io(write, retries=self._retries, backoff=self._backoff)

    def load(self) -> Optional[dict]:
        """The last saved state, or None (no state yet, or the file was
        corrupt: then it has been quarantined and counted in
        ``dl4j_checkpoint_quarantined_total``)."""
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                doc = json.load(f)
            state = doc["state"]
            if self._digest(state) != doc["sha256"]:
                raise CorruptCheckpointError(
                    f"driver state {self.path}: checksum mismatch")
            return state
        except (OSError, ValueError, KeyError, TypeError,
                CorruptCheckpointError) as e:
            quarantine = os.path.join(
                self.dir, "quarantine_" + self.FILENAME)
            try:
                os.replace(self.path, quarantine)
            except OSError:
                pass
            QUARANTINED.inc()
            logger.warning(
                "driver state %s failed validation (%s) — quarantined to "
                "%s; the driver resumes stateless", self.path, e, quarantine)
            return None

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
