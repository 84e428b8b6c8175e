"""Staged, composable host input pipeline (the port of
``deeplearning4j_tpu/data/pipeline.py``): decode in worker processes,
megabatch staging through a shared-memory ring, one uint8 copy to the
card a dispatch.

The reference feeds its training loops through ``ImageRecordReader ->
RecordReaderDataSetIterator -> AsyncDataSetIterator``; the JAX package
composes the pipeline out of independent stages, as ``tf.data`` does::

    list -> shuffle -> interleave -> decode(workers) -> batch
         -> stage(K) -> prefetch

- **list / shuffle / interleave** are order stages: enumerate files, a
  seeded permutation an epoch, a round-robin interleave across shards.
- **decode(workers)** runs in ``spawn`` worker processes
  (:mod:`.decode`, which imports no torch: a worker never touches the
  card). Decoded pixels land straight in a preallocated
  ``multiprocessing.shared_memory`` ring slot.
- **batch + stage(K)** are the ring's geometry: a slot is one megabatch
  ``[K, B, C, H, W]`` whose K sub-batches any worker may decode; the
  consumer ships a completed slot as ONE contiguous uint8 array a
  ``fit(steps_per_dispatch=K)`` dispatch (``dispatch_stream``), which the
  fit's ``DevicePrefetcher`` copies to the card through page-locked
  memory on a side stream.
- **prefetch** bounds how many megabatches decode may run ahead (the
  ring's depth).

Batches are uint8 NCHW by default; the cast to the compute dtype happens
on the card, in the network's forward. Every ring batch has one shape, so
the train step is captured once; tail files that do not fill a batch are
dropped by default or decoded on the host into a final partial batch
(``drop_last=False``).

Metrics (while instrumentation is active):
``dl4j_pipeline_stage_seconds{stage=shuffle|decode|stage|tail}``,
``dl4j_pipeline_stall_seconds{stage=consume|decode_idle}``,
``dl4j_pipeline_queue_depth{stage=ready|tasks}`` and
``dl4j_pipeline_h2d_bytes_total``.

Worker liveness: every blocking wait on the decode pool polls the worker
processes; a dead worker raises a :class:`DataPipelineError` naming it
instead of hanging, and so does a file that fails to decode (latched
until ``reset()``, which rebuilds a dead pool).
"""

from __future__ import annotations

import atexit
import os
import queue
import time
import uuid
from multiprocessing import get_context
from multiprocessing import shared_memory as _shm
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.data.dataset import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.data.decode import decode_one as _decode_one
from deeplearning4j_tpu_torch.data.decode import worker_main as _worker_main
from deeplearning4j_tpu_torch.data.image import (ImageTransform,
                                                 NativeImageLoader,
                                                 ParentPathLabelGenerator,
                                                 _list_images)
from deeplearning4j_tpu_torch.profiler.locks import InstrumentedRLock

_REG = _prof.get_registry()
_STAGE_SECONDS = _REG.histogram(
    "dl4j_pipeline_stage_seconds",
    "Work time per input-pipeline stage (decode = one sub-batch in a "
    "worker process, stage = ring-to-contiguous megabatch copy)",
    labelnames=("stage",))
_STALL_SECONDS = _REG.counter(
    "dl4j_pipeline_stall_seconds",
    "Seconds a pipeline stage spent blocked: consume = the training "
    "thread waiting on decode output, decode_idle = decode workers "
    "starved for tasks (ring full or consumer slow)",
    labelnames=("stage",))
_QUEUE_DEPTH = _REG.gauge(
    "dl4j_pipeline_queue_depth",
    "Input-pipeline queue depths: ready = decoded megabatches awaiting "
    "the consumer, tasks = sub-batches queued for the decode pool",
    labelnames=("stage",))
_H2D_BYTES = _REG.counter(
    "dl4j_pipeline_h2d_bytes_total",
    "Bytes the staged pipeline handed to device staging (uint8 megabatch "
    "payloads; the H2D bill of the input path)")


class DataPipelineError(IOError):
    """A structural input-pipeline failure: a decode worker process died
    (OOM-killed, segfaulted native decoder) or reported a decode error.
    NOT transient (``is_transient_error`` -> False): the retry loops in
    data/dataset.py must not re-pull — the pool needs a ``reset()`` (which
    rebuilds dead workers) or a fix to the offending file."""

    transient = False


# --------------------------------------------------------------------- stages
class Stage:
    """One declarative pipeline stage: a name plus its parameters.
    Stages carry no runtime state — :meth:`ImagePipeline.build` compiles
    the stage list into a :class:`StagedImageIterator` (the way a tf.data
    graph compiles into its iterator)."""

    name = "stage"

    def __init__(self, **params):
        self.params = dict(params)

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self.params.items())
                          if v is not None)
        return f"{self.name}({inner})"


class ListStage(Stage):
    name = "list"


class ShuffleStage(Stage):
    name = "shuffle"


class InterleaveStage(Stage):
    name = "interleave"


class DecodeStage(Stage):
    name = "decode"


class BatchStage(Stage):
    name = "batch"


class MegabatchStage(Stage):
    name = "stage"


class PrefetchStage(Stage):
    name = "prefetch"


class ImagePipeline:
    """Composable builder for the staged image input pipeline::

        it = (ImagePipeline.list("/data/train")
              .shuffle(seed=7)
              .interleave(shards=4)
              .decode(height=224, width=224, workers=8)
              .batch(256)
              .stage(steps_per_dispatch=4)
              .prefetch(4)
              .build())
        net.fit(it, epochs=5, steps_per_dispatch=4)

    Stages may be declared in any order after :meth:`list`; ``decode``
    and ``batch`` are required, the rest are optional. ``describe()``
    returns the declared stage graph; ``build()`` compiles it into a
    :class:`StagedImageIterator`. :class:`MultiWorkerImageIterator` is a
    one-call preset over exactly these stages."""

    def __init__(self):
        self._list: Optional[ListStage] = None
        self._shuffle: Optional[ShuffleStage] = None
        self._interleave: Optional[InterleaveStage] = None
        self._decode: Optional[DecodeStage] = None
        self._batch: Optional[BatchStage] = None
        self._stage: Optional[MegabatchStage] = None
        self._prefetch: Optional[PrefetchStage] = None

    # -- construction ---------------------------------------------------
    @staticmethod
    def list(root: Optional[str] = None, files: Optional[Sequence[str]] = None,
             label_generator=None) -> "ImagePipeline":
        """Source stage: a directory of class-directories, or an explicit
        file list. Labels come from ``label_generator`` (default: parent
        directory name)."""
        p = ImagePipeline()
        p._list = ListStage(root=root, files=list(files) if files else None,
                            label_generator=label_generator)
        return p

    def shuffle(self, seed: int = 12345) -> "ImagePipeline":
        """Seeded per-epoch permutation of the file order (epoch e draws
        from ``seed + e`` — rebuildable exactly by ``seek()``)."""
        self._shuffle = ShuffleStage(seed=int(seed))
        return self

    def interleave(self, shards: int) -> "ImagePipeline":
        """Round-robin interleave across ``shards`` contiguous slices of
        the (possibly shuffled) file order, so consecutive batches mix
        directories even without a full shuffle (tf.data interleave)."""
        if int(shards) < 1:
            raise ValueError("interleave shards must be >= 1")
        self._interleave = InterleaveStage(shards=int(shards))
        return self

    def decode(self, height: int, width: int, channels: int = 3,
               workers: Optional[int] = None,
               transform: Optional[ImageTransform] = None,
               dtype: str = "uint8") -> "ImagePipeline":
        """Multi-process decode (+ optional host-side ``transform``) to
        fixed ``[C, height, width]`` pixels. ``dtype="uint8"`` (default)
        ships bytes and casts/augments on device; ``"float32"`` opts back
        into host floats for nets needing pre-normalized input."""
        self._decode = DecodeStage(height=int(height), width=int(width),
                                   channels=int(channels), workers=workers,
                                   transform=transform, dtype=dtype)
        return self

    def batch(self, batch_size: int, drop_last: bool = True) -> "ImagePipeline":
        self._batch = BatchStage(batch_size=int(batch_size),
                                 drop_last=bool(drop_last))
        return self

    def stage(self, steps_per_dispatch: int) -> "ImagePipeline":
        """Megabatch staging: group K batches into one contiguous
        ``[K, B, C, H, W]`` buffer shipped as ONE uint8 H2D transfer per
        ``fit(steps_per_dispatch=K)`` dispatch."""
        if int(steps_per_dispatch) < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self._stage = MegabatchStage(steps_per_dispatch=int(steps_per_dispatch))
        return self

    def prefetch(self, depth: int) -> "ImagePipeline":
        """Ring depth: how many megabatches the decode pool may run ahead
        of the consumer (default ``2*workers/K + 2``-ish)."""
        if int(depth) < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._prefetch = PrefetchStage(depth=int(depth))
        return self

    def describe(self) -> List[Stage]:
        """The declared stage graph, in execution order."""
        return [s for s in (self._list, self._shuffle, self._interleave,
                            self._decode, self._batch, self._stage,
                            self._prefetch) if s is not None]

    def build(self, seed: int = 12345,
              start_method: str = "spawn") -> "StagedImageIterator":
        if self._list is None or self._decode is None or self._batch is None:
            raise ValueError("an ImagePipeline needs at least "
                             "list().decode(...).batch(...) stages")
        d, b = self._decode.params, self._batch.params
        return StagedImageIterator(
            root=self._list.params["root"], files=self._list.params["files"],
            label_generator=self._list.params["label_generator"],
            height=d["height"], width=d["width"], channels=d["channels"],
            workers=d["workers"], transform=d["transform"], dtype=d["dtype"],
            batch_size=b["batch_size"], drop_last=b["drop_last"],
            steps_per_dispatch=(self._stage.params["steps_per_dispatch"]
                                if self._stage else 1),
            n_slots=(self._prefetch.params["depth"] if self._prefetch
                     else None),
            shuffle=self._shuffle is not None,
            seed=(self._shuffle.params["seed"] if self._shuffle else seed),
            interleave=(self._interleave.params["shards"]
                        if self._interleave else 1),
            start_method=start_method)


# -------------------------------------------------------------------- runtime
class StagedImageIterator(DataSetIterator):
    """Runtime of the staged pipeline (build via :class:`ImagePipeline`
    or the :class:`MultiWorkerImageIterator` preset).

    Ring geometry: the shared-memory ring holds ``n_slots`` megaslots of
    ``[K, B, C, H, W]``; a *task* is one sub-batch ``(mega_id, k)`` and
    any worker may take any task, so the K sub-batches of a megabatch
    decode in parallel. Megabatches are emitted IN ORDER (a small
    reorder buffer absorbs out-of-order completions), which makes epoch
    content deterministic and ``cursor()``/``seek()`` exact.

    ``next()`` yields per-batch uint8 NCHW DataSets;
    ``dispatch_stream()`` yields whole
    :class:`~deeplearning4j_tpu_torch.train.stepping.MegaBatch` items for
    ``fit(steps_per_dispatch=K)`` — the fit loops use it automatically
    when K matches :attr:`megabatch_steps`.

    Worker processes use the ``spawn`` start method: this process
    typically holds a CUDA context, and forking a process with an
    initialized CUDA runtime is undefined behaviour.
    """

    def __init__(self, root: Optional[str] = None,
                 height: int = 224, width: int = 224, channels: int = 3,
                 batch_size: int = 32, workers: Optional[int] = None,
                 n_slots: Optional[int] = None, dtype: str = "uint8",
                 transform: Optional[ImageTransform] = None,
                 label_generator=None, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 12345,
                 files: Optional[Sequence[str]] = None,
                 steps_per_dispatch: int = 1, interleave: int = 1,
                 start_method: str = "spawn",
                 liveness_poll: float = 0.5):
        self.height, self.width, self.channels = height, width, channels
        self.batch_size = int(batch_size)
        self.workers = max(1, workers if workers is not None
                           else (os.cpu_count() or 1))
        self.megabatch_steps = max(1, int(steps_per_dispatch))
        k = self.megabatch_steps
        # enough outstanding sub-batch tasks to keep every worker busy
        # plus a double buffer, in units of megaslots
        self.n_slots = int(n_slots) if n_slots is not None \
            else max(2, -(-(2 * self.workers + 2) // k))
        self.np_dtype = np.dtype({"uint8": np.uint8,
                                  "float32": np.float32}[dtype])
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.interleave_shards = max(1, int(interleave))
        self.liveness_poll = float(liveness_poll)
        self._label_gen = label_generator or ParentPathLabelGenerator()
        self._files = list(files) if files is not None else _list_images(root)
        if not self._files:
            raise FileNotFoundError(f"no images under {root}")
        self.labels = sorted({self._label_gen.getLabelForPath(f)
                              for f in self._files})
        self._label_idx = np.asarray(
            [self.labels.index(self._label_gen.getLabelForPath(f))
             for f in self._files], np.int32)
        self._ctx = get_context(start_method)
        self._shm = None
        self._procs: List = []
        self._epoch = 0
        self._started = False
        # reset()/close() may race (a fit teardown against a lifecycle
        # hook): serialize them, and every _pending/_started update takes
        # the same (re-entrant) lock. next() stays consumer-thread-only.
        # Instrumented (PR-8 adoption sweep): held per megabatch pull, so
        # its hold histogram is the staged pipeline's consumer-side bill.
        self._lifecycle = InstrumentedRLock("staged_pipeline_lifecycle")
        self._loader = NativeImageLoader(height, width, channels)
        self._pending = 0
        self._failed = None     # latched DataPipelineError (decode failure)
        atexit.register(self.close)
        self.reset()

    # ------------------------------------------------------------ lifecycle
    def _start(self):
        with self._lifecycle:   # re-entrant: reset()/seek() hold it
            k = self.megabatch_steps
            slot_shape = (k, self.batch_size, self.channels, self.height,
                          self.width)
            ring_shape = (self.n_slots,) + slot_shape
            slot_bytes = int(np.prod(slot_shape)) * self.np_dtype.itemsize
            self._shm = _shm.SharedMemory(
                create=True, size=self.n_slots * slot_bytes,
                name=f"dl4jtpu_{uuid.uuid4().hex[:12]}")
            self._ring = np.ndarray(ring_shape, dtype=self.np_dtype,
                                    buffer=self._shm.buf)
            self._task_q = self._ctx.Queue()
            self._ready_q = self._ctx.Queue()
            tbytes = None
            if self.transform is not None:
                import pickle
                tbytes = pickle.dumps(self.transform)
            for _ in range(self.workers):
                p = self._ctx.Process(
                    target=_worker_main,
                    args=(self._shm.name, ring_shape, self.np_dtype.str,
                          self._files,
                          (self.height, self.width, self.channels),
                          self._task_q, self._ready_q, tbytes),
                    daemon=True)
                p.start()
                self._procs.append(p)
            self._started = True
            self._pending = 0

    def close(self):
        """Stop workers and release the shared-memory ring. Idempotent;
        safe against a concurrent ``reset()``."""
        with self._lifecycle:
            self._close_locked()

    def _close_locked(self):
        with self._lifecycle:           # re-entrant: close()/reset() hold it
            if not self._started:
                return
            self._started = False
            for _ in self._procs:
                try:
                    self._task_q.put(None)
                except (ValueError, OSError):
                    break               # queue already torn down
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
            self._procs = []
            try:
                self._shm.close()
                self._shm.unlink()
            except FileNotFoundError:
                pass
            self._shm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------- worker liveness
    def _dead_workers(self):
        return [(i, p) for i, p in enumerate(self._procs) if not p.is_alive()]

    def _get_ready_msg(self):
        """Bounded-timeout pull from the decode pool: every
        ``liveness_poll`` seconds of silence the worker processes are
        polled, and a dead one raises a structured
        :class:`DataPipelineError` naming it — ``next()`` must never
        block forever on a pool that can no longer produce."""
        t0 = time.perf_counter()
        try:
            while True:
                try:
                    msg = self._ready_q.get(timeout=self.liveness_poll)
                    break
                except queue.Empty:
                    dead = self._dead_workers()
                    if dead:
                        names = ", ".join(
                            f"worker {i} (pid={p.pid}, "
                            f"exitcode={p.exitcode})" for i, p in dead)
                        raise DataPipelineError(
                            f"decode worker died: {names}; "
                            f"{self._pending} sub-batch task(s) were in "
                            f"flight — reset() rebuilds the pool") from None
        finally:
            if _prof.instrumentation_active():
                _STALL_SECONDS.labels(stage="consume").inc(
                    time.perf_counter() - t0)
        if msg[0] == "error":
            _, mega_id, k, slot, err = msg
            with self._lifecycle:
                self._pending -= 1
                # latch: the errored sub-batch never completes, so a
                # retried next() would otherwise wait forever for its
                # megabatch — every later pull re-raises until reset()
                self._failed = DataPipelineError(
                    f"decode failed for sub-batch {k} of megabatch "
                    f"{mega_id}: {err}")
            raise self._failed
        return msg

    # ------------------------------------------------------------- epoching
    def reset(self):
        with self._lifecycle:
            if self._started and self._dead_workers():
                # a dead pool cannot drain: rebuild it wholesale
                self._close_locked()
            if self._started and self._pending:
                self._drain_locked()
            t0 = time.perf_counter()
            if self.shuffle:
                order = np.random.RandomState(
                    self.seed + self._epoch).permutation(len(self._files))
                self._epoch += 1
            else:
                order = np.arange(len(self._files))
            if _prof.instrumentation_active():
                # order build only — _setup_epoch may spawn the worker
                # pool, which must not bill the shuffle stage
                _STAGE_SECONDS.labels(stage="shuffle").observe(
                    time.perf_counter() - t0)
            self._setup_epoch(order, start_batch=0)

    def _drain_locked(self):
        """Mid-epoch drain: discard unstarted tasks, then absorb whatever
        the workers already have in flight (count-based, so a task a
        worker popped but hasn't finished is simply awaited)."""
        with self._lifecycle:           # re-entrant: reset()/seek() hold it
            try:
                while True:
                    self._task_q.get_nowait()
                    self._pending -= 1
            except queue.Empty:
                pass
            while self._pending > 0:
                if self._dead_workers():
                    # dead worker mid-drain: its in-flight task will never
                    # complete — rebuild the pool instead of hanging
                    self._close_locked()
                    return
                try:
                    self._ready_q.get(timeout=max(self.liveness_poll, 0.05))
                except queue.Empty:
                    continue
                self._pending -= 1

    def _setup_epoch(self, order: np.ndarray, start_batch: int):
        with self._lifecycle:   # re-entrant: reset()/seek() hold it
            self._failed = None     # fresh epoch clears the error latch
            if self.interleave_shards > 1:
                shards = np.array_split(order, self.interleave_shards)
                width = max(len(s) for s in shards)
                inter = []
                for j in range(width):
                    for s in shards:
                        if j < len(s):
                            inter.append(s[j])
                order = np.asarray(inter, dtype=order.dtype)
            self._order = order
            b, k = self.batch_size, self.megabatch_steps
            self._n_full = len(order) // b
            self._tail = [] if self.drop_last \
                else order[self._n_full * b:].tolist()
            self._total_batches = self._n_full + (1 if self._tail else 0)
            self._n_megas = -(-self._n_full // k) if self._n_full else 0
            if not self._started:
                self._start()
            self._free_slots = list(range(self.n_slots))
            self._completed = {}            # mega_id -> slot (reorder buffer)
            self._done_counts = {}          # mega_id -> sub-batches finished
            self._emitted = int(start_batch)
            if start_batch >= self._n_full:     # only the tail (if any) remains
                self._emit_next = self._n_megas
                self._start_j = 0
            else:
                self._emit_next = start_batch // k
                self._start_j = start_batch - self._emit_next * k
            # exact slot-resume: a mid-group seek() decodes ONLY the
            # sub-batches at or after the resume offset — the already-
            # consumed head of the group is never re-decoded (its slot
            # rows stay stale and are never emitted: _cur_j starts at
            # _start_j)
            self._skip_j = ({self._emit_next: self._start_j}
                            if self._start_j else {})
            self._task_counts = {}      # mega_id -> tasks actually queued
            self._next_assign = self._emit_next
            self._cur = None                # current copied megabatch
            self._cur_labels = None
            self._cur_j = 0
            self._cur_r = 0
            self._pump()

    def _mega_batches(self, mega_id: int) -> int:
        """Number of full batches in megabatch ``mega_id`` (the last
        group of an epoch may hold fewer than K)."""
        k = self.megabatch_steps
        return min(self._n_full - mega_id * k, k)

    def _pump(self):
        """Assign megabatches to free ring slots and enqueue their
        sub-batch decode tasks — the consumer-side feeder that bounds
        decode run-ahead to the ring depth."""
        b, k = self.batch_size, self.megabatch_steps
        with self._lifecycle:
            while self._free_slots and self._next_assign < self._n_megas:
                mega_id = self._next_assign
                slot = self._free_slots.pop()
                n_tasks = 0
                for j in range(self._skip_j.get(mega_id, 0),
                               self._mega_batches(mega_id)):
                    batch = mega_id * k + j
                    idxs = self._order[batch * b:(batch + 1) * b]
                    task_seed = (self.seed + 104729 * self._epoch + batch) \
                        % (2 ** 31)
                    self._task_q.put((mega_id, j, slot, idxs.tolist(),
                                      task_seed))
                    self._pending += 1
                    n_tasks += 1
                self._task_counts[mega_id] = n_tasks
                self._next_assign += 1
        if _prof.instrumentation_active():
            try:
                self._set_depth_gauges()
            except NotImplementedError:     # qsize on platforms without it
                pass

    def _set_depth_gauges(self):
        _QUEUE_DEPTH.labels(stage="ready").set(len(self._completed))
        _QUEUE_DEPTH.labels(stage="tasks").set(self._task_q.qsize())

    def _collect_until(self, mega_id: int) -> int:
        """Pull ready messages until ``mega_id`` is fully decoded; returns
        its slot. Out-of-order completions park in the reorder buffer.
        Holds the lifecycle lock (re-entrant; the consumer path owns it
        for the duration of a pull — a racing close()/reset() waits for
        the in-flight pull instead of tearing the ring down under it)."""
        active = _prof.instrumentation_active()
        with self._lifecycle:
            if self._failed is not None:
                raise self._failed      # see _get_ready_msg's error latch
            expected = self._task_counts.get(mega_id,
                                             self._mega_batches(mega_id))
            while mega_id not in self._completed \
                    or self._done_counts.get(mega_id, 0) < expected:
                _, mid, k, slot, decode_s, idle_s = self._get_ready_msg()
                self._pending -= 1
                self._completed[mid] = slot
                self._done_counts[mid] = self._done_counts.get(mid, 0) + 1
                if active:
                    _STAGE_SECONDS.labels(stage="decode").observe(decode_s)
                    if idle_s > 0:
                        _STALL_SECONDS.labels(stage="decode_idle").inc(idle_s)
            self._done_counts.pop(mega_id)
            self._task_counts.pop(mega_id, None)
            return self._completed.pop(mega_id)

    # -------------------------------------------------------------- consume
    def hasNext(self):
        return self._emitted < self._total_batches

    def _onehot(self, idx: np.ndarray) -> np.ndarray:
        return np.eye(len(self.labels), dtype=np.float32)[
            np.asarray(idx, np.int64)]

    def _load_group(self):
        """Copy the next in-order megabatch out of the ring into a
        contiguous host buffer (ONE memcpy; the slot is immediately
        reusable) and refill the decode pool."""
        with self._lifecycle:
            mega_id = self._emit_next
            r = self._mega_batches(mega_id)
            slot = self._collect_until(mega_id)
            t0 = time.perf_counter()
            self._cur = np.array(self._ring[slot][:r], copy=True)
            if _prof.instrumentation_active():
                _STAGE_SECONDS.labels(stage="stage").observe(
                    time.perf_counter() - t0)
            b, k = self.batch_size, self.megabatch_steps
            lab = self._label_idx[
                self._order[mega_id * k * b:(mega_id * k + r) * b]]
            self._cur_labels = self._onehot(lab).reshape(
                r, b, len(self.labels))
            self._cur_j = self._start_j
            self._start_j = 0
            self._cur_r = r
            self._emit_next += 1
            self._free_slots.append(slot)
            self._pump()

    def _next_tail(self) -> DataSet:
        """Host-decoded partial final batch (``drop_last=False``)."""
        with self._lifecycle:
            t0 = time.perf_counter()
            idxs = self._tail
            feats = np.empty((len(idxs), self.channels, self.height,
                              self.width), self.np_dtype)
            rng = np.random.RandomState(self.seed - 1)
            for row, i in enumerate(idxs):
                img = _decode_one(self._files[i], self.height, self.width,
                                  self.channels)
                if self.transform is not None:
                    img = np.clip(self.transform.transform(
                        img.astype(np.float32), rng), 0, 255)
                feats[row] = img
            self._emitted += 1
            if _prof.instrumentation_active():
                _STAGE_SECONDS.labels(stage="tail").observe(
                    time.perf_counter() - t0)
                _H2D_BYTES.inc(feats.nbytes)
            y = self._onehot(self._label_idx[np.asarray(idxs, np.int64)]) \
                if idxs else np.zeros((0, len(self.labels)), np.float32)
            return self._apply_pre(DataSet(feats, y))

    def next(self) -> DataSet:
        with self._lifecycle:
            if self._emitted >= self._n_full:
                if not self._tail or self._emitted >= self._total_batches:
                    raise StopIteration
                return self._next_tail()
            if self._cur is None or self._cur_j >= self._cur_r:
                self._load_group()
            j = self._cur_j
            self._cur_j += 1
            self._emitted += 1
            feats, y = self._cur[j], self._cur_labels[j]
            if _prof.instrumentation_active():
                _H2D_BYTES.inc(feats.nbytes)
            if self._cur_j >= self._cur_r:
                self._cur = None        # buffer handed out; drop our ref
            return self._apply_pre(DataSet(feats, y))

    def _next_mega(self):
        """One full-K MegaBatch if the position allows it, else None
        (the caller falls back to a per-batch ``next()``)."""
        from deeplearning4j_tpu_torch.train.stepping import MegaBatch
        k = self.megabatch_steps
        with self._lifecycle:
            if not (k > 1 and self._cur is None
                    and self._emitted < self._n_full
                    and self._emit_next < self._n_megas
                    and self._mega_batches(self._emit_next) == k
                    and self._start_j == 0
                    # a seek-resumed group decoded only its tail: rows
                    # below the skip offset are stale — per-batch path
                    and self._skip_j.get(self._emit_next, 0) == 0):
                return None
            self._load_group()
            # the preconditions above guarantee a full, unoffset group
            assert self._cur_r == k and self._cur_j == 0
            mb = MegaBatch()
            mb.multi = False
            mb.steps = k
            mb.features = self._cur
            mb.labels = self._cur_labels
            mb.features_mask = None
            mb.labels_mask = None
            self._cur = None
            self._cur_labels = None
            self._emitted += k
            if _prof.instrumentation_active():
                _H2D_BYTES.inc(mb.features.nbytes)
            return mb

    def dispatch_stream(self):
        """Yield the epoch as dispatch-ready items: one
        :class:`~deeplearning4j_tpu_torch.train.stepping.MegaBatch` per full
        K-group (features = the contiguous ``[K, B, C, H, W]`` staging
        buffer — no re-stack) and plain DataSets for the partial final
        group / host-decoded tail. The fit loops consume this stream
        when ``steps_per_dispatch`` matches :attr:`megabatch_steps`
        (preprocessors force the per-batch path — set them on the
        device-augment or host-transform seams instead). The lifecycle
        lock is never held across a yield."""
        while self.hasNext():
            mb = self._next_mega()
            yield mb if mb is not None else self.next()

    # ------------------------------------------------- cursor/seek protocol
    def cursor(self):
        """Exact position: batches emitted this epoch + the epoch counter
        (enough to rebuild the seeded shuffle order, exactly like
        ``ListDataSetIterator``) — megabatch emission is in-order, so the
        count is exact even under multi-process decode."""
        return {"batch": int(self._emitted), "epoch": int(self._epoch)}

    def seek(self, cursor) -> None:
        """Restore a :meth:`cursor` position: drain in-flight decode,
        rebuild the epoch order for the stored epoch (``reset()`` drew it
        from ``seed + epoch`` THEN incremented, so epoch e's order came
        from ``seed + e - 1``), and resume task assignment mid-epoch.
        A mid-group position is an EXACT slot resume: only the group's
        remaining sub-batches (j >= the resume offset) are decoded —
        the already-consumed head is never re-decoded."""
        epoch = int(cursor["epoch"])
        with self._lifecycle:
            if self._started and self._dead_workers():
                self._close_locked()
            if self._started and self._pending:
                self._drain_locked()
            if self.shuffle:
                order = np.random.RandomState(
                    self.seed + max(epoch - 1, 0)).permutation(
                    len(self._files))
            else:
                order = np.arange(len(self._files))
            self._epoch = epoch
            self._setup_epoch(order, start_batch=int(cursor["batch"]))

    # ------------------------------------------------------------- metadata
    def batch(self):
        return self.batch_size

    def totalOutcomes(self):
        return len(self.labels)

    def inputColumns(self):
        return self.channels * self.height * self.width


class MultiWorkerImageIterator(StagedImageIterator):
    """Directory-of-class-directories preset over the staged pipeline
    (ref: ImageRecordReader + RecordReaderDataSetIterator +
    AsyncDataSetIterator, collapsed into one seam): ``list -> [shuffle] -> decode(workers) -> batch ->
    stage(steps_per_dispatch) -> prefetch(n_slots)`` with the historical
    constructor signature. Equivalent to building the same stages by
    hand with :class:`ImagePipeline`."""

    def __init__(self, root: str, height: int, width: int, channels: int = 3,
                 batch_size: int = 32, workers: Optional[int] = None,
                 n_slots: Optional[int] = None, dtype: str = "uint8",
                 transform: Optional[ImageTransform] = None,
                 label_generator=None, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 12345,
                 files: Optional[Sequence[str]] = None,
                 start_method: str = "spawn", steps_per_dispatch: int = 1,
                 interleave: int = 1, liveness_poll: float = 0.5):
        super().__init__(
            root=root, height=height, width=width, channels=channels,
            batch_size=batch_size, workers=workers, n_slots=n_slots,
            dtype=dtype, transform=transform,
            label_generator=label_generator, shuffle=shuffle,
            drop_last=drop_last, seed=seed, files=files,
            steps_per_dispatch=steps_per_dispatch, interleave=interleave,
            start_method=start_method, liveness_poll=liveness_poll)
