"""DataSet containers, the iterator contract and the input pipeline's
host side (the port of ``deeplearning4j_tpu/data/dataset.py``):

- ``DataSet`` with ``splitTestAndTrain``, ``shuffle``, ``batchBy`` and
  ``merge``; ``SplitTestAndTrain``; ``MultiDataSet`` (several feature and
  label arrays, the ``ComputationGraph`` container);
- ``DataSetIterator`` (reset/hasNext/next, the cursor/seek protocol,
  ``setPreProcessor``), ``ListDataSetIterator``, ``IterableDataSetIterator``
  (any iterable of DataSets), ``RetryingDataSetIterator`` (bounded retry
  with backoff of errors marked transient, :class:`TransientDataError`)
  and ``AsyncDataSetIterator`` (a background thread pulls ahead);
- ``DevicePrefetcher``: a worker thread groups the batch stream into
  K-step megabatches and stages each on the device while the previous
  dispatch runs (:func:`stage_item`, :class:`Stager`);
- the normalizers ``NormalizerStandardize``, ``NormalizerMinMaxScaler``
  and ``ImagePreProcessingScaler`` (``ModelSerializer.writeNormalizer`` /
  ``restoreNormalizer`` store them in the JAX package's file).

Host arrays stay numpy until a step (or the prefetcher) moves a batch to
the device; tensors (on any device) are kept as they are.

Staging on the card. ``jax.device_put`` is asynchronous for free; a CUDA
copy is not. The prefetcher's worker copies each host array into a
page-locked buffer and issues a ``non_blocking`` copy to the device on a
stream of its own, then records an event; the consumer makes its own
(compute) stream wait on that event before it hands the batch to a
dispatch, and marks every staged tensor as used on the compute stream
(``Tensor.record_stream``), so the allocator reuses none of them while a
dispatch may still read it. A page-locked buffer is refilled only after
its last copy has completed (its event). On the CPU staging is a plain
``torch.from_numpy``/``.to``: nothing is pinned. ``H2D_COPIES`` counts
every host-to-device copy a fit makes, by shape and dtype.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.utils.concurrent import ErrorLatch as _ErrorLatch

# Registered at import so GET /metrics always exposes the input
# pipeline's series (zero until a prefetching iterator runs).
_REG = _prof.get_registry()
_ASYNC_QUEUE_DEPTH = _REG.gauge(
    "dl4j_async_iterator_queue_depth",
    "Batches currently buffered by AsyncDataSetIterator (0 under load "
    "means the consumer is data-starved)")
_PREFETCH_QUEUE_DEPTH = _REG.gauge(
    "dl4j_prefetch_queue_depth",
    "Staged megabatches currently buffered by DevicePrefetcher")
_PREFETCH_H2D_BYTES = _REG.counter(
    "dl4j_prefetch_h2d_bytes_total",
    "Host bytes staged onto the device by DevicePrefetcher while prior "
    "dispatches compute (H2D/compute overlap)")
_DATA_RETRIES = _REG.counter(
    "dl4j_data_retries_total",
    "Transient data-pipeline errors retried (RetryingDataSetIterator / "
    "AsyncDataSetIterator bounded backoff)")

#: host-to-device copies made for training and evaluation batches, by
#: ``(shape, dtype name)`` (the staged ones and a step's own); read after
#: a fit, zeroed by :func:`reset_h2d_counts`
H2D_COPIES: Dict[Tuple[tuple, str], int] = {}
_H2D_LOCK = threading.Lock()


def reset_h2d_counts() -> None:
    with _H2D_LOCK:
        H2D_COPIES.clear()


def _count_h2d(a) -> None:
    key = (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    with _H2D_LOCK:
        H2D_COPIES[key] = H2D_COPIES.get(key, 0) + 1


def to_device(a, device) -> torch.Tensor:
    """``a`` (numpy or a tensor) as a tensor on ``device``: a synchronous
    copy, counted in ``H2D_COPIES`` when it goes from the host to the
    card; a tensor already there is returned as it is."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    device = torch.device(device)
    if device.type == "cuda" and a.device.type == "cpu":
        _count_h2d(a)
    return a.to(device)


class TransientDataError(IOError):
    """A data-pipeline error the source declares retryable (a flaky
    network filesystem, an object store's 5xx, a preempted reader): the
    bounded retry paths (``RetryingDataSetIterator``,
    ``AsyncDataSetIterator``) pull again instead of failing the fit. Any
    other exception type opts in with a truthy ``transient``
    attribute."""

    transient = True


def is_transient_error(e: BaseException) -> bool:
    """True when the error is marked retryable (see TransientDataError)."""
    return bool(getattr(e, "transient", False))


def _retry_pull(pull, max_retries: int, backoff: float, sleep):
    """The bounded transient-retry loop both retrying paths share:
    exponential backoff, ``dl4j_data_retries_total`` per retry, other
    errors raised at once. ``sleep(seconds)`` returns True to stop
    retrying (the async worker passes its stop event's ``wait``)."""
    attempt = 0
    while True:
        try:
            return pull()
        except BaseException as e:
            if attempt >= max_retries or not is_transient_error(e):
                raise
            attempt += 1
            _DATA_RETRIES.inc()
            if sleep(backoff * (2 ** (attempt - 1))):
                raise


def _as_batch_array(a):
    """numpy for host data, untouched for tensors (on any device)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return np.asarray(a)


class DataSet:
    """Features + labels (+ masks) batch container (ref: DataSet)."""

    _FIELDS = ("features", "labels", "features_mask", "labels_mask")

    def __init__(self, features=None, labels=None,
                 features_mask=None, labels_mask=None):
        self.features = _as_batch_array(features)
        self.labels = _as_batch_array(labels)
        self.features_mask = _as_batch_array(features_mask)
        self.labels_mask = _as_batch_array(labels_mask)

    def getFeatures(self):
        return self.features

    def getLabels(self):
        return self.labels

    def numExamples(self) -> int:
        return 0 if self.features is None else self.features.shape[0]

    def _rows(self, idx) -> "DataSet":
        return DataSet(*(None if a is None else a[idx]
                         for a in (getattr(self, f) for f in self._FIELDS)))

    def splitTestAndTrain(self, fraction_or_n) -> "SplitTestAndTrain":
        """The first ``n`` examples (a fraction of them for a float) to
        train, the rest to test."""
        n = self.numExamples()
        n_train = int(fraction_or_n * n) if isinstance(fraction_or_n, float) \
            else int(fraction_or_n)
        return SplitTestAndTrain(self._rows(slice(0, n_train)),
                                 self._rows(slice(n_train, n)))

    def shuffle(self, seed: int = None):
        """Permute the examples in place, ``np.random.RandomState(seed)``'s
        permutation."""
        perm = np.random.RandomState(seed).permutation(self.numExamples())
        for attr in self._FIELDS:
            a = getattr(self, attr)
            if a is not None:
                setattr(self, attr, a[perm])

    def batchBy(self, batch_size: int) -> List["DataSet"]:
        return [self._rows(slice(i, i + batch_size))
                for i in range(0, self.numExamples(), batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(attr):
            arrs = [getattr(d, attr) for d in datasets]
            if any(a is None for a in arrs):
                return None
            if any(isinstance(a, torch.Tensor) for a in arrs):
                return torch.cat([torch.as_tensor(a) for a in arrs])
            return np.concatenate(arrs, axis=0)
        return DataSet(*(cat(f) for f in DataSet._FIELDS))


class SplitTestAndTrain:
    def __init__(self, train: DataSet, test: DataSet):
        self.train = train
        self.test = test

    def getTrain(self):
        return self.train

    def getTest(self):
        return self.test


class MultiDataSet:
    """Several feature and label arrays (ref: MultiDataSet) — the
    ``ComputationGraph`` batch container; a single array is taken as a
    list of one."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Sequence = None,
                 labels_masks: Sequence = None):
        def as_list(x):
            return [_as_batch_array(a) for a in x] if x is not None else None
        self.features = as_list(features if isinstance(features, (list, tuple))
                                else [features])
        self.labels = as_list(labels if isinstance(labels, (list, tuple))
                              else [labels])
        self.features_masks = as_list(features_masks)
        self.labels_masks = as_list(labels_masks)

    def numExamples(self):
        return self.features[0].shape[0]


class DataSetIterator:
    """Iterator contract (ref: DataSetIterator): python-iterable over
    DataSet minibatches, restartable via reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        return self.next()

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def cursor(self):
        """A JSON-able position token for checkpoint/resume, or None when
        the source cannot seek."""
        return None

    def seek(self, cursor) -> None:
        """Restore a position :meth:`cursor` returned."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support seek()")

    def setPreProcessor(self, pre):
        """``pre.transform(ds)`` runs on every batch :meth:`next`
        returns."""
        self._pre = pre

    def _apply_pre(self, ds: DataSet) -> DataSet:
        pre = getattr(self, "_pre", None)
        if pre is not None:
            pre.transform(ds)
        return ds


class ListDataSetIterator(DataSetIterator):
    """Iterate an in-memory DataSet in minibatches (ref:
    ListDataSetIterator); with ``shuffle`` each ``reset`` draws the order
    from ``np.random.RandomState(seed + epoch)``, as the JAX package
    does."""

    def __init__(self, data: DataSet, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 12345):
        self.data = data
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self.reset()

    def _order_for(self, epoch: int):
        if self._shuffle:
            return np.random.RandomState(self._seed + epoch).permutation(
                self.data.numExamples())
        return np.arange(self.data.numExamples())

    def reset(self):
        self._order = self._order_for(self._epoch)
        if self._shuffle:
            self._epoch += 1
        self._pos = 0

    def hasNext(self):
        return self._pos < self.data.numExamples()

    def next(self):
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return self._apply_pre(self.data._rows(idx))

    def batch(self):
        return self.batch_size

    def cursor(self):
        """Position and epoch: enough to rebuild the seeded order."""
        return {"pos": int(self._pos), "epoch": int(self._epoch)}

    def seek(self, cursor) -> None:
        epoch = int(cursor["epoch"])
        # reset() drew the order for stored epoch e from seed + e - 1
        self._order = self._order_for(max(epoch - 1, 0))
        self._epoch = epoch
        self._pos = int(cursor["pos"])

    def totalOutcomes(self):
        return self.data.labels.shape[1] if self.data.labels is not None \
            else 0

    def inputColumns(self):
        return int(np.prod(self.data.features.shape[1:]))


def _offer_until_stopped(q, item, stop) -> bool:
    """Blocking queue put that gives up when ``stop`` is set: the one
    worker-to-consumer handoff of AsyncDataSetIterator and DevicePrefetcher
    (items, failures and END sentinels alike)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class _PrefetchFailure:
    """A worker thread's exception, raised again on the consumer's side."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch wrapper (ref: AsyncDataSetIterator): a thread
    pulls up to ``prefetch`` batches ahead of the consumer.

    ``max_retries`` retries the worker's pulls, with exponential backoff,
    on errors marked transient (:class:`TransientDataError`), counted in
    ``dl4j_data_retries_total``. A worker error reaches the consumer at
    the batch where it happened; one the consumer never pulled is raised
    by ``close()``. ``close()`` twice is a no-op; the iterator is also a
    context manager."""

    _END = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 2,
                 max_retries: int = 0, retry_backoff: float = 0.05):
        self.base = base
        self.prefetch = prefetch
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self._queue = None
        self._thread = None
        self._next_item = None
        self._stop = None
        self._pending = _ErrorLatch()
        self.reset()

    def _pull_with_retry(self, stop):
        # stop.wait as the sleep: a shutdown mid-backoff ends the retry
        return _retry_pull(self.base.next, self.max_retries,
                           self.retry_backoff, stop.wait)

    def _worker(self, q, stop):
        try:
            while not stop.is_set() and self.base.hasNext():
                if not _offer_until_stopped(q, self._pull_with_retry(stop),
                                            stop):
                    return
        except BaseException as e:
            # surface on the consumer's thread (a dead worker must not
            # look like the end of the stream), and latch it for close()
            self._pending.record(e)
            _offer_until_stopped(q, _PrefetchFailure(e), stop)
        finally:
            _offer_until_stopped(q, self._END, stop)

    def _shutdown_worker(self):
        # stop and drain the worker before touching self.base, or two
        # threads race on the underlying iterator
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            while self._thread.is_alive():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
        self._thread = None

    def reset(self):
        self._shutdown_worker()
        self._pending.clear()
        self.base.reset()
        self._restart_worker()

    def _restart_worker(self):
        self._stop = threading.Event()
        self._queue = _prof.InstrumentedQueue(maxsize=self.prefetch,
                                              name="async_iterator_queue")
        self._thread = threading.Thread(target=self._worker,
                                        args=(self._queue, self._stop),
                                        daemon=True)
        self._thread.start()
        self._next_item = self._queue.get()

    def close(self):
        """Stop the thread and drop the buffered batches; the iterator
        reads as exhausted afterwards (``reset()`` restarts it). Raises the
        first worker error the consumer never saw."""
        self._shutdown_worker()
        self._next_item = self._END
        err = self._pending.take()
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # already unwinding: shut down without masking the original
            try:
                self.close()
            except BaseException:
                pass
            return False
        self.close()
        return False

    def hasNext(self):
        return self._next_item is not self._END

    def next(self):
        item = self._next_item
        if isinstance(item, _PrefetchFailure):
            self._next_item = self._END
            self._pending.delivered(item.error)   # raised here, not close()
            raise item.error
        self._next_item = self._queue.get()
        if _prof.instrumentation_active():
            _ASYNC_QUEUE_DEPTH.set(self._queue.qsize())
        return item

    def batch(self):
        return self.base.batch()

    def cursor(self):
        """The base's cursor: the worker runs ahead, so this can overstate
        the consumed position by up to ``prefetch + 1`` batches."""
        return self.base.cursor()

    def seek(self, cursor) -> None:
        self._shutdown_worker()
        self._pending.clear()
        self.base.seek(cursor)
        self._restart_worker()


class RetryingDataSetIterator(DataSetIterator):
    """Bounded retry with exponential backoff around a flaky source:
    ``next()`` pulls again on errors marked transient up to
    ``max_retries`` times (``dl4j_data_retries_total``); other errors
    propagate at once."""

    def __init__(self, base: DataSetIterator, max_retries: int = 3,
                 backoff: float = 0.05):
        self.base = base
        self.max_retries = max_retries
        self.backoff = backoff

    def hasNext(self):
        return self.base.hasNext()

    def next(self):
        return _retry_pull(self.base.next, self.max_retries, self.backoff,
                           time.sleep)

    def reset(self):
        self.base.reset()

    def batch(self):
        return self.base.batch()

    def cursor(self):
        return self.base.cursor()

    def seek(self, cursor) -> None:
        self.base.seek(cursor)


class IterableDataSetIterator(DataSetIterator):
    """Any iterable of DataSets as a DataSetIterator. ``reset()`` iterates
    the source again: exact for lists and tuples; a one-shot generator
    gives one pass."""

    _DONE = object()

    def __init__(self, iterable: Iterable):
        self._iterable = iterable
        # a one-shot iterator IS its own iter(): iterating it again on
        # reset() would drop the element buffered for hasNext()
        self._one_shot = iter(iterable) is iterable
        self._it = iter(iterable)
        self._nxt = next(self._it, self._DONE)

    def reset(self):
        if self._one_shot:
            return          # one pass: keep the position and buffered item
        self._it = iter(self._iterable)
        self._nxt = next(self._it, self._DONE)

    def hasNext(self):
        return self._nxt is not self._DONE

    def next(self):
        if self._nxt is self._DONE:
            raise StopIteration
        item = self._nxt
        self._nxt = next(self._it, self._DONE)
        return self._apply_pre(item)

    def batch(self):
        return -1


# ---------------------------------------------------------------- staging
def _map_arrays(item, fn):
    """``item`` (a DataSet, MultiDataSet or MegaBatch) with ``fn(array,
    mega)`` applied to each of its arrays (None stays None); a MegaBatch
    is updated in place, the others copied. Anything else comes back as
    it is."""
    from deeplearning4j_tpu_torch.train.stepping import MegaBatch

    def lput(xs, mega):
        return [fn(a, mega) for a in xs] if xs is not None else None
    if isinstance(item, MegaBatch):
        put = (lambda xs: lput(xs, True)) if item.multi \
            else (lambda a: fn(a, True))
        item.features = put(item.features)
        item.labels = put(item.labels)
        item.features_mask = put(item.features_mask)
        item.labels_mask = put(item.labels_mask)
        return item
    if isinstance(item, MultiDataSet):
        out = MultiDataSet.__new__(MultiDataSet)
        out.features = lput(item.features, False)
        out.labels = lput(item.labels, False)
        out.features_masks = lput(item.features_masks, False)
        out.labels_masks = lput(item.labels_masks, False)
        return out
    if isinstance(item, DataSet):
        return DataSet(*(fn(getattr(item, f), False)
                         for f in DataSet._FIELDS))
    return item


def _cuda_arrays(item) -> List[torch.Tensor]:
    """The CUDA tensors of a DataSet or MultiDataSet."""
    out: List[torch.Tensor] = []

    def note(a, _mega):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            out.append(a)
        return a
    _map_arrays(item, note)
    return out


def stage_item(item, device):
    """Put one DataSet/MultiDataSet/MegaBatch's arrays on ``device``
    synchronously, on the calling thread (the ``prefetch <= 0`` path):
    :func:`to_device` for each array."""
    return _map_arrays(item, lambda a, _mega: None if a is None
                       else to_device(a, device))


class _Staged:
    """A staged item on the card: its arrays were written on the staging
    stream, and ``event`` marks the end of that work."""

    __slots__ = ("item", "event", "tensors")

    def __init__(self, item, event, tensors):
        self.item, self.event, self.tensors = item, event, tensors


class Stager:
    """How the prefetcher's worker puts batches on ``device``.

    On the card every host array goes through a page-locked buffer (a
    ring of ``depth`` buffers a shape and dtype; one is refilled only
    after its last copy has completed) and a ``non_blocking`` copy on the
    stager's own stream; tensors already on the card are used as they
    are (stacked on that stream, after it waits for the compute stream
    that produced them). :meth:`stage` returns the item with the event
    that ends its staging; :meth:`ready`, on the consumer's thread, makes
    the consumer's current stream wait on it and marks the staged tensors
    as used there. On the CPU both are plain conversions."""

    def __init__(self, device, depth: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.depth = max(1, int(depth))
        self._pinned: Dict[tuple, List] = {}
        self._stream = None
        # the stream the consumer computes on (where device-resident
        # inputs were produced)
        self._compute = torch.cuda.current_stream(self.device) \
            if self.cuda else None

    @contextlib.contextmanager
    def staging(self):
        """The worker's context: its CUDA work goes to the stager's
        stream."""
        if not self.cuda:
            yield
            return
        self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            yield

    def ordered(self, batches):
        """``batches``, the staging stream made to wait for the compute
        stream before any batch that holds CUDA tensors (the megabatch
        stack reads them there), each such tensor marked as used on the
        staging stream."""
        for ds in batches:
            if self.cuda:
                cuda = _cuda_arrays(ds)
                if cuda:
                    self._stream.wait_stream(self._compute)
                    for a in cuda:
                        a.record_stream(self._stream)
            yield ds

    def _pinned_buffer(self, shape, dtype) -> torch.Tensor:
        ring = self._pinned.setdefault((shape, dtype), [])
        if len(ring) < self.depth:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        buf, done = ring.pop(0)
        done.synchronize()          # its last copy to the card has ended
        return buf

    def _put(self, a):
        if a is None:
            return None
        if not self.cuda:
            return to_device(a, self.device)
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.to(self.device)
        host = a if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(a))
        buf = self._pinned_buffer(tuple(host.shape), host.dtype)
        buf.copy_(host)
        out = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
        out.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)
        self._pinned[(tuple(buf.shape), buf.dtype)].append((buf, done))
        _count_h2d(host)
        if _prof.instrumentation_active():
            _PREFETCH_H2D_BYTES.inc(host.numel() * host.element_size())
        return out

    def stage(self, item):
        """``item`` with its arrays on the device (worker thread, inside
        :meth:`staging`)."""
        tensors: List[torch.Tensor] = []

        def put(a, _mega):
            t = self._put(a)
            if isinstance(t, torch.Tensor):
                tensors.append(t)
            return t
        out = _map_arrays(item, put)
        if not self.cuda:
            return out
        event = torch.cuda.Event()
        event.record(self._stream)
        return _Staged(out, event, tensors)

    def ready(self, staged):
        """The staged item, safe to read on the consumer's current stream
        (consumer thread)."""
        if not isinstance(staged, _Staged):
            return staged
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(stream)
        return staged.item


class DevicePrefetcher:
    """A worker thread that stages the NEXT (mega)batch on the device while
    the current one computes (ref: the JAX package's ``DevicePrefetcher``
    over ``jax.device_put``).

    The worker groups the stream into ``steps_per_dispatch``-sized
    :class:`~deeplearning4j_tpu_torch.train.stepping.MegaBatch` items
    (megabatches a staged pipeline already stacked pass through) and
    stages each through a :class:`Stager` on ``device`` (the card unless
    the caller names another; without a card and without ``device`` it
    raises, as every entry point does); the queue holds
    at most ``prefetch`` staged items (2: the one in flight and the next,
    a double buffer). ``max_retries`` retries a DataSetIterator source's
    transient errors. A worker error reaches the consumer where it
    happened; ``close()`` raises one the consumer never pulled. Iterable;
    a context manager."""

    _END = object()

    def __init__(self, batches: Iterable, steps_per_dispatch: int = 1,
                 prefetch: int = 2, device=None, max_retries: int = 0,
                 retry_backoff: float = 0.05):
        from deeplearning4j_tpu_torch.train.stepping import (
            group_into_megabatches)
        from deeplearning4j_tpu_torch.device import resolve_device
        self._stager = Stager(resolve_device(device),
                              depth=max(2, prefetch))
        self._queue = _prof.InstrumentedQueue(maxsize=max(1, prefetch),
                                              name="prefetch_queue")
        self._stop = threading.Event()
        if max_retries and isinstance(batches, DataSetIterator):
            # a DataSetIterator can serve a failed pull again; a generator
            # dies on its raise
            batches = RetryingDataSetIterator(batches, max_retries,
                                              retry_backoff)
        self._src = group_into_megabatches(self._stager.ordered(batches),
                                           steps_per_dispatch)
        self._done = False
        self._pending = _ErrorLatch()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="dl4j-device-prefetch")
        self._thread.start()

    def _offer(self, item) -> bool:
        if not _offer_until_stopped(self._queue, item, self._stop):
            return False
        if _prof.instrumentation_active():
            _PREFETCH_QUEUE_DEPTH.set(self._queue.qsize())
        return True

    def _worker(self):
        try:
            with self._stager.staging():
                for item in self._src:
                    if self._stop.is_set():
                        return
                    if not self._offer(self._stager.stage(item)):
                        return
        except BaseException as e:      # surface in the consumer
            self._pending.record(e)     # first, so a racing close() sees it
            self._offer(_PrefetchFailure(e))
        finally:
            self._offer(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if _prof.instrumentation_active():
            _PREFETCH_QUEUE_DEPTH.set(self._queue.qsize())
        if item is self._END:
            self._done = True
            raise StopIteration
        if isinstance(item, _PrefetchFailure):
            self._done = True
            self._pending.delivered(item.error)
            raise item.error
        return self._stager.ready(item)

    def close(self):
        """Stop the worker and drop the staged items. A second call does
        nothing; raises the first worker error the consumer never
        pulled."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        self._thread = None
        self._done = True
        _PREFETCH_QUEUE_DEPTH.set(0)
        err = self._pending.take()
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            try:
                self.close()
            except BaseException:
                pass                # don't mask the exception in flight
            return False
        self.close()
        return False


# ------------------------------------------------------------------ normalizers
def _channel_shape(stat, feats):
    """A per-channel statistic broadcast over axis 1 of 3-D and 4-D
    features."""
    if feats.ndim > 2:
        shape = [1] * feats.ndim
        shape[1] = -1
        return stat.reshape(shape)
    return stat


def _features(data):
    return data.features if isinstance(data, DataSet) else data


def _set_features(data, out):
    if isinstance(data, DataSet):
        data.features = out
        return data
    return out


class NormalizerStandardize:
    """Zero mean, unit variance (ref: NormalizerStandardize): ``fit`` takes
    the mean and standard deviation of every feature column (of every
    channel, axis 1, of 3-D and 4-D features), a deviation below 1e-8
    counting as 1; ``transform`` and ``revert`` work on a DataSet (in
    place) or a numpy array."""

    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, data):
        feats = np.asarray(_features(data))
        axes = tuple(i for i in range(feats.ndim) if i != 1) \
            if feats.ndim > 2 else (0,)
        self.mean = feats.mean(axis=axes)
        std = feats.std(axis=axes)
        self.std = np.where(std < 1e-8, 1.0, std)

    def transform(self, data):
        feats = _features(data)
        return _set_features(data, (feats - _channel_shape(self.mean, feats))
                             / _channel_shape(self.std, feats))

    def revert(self, data):
        """The inverse of :meth:`transform`, per channel of 3-D and 4-D
        features too."""
        feats = _features(data)
        return _set_features(data, feats * _channel_shape(self.std, feats)
                             + _channel_shape(self.mean, feats))

    def state(self):
        return {"mean": self.mean, "std": self.std}

    def load_state(self, d):
        self.mean, self.std = d["mean"], d["std"]


class NormalizerMinMaxScaler:
    """Scale into ``[min_range, max_range]`` (ref: NormalizerMinMaxScaler)
    by the minimum and maximum over all of the fitted features, as the
    JAX package does."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range, self.max_range = min_range, max_range
        self.data_min = None
        self.data_max = None

    def fit(self, data):
        feats = np.asarray(_features(data))
        self.data_min = feats.min()
        self.data_max = feats.max()

    def transform(self, data):
        feats = _features(data)
        denom = max(self.data_max - self.data_min, 1e-8)
        out = (feats - self.data_min) / denom \
            * (self.max_range - self.min_range) + self.min_range
        return _set_features(data, out)


class ImagePreProcessingScaler:
    """Pixels in [0, 255] to [a, b] (ref: ImagePreProcessingScaler)."""

    def __init__(self, a: float = 0.0, b: float = 1.0):
        self.a, self.b = a, b

    def fit(self, data):
        pass

    def transform(self, data):
        feats = _features(data)
        return _set_features(data, feats / 255.0 * (self.b - self.a)
                             + self.a)
