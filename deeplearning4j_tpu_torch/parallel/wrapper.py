"""Data-parallel training and batched inference over ranks — the port
of ``ParallelWrapper`` and ``ParallelInference`` in
``deeplearning4j_tpu/parallel/wrapper.py``.

``ParallelWrapper`` (ref: DL4J's single-node data parallelism) trains a
network synchronously over the mesh's data axis: every rank is handed
the same global batches, keeps its rows, and the step sums the
gradients over the data group before they are normalized, so each rank
applies the same update to the same replicated params (no averaging
interval, no gradient encoding). It runs the network's own ``fit`` with
a replicated :class:`~deeplearning4j_tpu_torch.distributed.gspmd.
ShardedTrainingPlan` attached: the wrapper and the GSPMD trainer with
such a plan run one step, with one reduction order.

On a mesh with a ``model`` axis each rank of a model line runs the same
rows on the same replicated params; the gradients sum over the data
axis only.

A network under truncated BPTT trains through its windows, as DL4J's
ParallelWrapper and both packages' GSPMD trainer do; the JAX wrapper
instead steps a 3-D batch whole at one step a dispatch
(``_fit_one``). The elastic fit refuses such a network.

``ParallelInference`` (ref: DL4J's ParallelInference, BATCHED mode)
queues requests, coalesces them up to ``batch_limit`` rows, pads the
batch to its bucket and runs one forward over the mesh through the
leader/follower dispatch of ``parallel.leader`` (the mesh's first rank
serves, the others :meth:`ParallelInference.follow`), with bounded
admission, retry on the survivors after a shrink, the
``DispatchWatchdog`` timeout and ``close()``/``shutdown()``.
"""

from __future__ import annotations

import itertools
import queue
import threading
import warnings

import numpy as np

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh


class ParallelWrapper:
    """Sync data-parallel trainer over the mesh (ref: ParallelWrapper)."""

    def __init__(self, model, mesh: DeviceMesh = None,
                 prefetch_buffer: int = 2, workers: int = None):
        self.model = model
        self.mesh = mesh or DeviceMesh.data_parallel()
        self.prefetch = prefetch_buffer

    def _plan(self):
        from deeplearning4j_tpu_torch.distributed.gspmd import \
            ShardedTrainingPlan
        plan = getattr(self.model, "_sharding_plan", None)
        if plan is None or plan.signature() != \
                ShardedTrainingPlan(self.mesh).signature():
            plan = ShardedTrainingPlan(self.mesh)
        return plan

    def _attach(self):
        model = self.model
        if not model._initialized:
            model.init(device=self.mesh.device)
        plan = self._plan()
        model.setShardingPlan(plan)
        plan.apply(model)
        return plan

    def validate(self, batch_size: int = None, **kw):
        """Static lint of the wrapped model against THIS wrapper's mesh:
        the configuration analysis plus the E1xx/W10x distribution lints.
        Extra keywords forward to ``analysis.analyze``."""
        return self.model.validate(batch_size=batch_size,
                                   mesh=self.mesh.spec(), **kw)

    def warmup(self, shapes, *, steps_per_dispatch: int = 1, dtype=None,
               label_dtype=None, policy=None):
        """Warm the wrapped model's steps under THIS wrapper's mesh
        through the compile cache's seam: ``(features, labels)`` pairs
        warm the train step (K steps a dispatch for
        ``steps_per_dispatch`` > 1), bare feature shapes the forward. The
        batch dims pad up to the data-axis multiple as ``fit`` pads real
        batches, and each rank warms its rows' step — the step ``fit``
        dispatches (a batch that pads, the masked step)."""
        from deeplearning4j_tpu_torch.distributed.gspmd import warm_rows
        self._attach()
        if policy is not None:
            self.model.setPrecisionPolicy(policy)
        warm_rows(self.model, shapes, self.mesh.size("data"),
                  max(int(steps_per_dispatch), 1), dtype, label_dtype)
        return self.model

    def fit(self, iterator, epochs: int = 1, steps_per_dispatch: int = 1,
            checkpoint=None, nan_policy=None, faults=None, elastic=None):
        """Train on ``iterator`` (every rank hands the same global
        batches); ``steps_per_dispatch=K`` runs K steps a dispatch (a
        captured CUDA graph on the card, its all-reduces inside).
        ``checkpoint=``/``nan_policy=``/``faults=`` run the fit under the
        resilience layer as the model's own ``fit`` does (data rank 0
        writes the checkpoints). ``elastic=ElasticConfig(...)`` (or
        True) runs :func:`~deeplearning4j_tpu_torch.parallel.elastic.
        fit_elastic`: on a rank's loss the survivors agree on a step,
        form a smaller group and resume from that step's checkpoint
        (requires ``checkpoint=``; ``self.mesh`` is the shrunk mesh
        after a recovery)."""
        if elastic is not None and elastic is not False:
            from deeplearning4j_tpu_torch.parallel import elastic as _elastic
            cfg = elastic if isinstance(elastic, _elastic.ElasticConfig) \
                else _elastic.ElasticConfig()
            return _elastic.fit_elastic(
                self, iterator, epochs=epochs,
                steps_per_dispatch=steps_per_dispatch,
                checkpoint=checkpoint, nan_policy=nan_policy, faults=faults,
                config=cfg)
        self._attach()
        return self.model.fit(
            iterator, epochs=epochs, steps_per_dispatch=steps_per_dispatch,
            prefetch=self.prefetch or 0, checkpoint=checkpoint,
            nan_policy=nan_policy, faults=faults)

    def averagingFrequency(self, n):
        # API-parity shim: the gradients are summed every step; there is
        # no averaging interval to configure
        warnings.warn(
            "ParallelWrapper.averagingFrequency has no effect: gradients are "
            "all-reduced synchronously every step (no interval)",
            stacklevel=2)
        return self

    def workers(self, n):
        warnings.warn(
            "ParallelWrapper.workers has no effect: the worker count is the "
            "mesh's data-axis size (%d); pass a different DeviceMesh instead"
            % self.mesh.size("data"), stacklevel=2)
        return self


_INFERENCE_REPLICA_FAILURES = _prof.get_registry().counter(
    "dl4j_inference_replica_failures_total",
    "Inference forwards that raised or exceeded replica_timeout (each "
    "marks the serving replica set unhealthy and is retried on the "
    "survivors up to max_retries)")

_PI_SEQ = itertools.count(1)


class InferenceFailedError(RuntimeError):
    """An inference batch failed every attempt. ``attempts`` counts the
    forwards tried; ``last_error`` is the final failure."""

    def __init__(self, attempts: int, last_error: BaseException):
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"inference failed after {attempts} attempt(s); last error: "
            f"{type(last_error).__name__}: {last_error}")


class InferenceShutdownError(RuntimeError):
    """The ParallelInference instance was closed while this request was
    still pending (queued, never dispatched). Retriable against another
    replica — the request was not executed."""

    retriable = True

    def __init__(self):
        super().__init__("ParallelInference closed: request was pending "
                         "and has not been executed — retry elsewhere")


class InferenceObservable:
    """Future-like handle for one inference request (ref:
    ObservablesProvider)."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _complete(self, result):
        self._result = result
        self._event.set()

    def _fail(self, exc: Exception):
        self._error = exc
        self._event.set()

    def get(self, timeout: float = None):
        if not self._event.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._error is not None:
            raise self._error
        return self._result


class ParallelInference:
    """Batched inference over the mesh (ref: ParallelInference,
    InferenceMode.BATCHED): queue requests, coalesce up to
    ``batch_limit`` rows, run ONE forward over the mesh, fan the results
    back out.

    A forward that raises — or exceeds ``replica_timeout`` seconds —
    marks the replica set unhealthy: the mesh's ranks are probed, dead
    ones dropped (the mesh rebuilds on the survivors; a mesh with model
    or seq axes stays whole) and the SAME coalesced batch is retried up
    to ``max_retries`` times (``dl4j_inference_replica_failures_total``
    counts the failures); then every request of the batch fails with
    :class:`InferenceFailedError`. The queue is bounded (``max_queue``):
    a full one raises ``serving.ServerOverloadedError``. ``close()``
    (also the context-manager exit; ``shutdown()`` is the
    reference-named alias) stops the worker, fails every pending request
    with :class:`InferenceShutdownError` and releases the followers.

    On a mesh of several ranks every rank builds it alike; the first
    serves and the others call :meth:`follow`, which returns when the
    leader closes (or the fault plan takes the rank). ``model.output``
    runs each rank's rows of the padded batch (split over ``data``).
    """

    def __init__(self, model, mesh: DeviceMesh = None, batch_limit: int = 32,
                 queue_timeout_ms: float = 5.0, max_retries: int = 2,
                 replica_timeout: float = None, faults=None,
                 max_queue: int = 256):
        from deeplearning4j_tpu_torch.parallel.leader import MeshDispatch
        self.model = model
        self.mesh = mesh or DeviceMesh.data_parallel()
        self.batch_limit = batch_limit
        self.timeout = queue_timeout_ms / 1000.0
        self.max_retries = int(max_retries)
        self.replica_timeout = replica_timeout
        self.max_queue = int(max_queue)
        self._faults = faults
        self._batches = 0
        self._dispatch = MeshDispatch(
            self.mesh, self._forward_local,
            f"parallel_inference{next(_PI_SEQ)}", faults=faults,
            context="inference", on_shrink=self._on_shrink)
        self._watchdog = None
        if replica_timeout:
            from deeplearning4j_tpu_torch.parallel.elastic import \
                DispatchWatchdog
            # warmup: the first forwards may build kernels; their wall
            # time says nothing about replica health
            self._watchdog = DispatchWatchdog(deadline=replica_timeout,
                                              grace=replica_timeout)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        # taken per submit AND by the recovery path's mesh swap: wait-time
        # spikes here are the client-visible symptom of a shrink
        from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock
        self._submit_lock = InstrumentedLock("parallel_inference_submit")
        self._shutdown = False
        self._worker = threading.Thread(target=self._serve, daemon=True,
                                        name="dl4j-parallel-inference")
        if self.is_leader:
            self._worker.start()

    @property
    def is_leader(self) -> bool:
        """True on the rank that takes requests (the mesh's first)."""
        return self._dispatch.is_leader

    @property
    def last_shrink_seconds(self):
        """Seconds the last shrink took on this rank (None: none yet)."""
        return self._dispatch.last_shrink_seconds

    def follow(self) -> str:
        """A follower rank's part: join every dispatch until the leader
        closes (``"stopped"``) or the fault plan takes this rank
        (``"lost"``)."""
        if self.is_leader:
            raise RuntimeError("follow(): this rank leads the mesh")
        return self._dispatch.follow()

    def output(self, x, timeout: float = 30.0):
        """Synchronous single-request API (ref: ParallelInference.output)."""
        return self.submit(x).get(timeout)

    def submit(self, x) -> InferenceObservable:
        if not self.is_leader:
            raise RuntimeError("submit(): requests go to the mesh's "
                               "leader; this rank follows")
        obs = InferenceObservable()
        # the lock serializes against close(): no request can slip into
        # the queue after close() drained it (it would hang forever)
        with self._submit_lock:
            if self._shutdown:
                raise InferenceShutdownError()
            try:
                self._queue.put_nowait((np.asarray(x), obs))
            except queue.Full:
                from deeplearning4j_tpu_torch.serving.errors import \
                    ServerOverloadedError
                raise ServerOverloadedError(self._queue.qsize(),
                                            self.max_queue) from None
        return obs

    def _bucket(self, total: int) -> int:
        """The next power of two, capped at ``batch_limit`` (one shape a
        bucket), rounded up to a multiple of the data width."""
        bucket = 1
        while bucket < total:
            bucket *= 2
        bucket = min(max(bucket, 1), max(self.batch_limit, total))
        w = self.mesh.size("data")
        return -(-bucket // w) * w

    def _serve(self):
        while not self._shutdown:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            sizes = [first[0].shape[0]]
            while sum(sizes) < self.batch_limit:
                try:
                    item = self._queue.get(timeout=self.timeout)
                    batch.append(item)
                    sizes.append(item[0].shape[0])
                except queue.Empty:
                    break
            try:
                feats = np.concatenate([b[0] for b in batch], axis=0)
                total = feats.shape[0]
                bucket = self._bucket(total)
                if bucket > total:
                    pad = np.zeros((bucket - total,) + feats.shape[1:],
                                   feats.dtype)
                    feats = np.concatenate([feats, pad], axis=0)
                out = self._forward(feats)[:total]
                pos = 0
                for (_x, obs), n in zip(batch, sizes):
                    obs._complete(out[pos:pos + n])
                    pos += n
            except Exception as e:  # fail the requests, keep the server
                for _, obs in batch:
                    obs._fail(e)

    # ------------------------------------------------------- fault handling
    def _forward_local(self, x, capture: bool = False) -> np.ndarray:
        out = self.model.output(x)
        if hasattr(out, "detach"):
            out = out.detach().cpu().numpy()
        return np.asarray(out)

    def _forward_once(self, feats) -> np.ndarray:
        return self._dispatch.run(feats, self._batches)

    def _forward(self, feats) -> np.ndarray:
        """One coalesced batch through the forward over the mesh, with
        bounded retry on a surviving replica set after a failure or
        timeout."""
        last = None
        attempts = 0
        with self._submit_lock:
            self._batches += 1
        for _ in range(self.max_retries + 1):
            attempts += 1
            self._dispatch.wait_idle()
            try:
                if self._watchdog is not None:
                    return self._watchdog.run(
                        lambda: self._forward_once(feats), attempts)
                return self._forward_once(feats)
            except Exception as e:
                last = e
                _INFERENCE_REPLICA_FAILURES.inc()
                warnings.warn(
                    f"inference replica failure (attempt {attempts}): "
                    f"{type(e).__name__}: {e} — probing devices and "
                    "retrying on the survivors", stacklevel=2)
                self._drop_dead_replicas(e)
        raise InferenceFailedError(attempts, last)

    def _drop_dead_replicas(self, error=None):
        """Probe the serving mesh and rebuild it on the survivors when
        ranks are dead. Over several ranks every rank recovers together
        after a dispatch that failed on any (a timeout the leader alone
        saw leaves the mesh as it is)."""
        from deeplearning4j_tpu_torch.parallel.elastic import \
            shrink_mesh_on_dead
        from deeplearning4j_tpu_torch.parallel.leader import DispatchFailed
        if self._dispatch.multi:
            if isinstance(error, DispatchFailed):
                self._dispatch.recover()
            return
        new = shrink_mesh_on_dead(self.mesh, plan=self._faults,
                                  context="inference")
        if new is not None:
            self._on_shrink(new)

    def _on_shrink(self, mesh) -> None:
        with self._submit_lock:     # submitters/close() read the mesh
            self.mesh = mesh
            self._dispatch.mesh = mesh
        if self._watchdog is not None:
            self._watchdog.begin_attempt()  # the shrunk forward is new

    def close(self, timeout: float = 5.0):
        """Stop the worker, fail every still-pending request with
        :class:`InferenceShutdownError` and release the followers.
        Idempotent; also the context-manager exit."""
        with self._submit_lock:
            if self._shutdown:
                return
            self._shutdown = True
        if not self.is_leader:
            return
        self._worker.join(timeout=timeout)
        while True:
            try:
                _x, obs = self._queue.get_nowait()
            except queue.Empty:
                break
            obs._fail(InferenceShutdownError())
        self._dispatch.stop()

    def shutdown(self):
        """Reference-named alias for :meth:`close`."""
        self.close()

    def __enter__(self) -> "ParallelInference":
        return self

    def __exit__(self, *exc):
        self.close()
