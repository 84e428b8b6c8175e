"""Robust inference serving: continuous batching hardened for failure.

The port of ``deeplearning4j_tpu/serving/server.py`` to one PyTorch
device. :class:`ModelServer` wraps any callable forward behind a
request queue with the operational properties of the JAX server:

- **Bounded admission.** A full queue rejects with
  :class:`~.errors.ServerOverloadedError` instead of blocking producers.
- **Per-request deadlines.** A request whose deadline expires while
  queued is shed with :class:`~.errors.DeadlineExceededError` before
  dispatch and its batch slot reclaimed. Requests are resolved exactly
  once (shed XOR completed), enforced by a lock in
  :class:`ServingRequest`.
- **Bucketed warmup.** Coalesced batches pad to power-of-two buckets
  (data width 1 on one device); :meth:`ModelServer.warmup` runs every
  bucket x shape once before ``ready`` flips true.
- **Bounded retry and a circuit breaker.** A failed dispatch is retried
  up to ``max_retries`` times; :class:`CircuitBreaker` trips after
  ``breaker_threshold`` consecutive failures and admissions fail fast
  with :class:`~.errors.ServerUnhealthyError` until a half-open probe
  batch succeeds.
- **Graceful drain.** :meth:`drain` stops admissions, completes the
  in-flight batch and fails queued requests with the retriable
  :class:`~.errors.ServerDrainingError`.
- **Results-only device->host copy.** ``head="argmax" | "softmax" |
  "top_k[:k]"`` runs on the device; the one ``.cpu()`` copy per batch
  moves the head's output, billed to ``dl4j_serving_d2h_bytes_total``.

The forward of a batch is: numpy -> tensor on ``device`` -> forward
under ``torch.inference_mode()`` -> head -> one copy to the host.

Not ported yet (ROADMAP.md): meshes and sharding, the dispatch watchdog
and mesh shrink, the recompile-churn detector, ``validate()`` lints and
cost checks, the flight recorder, trace spans and instrumented locks,
fault injection, tuned plans, traffic capture and preemption signals.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
import warnings
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.profiler.metrics import get_registry
from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     ServerClosedError,
                                                     ServerDrainingError,
                                                     ServerOverloadedError,
                                                     ServerUnhealthyError,
                                                     ServingError)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = get_registry()
REQUESTS = _REG.counter(
    "dl4j_serving_requests_total",
    "Serving requests by terminal outcome: completed, failed (dispatch "
    "error after retries), shed_deadline (expired while queued), "
    "shed_overload (queue full at admission), shed_draining (queued at "
    "drain), rejected_unhealthy (breaker open), rejected_closed",
    labelnames=("outcome",))
LATENCY = _REG.histogram(
    "dl4j_serving_latency_seconds",
    "End-to-end request latency, admission to completion (completed "
    "requests only)")
QUEUE_DEPTH = _REG.gauge(
    "dl4j_serving_queue_depth",
    "Requests currently queued for the next coalesced batch, per server",
    labelnames=("server",))
OCCUPANCY = _REG.histogram(
    "dl4j_serving_batch_occupancy",
    "Live rows / padded bucket size per dispatched batch (1.0 = no "
    "padding waste)",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
BATCHES = _REG.counter(
    "dl4j_serving_batches_total",
    "Coalesced batches dispatched (including retried-then-failed ones)")
BREAKER_STATE = _REG.gauge(
    "dl4j_serving_breaker_state",
    "Circuit breaker state per server: 0 closed, 0.5 half-open (probe "
    "in flight), 1 open (failing fast)",
    labelnames=("server",))
REPLICA_FAILURES = _REG.counter(
    "dl4j_serving_replica_failures_total",
    "Serving dispatches that raised (each is retried up to max_retries)")
WARMUP_SECONDS = _REG.gauge(
    "dl4j_serving_warmup_seconds",
    "Wall time of the last warmup(): one forward of every bucket x shape")
D2H_BYTES = _REG.counter(
    "dl4j_serving_d2h_bytes_total",
    "Bytes actually copied device->host per serving dispatch (the "
    "post-head result payload — with head=argmax/top_k this is the "
    "results-only bill, without a head it is the full logits)")
SHED_RATIO = _REG.gauge(
    "dl4j_serving_shed_ratio",
    "Fraction of this server's terminal requests that were shed or "
    "rejected (overload + deadline + draining + breaker)",
    labelnames=("server",))
OCCUPANCY_MEAN = _REG.gauge(
    "dl4j_serving_batch_occupancy_mean",
    "Mean live-rows/bucket ratio of this server's dispatched batches "
    "(1.0 = no padding waste)",
    labelnames=("server",))


class InferenceFailedError(RuntimeError):
    """An inference batch failed every attempt. ``attempts`` counts the
    forwards tried; ``last_error`` is the final failure."""

    def __init__(self, attempts: int, last_error: BaseException):
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"inference failed after {attempts} attempt(s); last error: "
            f"{type(last_error).__name__}: {last_error}")


# ------------------------------------------------------- forward adapters
def resolve_forward(model):
    """The server's model contract: anything with ``.output(x)``, or any
    plain callable ``x -> predictions`` (e.g. ``TransformerLM.logits``)."""
    out = getattr(model, "output", None)
    if callable(out):
        return out
    if callable(model):
        return model
    raise TypeError(
        f"cannot serve {type(model).__name__}: pass a model exposing "
        "output(x) or any callable x -> predictions")


def _argmax(y):
    # int32 labels, as jnp.argmax returns them
    return torch.argmax(y, dim=-1).to(torch.int32)


def _make_head(head):
    """A results-only post-processing head run on the device: the
    device->host copy then moves the head's (small) output instead of
    full logits."""
    if head is None:
        return None
    if head == "argmax":
        return _argmax
    if head == "softmax":
        return lambda y: torch.softmax(y, dim=-1)
    if isinstance(head, str) and head.split(":", 1)[0] == "top_k":
        k = int(head.split(":", 1)[1]) if ":" in head else 5

        def top_k(y):
            vals, idx = torch.topk(y, k, dim=-1)
            return vals, idx.to(torch.int32)
        return top_k
    raise ValueError(
        f"unknown head {head!r} (expected 'argmax', 'softmax' or "
        "'top_k[:k]')")


def _map_arrays(fn, out):
    if isinstance(out, (tuple, list)):
        return tuple(_map_arrays(fn, o) for o in out)
    return fn(out)


def _to_host(out):
    if isinstance(out, (tuple, list)):
        return tuple(_to_host(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def _nbytes(out) -> int:
    if isinstance(out, (tuple, list)):
        return sum(_nbytes(o) for o in out)
    return int(out.nbytes)


def _slice_rows(out, lo: int, hi: int):
    """Row-slice a (possibly nested-tuple) result along the batch axis —
    how one coalesced dispatch splits back into per-request results."""
    if isinstance(out, (tuple, list)):
        return tuple(_slice_rows(o, lo, hi) for o in out)
    return out[lo:hi]


class ServingRequest:
    """One queued inference request. Future-like: ``get(timeout)``.

    Resolution is exactly-once by construction: ``_resolve`` takes an
    internal lock and the first completion/failure wins — a request
    shed on deadline can never ALSO be completed by a racing dispatch,
    and ``resolutions`` (the win count) is pinned to <= 1 by tests.
    """

    __slots__ = ("features", "n", "deadline", "enqueued_at", "resolved_at",
                 "resolutions", "server", "_event", "_lock", "_resolved",
                 "_result", "_error")

    def __init__(self, features: np.ndarray, deadline: Optional[float],
                 enqueued_at: float):
        self.features = features
        self.n = int(features.shape[0])
        self.server: Optional[str] = None   # stamped at admission
        self.deadline = deadline            # absolute time.monotonic() or None
        self.enqueued_at = enqueued_at
        self.resolved_at: Optional[float] = None
        self.resolutions = 0
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._resolved = False
        self._result = None
        self._error: Optional[BaseException] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def _resolve(self, result=None, error: BaseException = None) -> bool:
        """First resolution wins; returns whether THIS call won."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
            self.resolutions += 1
            self.resolved_at = time.monotonic()
            self._result = result
            self._error = error
        self._event.set()
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def get(self, timeout: float = None):
        if not self._event.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._error is not None:
            raise self._error
        return self._result


class CircuitBreaker:
    """CLOSED -> (N consecutive failures) -> OPEN -> (cooldown) ->
    HALF_OPEN -> one probe batch -> CLOSED on success, OPEN on failure.

    ``clock`` is injectable so the cooldown is deterministic in tests.
    Thread-safe: admission (client threads) and dispatch accounting
    (the serve thread) share the state under one lock.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 clock=time.monotonic, name: str = "default"):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.name = str(name)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._gauge()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._failures

    def _gauge(self):
        BREAKER_STATE.labels(server=self.name).set(
            {self.CLOSED: 0.0, self.HALF_OPEN: 0.5,
             self.OPEN: 1.0}[self._state])

    def admit(self) -> bool:
        """Admission-side gate: False while OPEN (fail fast). HALF_OPEN
        admits — the probe batch is about to decide recovery."""
        with self._lock:
            if self._state == self.OPEN \
                    and self._clock() - self._opened_at >= self.cooldown:
                self._state = self.HALF_OPEN
                self._gauge()
            return self._state != self.OPEN

    def retry_after(self) -> Optional[float]:
        with self._lock:
            if self._state != self.OPEN:
                return None
            return max(self.cooldown - (self._clock() - self._opened_at), 0.0)

    def allow_dispatch(self) -> bool:
        """Serve-loop gate: True unless OPEN with cooldown remaining."""
        with self._lock:
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown:
                    return False
                self._state = self.HALF_OPEN
                self._gauge()
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                logger.info("circuit breaker: %s -> closed (probe batch "
                            "succeeded)", self._state)
            self._state = self.CLOSED
            self._gauge()

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN \
                    or self._failures >= self.threshold:
                if self._state != self.OPEN:
                    logger.warning(
                        "circuit breaker: open after %d consecutive "
                        "dispatch failures (cooldown %.3gs)",
                        self._failures, self.cooldown)
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._gauge()


_SERVER_SEQ = itertools.count()


class ModelServer:
    """Continuous-batching model server on one device (module doc).

    Parameters
    ----------
    model : a model exposing ``output(x)``, or any callable forward.
    device : where batches run (default ``cuda``; raises without a card
        unless ``device="cpu"`` is passed).
    batch_limit : max live rows per coalesced batch (= largest bucket).
    max_queue : bound on queued requests; admission control beyond it.
    coalesce_ms : how long the batcher waits for more arrivals once it
        holds a partial batch.
    default_deadline : per-request deadline in seconds applied when
        ``submit`` passes none (None = no deadline).
    max_retries : dispatch retries after a forward failure.
    breaker_threshold / breaker_cooldown : circuit-breaker tuning.
    drain_timeout : how long ``drain()``/``close()`` waits for the
        in-flight batch before failing the queue itself.
    input_dtype : requests are cast to this dtype at admission.
    name : stable label for this server's metrics.
    head : results-only post-processing on the device: ``"argmax"``,
        ``"softmax"`` or ``"top_k"``/``"top_k:k"`` (-> ``(values,
        indices)``).
    """

    def __init__(self, model, device=None, batch_limit: int = 32,
                 max_queue: int = 128, coalesce_ms: float = 2.0,
                 default_deadline: Optional[float] = None,
                 max_retries: int = 2,
                 breaker_threshold: int = 5, breaker_cooldown: float = 5.0,
                 drain_timeout: float = 30.0, input_dtype=np.float32,
                 name: Optional[str] = None, head=None):
        self.model = model
        self.device = resolve_device(device)
        self._fwd = resolve_forward(model)
        self.head = head
        self._head_fn = _make_head(head)
        self.name = name if name is not None else f"server{next(_SERVER_SEQ)}"
        self.batch_limit = int(batch_limit)
        self.max_queue = int(max_queue)
        self.coalesce = float(coalesce_ms) / 1000.0
        self.default_deadline = default_deadline
        self.max_retries = int(max_retries)
        self.drain_timeout = float(drain_timeout)
        self.input_dtype = np.dtype(input_dtype)
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown,
                                      name=self.name)
        self._queue_gauge = QUEUE_DEPTH.labels(server=self.name)
        # Condition over an RLock: _count re-enters it from submit
        self._cond = threading.Condition()
        self._dq: "collections.deque[ServingRequest]" = collections.deque()
        self._draining = False
        self._drained = False
        self._closed = False
        self._drain_requested = threading.Event()
        self._warmed = False
        self._warm_shapes: list = []
        self._died = False
        self._batches = 0
        self._occ_sum = 0.0
        self._occ_n = 0
        self.counts: "collections.Counter[str]" = collections.Counter()
        self._worker = threading.Thread(target=self._serve, daemon=True,
                                        name="dl4j-serving")
        self._worker.start()

    # ------------------------------------------------------------- buckets
    def buckets(self) -> list:
        """Padded batch sizes this server runs: powers of two from 1 up
        to (at least) ``batch_limit``."""
        out = [1]
        while out[-1] < self.batch_limit:
            out.append(out[-1] * 2)
        return out

    def _bucket_for(self, total: int) -> int:
        for b in self.buckets():
            if b >= total:
                return b
        return self.buckets()[-1]

    # ----------------------------------------------------------- admission
    def submit(self, x, deadline: Optional[float] = None) -> ServingRequest:
        """Queue one request. ``x``: [n, ...features] with n <=
        ``batch_limit``; ``deadline``: seconds from now (overrides
        ``default_deadline``). Raises the structured admission errors
        instead of ever blocking the caller."""
        x = np.asarray(x, dtype=self.input_dtype)
        if x.ndim < 1:
            raise ValueError("request features need a leading batch dim")
        if x.shape[0] > self.batch_limit:
            raise ValueError(
                f"request rows {x.shape[0]} exceed batch_limit "
                f"{self.batch_limit} — split the request")
        if self._warmed:
            fshape = tuple(int(d) for d in x.shape[1:])
            if fshape not in self._warm_shapes:
                raise ValueError(
                    f"request feature shape {fshape} was not warmed "
                    f"(warmed: {self._warm_shapes}) — call "
                    "warmup([shape]) before serving it")
        now = time.monotonic()
        dl = self.default_deadline if deadline is None else deadline
        req = ServingRequest(x, now + dl if dl is not None else None, now)
        req.server = self.name
        try:
            with self._cond:
                if self._closed:
                    self._count("rejected_closed")
                    raise ServerClosedError()
                if self._draining or self._drain_requested.is_set():
                    self._count("shed_draining")
                    raise ServerDrainingError()
                if not self.breaker.admit():
                    self._count("rejected_unhealthy")
                    raise ServerUnhealthyError(
                        self.breaker.consecutive_failures,
                        retry_after=self.breaker.retry_after())
                if len(self._dq) >= self.max_queue:
                    self._count("shed_overload")
                    raise ServerOverloadedError(len(self._dq),
                                                self.max_queue)
                self._dq.append(req)
                self._queue_gauge.set(len(self._dq))
                self._cond.notify()
        except ServingError as e:
            # an admission rejection IS the request's terminal outcome
            req._resolve(error=e)
            raise
        return req

    def output(self, x, timeout: float = 30.0,
               deadline: Optional[float] = None) -> np.ndarray:
        """Synchronous single-request API."""
        return self.submit(x, deadline=deadline).get(timeout)

    def _count(self, outcome: str):
        with self._cond:
            self.counts[outcome] += 1
        REQUESTS.labels(outcome=outcome).inc()

    # ------------------------------------------------------------- warmup
    def warmup(self, shapes: Iterable[Sequence[int]]) -> "ModelServer":
        """Run every bucket x feature shape once BEFORE taking traffic
        (kernel builds, cuBLAS handles and the caching allocator's pools
        are set up then, not on the first request): ``shapes`` are
        per-request feature shapes WITHOUT the leading batch dim, e.g.
        ``[(128,), (512,)]`` for token rows. Then flips ``ready`` true."""
        shapes = [tuple(int(d) for d in s) for s in shapes]
        t0 = time.perf_counter()
        for shape in shapes:
            for b in self.buckets():
                self._forward_raw(np.zeros((b,) + shape, self.input_dtype))
        elapsed = time.perf_counter() - t0
        WARMUP_SECONDS.set(elapsed)
        with self._cond:
            for s in shapes:
                if s not in self._warm_shapes:
                    self._warm_shapes.append(s)
            self._warmed = True
        logger.info("serving warmup: %d bucket(s) x %d shape(s) in %.3fs "
                    "on %s", len(self.buckets()), len(shapes), elapsed,
                    self.device)
        return self

    # ------------------------------------------------------- health surface
    @property
    def ready(self) -> bool:
        """True once warmed and still admitting."""
        return (self._warmed and not self._draining and not self._closed
                and not self._drain_requested.is_set()
                and self._worker.is_alive()
                and self.breaker.admit())

    @property
    def healthy(self) -> bool:
        """True unless the breaker is open or the serve loop died."""
        return (self.breaker.state != CircuitBreaker.OPEN
                and not self._died
                and (self._worker.is_alive() or self._drained
                     or self._closed))

    @property
    def state(self) -> str:
        if self._closed:
            return "closed"
        if self._draining or self._drain_requested.is_set():
            return "draining"
        if not self._warmed:
            return "warming"
        return "serving"

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._dq)

    def stats(self) -> dict:
        """Operational snapshot: latency quantiles (process-wide
        histogram), per-server outcome counts, queue/breaker state."""
        return {
            "state": self.state,
            "ready": self.ready,
            "healthy": self.healthy,
            "queue_depth": self.queue_depth(),
            "batches": self._batches,
            "breaker": self.breaker.state,
            "counts": dict(self.counts),
            "buckets": self.buckets(),
            "latency_p50": LATENCY.quantile(0.5),
            "latency_p99": LATENCY.quantile(0.99),
        }

    _SHED_OUTCOMES = ("shed_overload", "shed_deadline", "shed_draining",
                      "rejected_unhealthy")

    def load_hints(self) -> dict:
        """Structured autoscaling / load-balancer hints: queue depth and
        fill, shed rate over this server's terminal outcomes, breaker
        state, and mean bucket occupancy. Mirrored to the
        ``dl4j_serving_shed_ratio`` and
        ``dl4j_serving_batch_occupancy_mean`` gauges on every call."""
        with self._cond:
            qd = len(self._dq)
            counts = dict(self.counts)
            batches = self._batches
            occ = self._occ_sum / self._occ_n if self._occ_n else None
        total = sum(counts.values())
        shed = sum(counts.get(k, 0) for k in self._SHED_OUTCOMES)
        shed_rate = shed / total if total else 0.0
        SHED_RATIO.labels(server=self.name).set(shed_rate)
        OCCUPANCY_MEAN.labels(server=self.name).set(occ or 0.0)
        return {
            "server": self.name,
            "state": self.state,
            "ready": self.ready,
            "queue_depth": qd,
            "max_queue": self.max_queue,
            "queue_fill": round(qd / self.max_queue, 6)
            if self.max_queue else 0.0,
            "requests": total,
            "shed": shed,
            "shed_rate": round(shed_rate, 6),
            "breaker": self.breaker.state,
            "batches": batches,
            "buckets": self.buckets(),
            "batch_occupancy_mean": None if occ is None else round(occ, 6),
        }

    # ------------------------------------------------------------ serve loop
    def _serve(self):
        try:
            while True:
                with self._cond:
                    if self._closed or self._drain_requested.is_set():
                        return
                    if not self._dq:
                        # bounded wait so drain/breaker checks run even
                        # on an idle server
                        self._cond.wait(0.05)
                        continue
                if not self.breaker.allow_dispatch():
                    # failing fast: do not dispatch, but keep shedding
                    # requests whose deadlines expire while we wait
                    self._shed_expired()
                    time.sleep(0.005)
                    continue
                batch = self._build_batch()
                if batch:
                    self._dispatch(batch)
        except BaseException:
            with self._cond:
                self._died = True
            logger.exception("serving loop died — failing queued requests")
            raise
        finally:
            self._finish_drain()

    def _shed(self, req: ServingRequest, now: float):
        waited = now - req.enqueued_at
        deadline = (req.deadline - req.enqueued_at
                    if req.deadline is not None else 0.0)
        if req._resolve(error=DeadlineExceededError(waited, deadline)):
            self._count("shed_deadline")

    def _shed_expired(self):
        """Shed every expired request anywhere in the queue (the breaker
        is open, so nothing is dispatching)."""
        now = time.monotonic()
        with self._cond:
            if any(r.expired(now) for r in self._dq):
                live = collections.deque()
                for r in self._dq:
                    if r.expired(now):
                        self._shed(r, now)
                    else:
                        live.append(r)
                self._dq = live
            self._queue_gauge.set(len(self._dq))

    def _build_batch(self) -> list:
        """Pop up to ``batch_limit`` live rows of one feature shape,
        shedding expired requests as they surface, waiting up to the
        coalesce window for more arrivals once it holds a partial
        batch."""
        batch: list = []
        total = 0
        t_end = None
        shape = None
        while True:
            now = time.monotonic()
            with self._cond:
                while self._dq and self._dq[0].expired(now):
                    self._shed(self._dq.popleft(), now)
                while self._dq and total < self.batch_limit \
                        and total + self._dq[0].n <= self.batch_limit \
                        and (shape is None
                             or self._dq[0].features.shape[1:] == shape):
                    req = self._dq.popleft()
                    if req.expired(now):
                        self._shed(req, now)
                        continue
                    batch.append(req)
                    total += req.n
                    shape = req.features.shape[1:]
                self._queue_gauge.set(len(self._dq))
                head_full = bool(self._dq) and (
                    total + self._dq[0].n > self.batch_limit
                    or (shape is not None
                        and self._dq[0].features.shape[1:] != shape))
            if not batch:
                return batch
            if total >= self.batch_limit or head_full:
                return batch
            if t_end is None:
                t_end = now + self.coalesce
            remaining = t_end - now
            if remaining <= 0:
                return batch
            if self._drain_requested.is_set() or self._closed:
                return batch    # dispatch what we hold, then drain
            with self._cond:
                if not self._dq:
                    self._cond.wait(min(remaining, 0.01))

    def _dispatch(self, batch: list):
        total = sum(r.n for r in batch)
        bucket = self._bucket_for(total)
        try:
            # inside the try: ANY failure building or running the batch
            # must resolve its requests, never kill the serve loop
            feats = np.concatenate([r.features for r in batch], axis=0)
            out = self._forward(feats)
        except Exception as e:
            self.breaker.record_failure()
            for req in batch:
                if req._resolve(error=e):
                    self._count("failed")
        else:
            self.breaker.record_success()
            now = time.monotonic()
            pos = 0
            for req in batch:
                if req._resolve(result=_slice_rows(out, pos, pos + req.n)):
                    LATENCY.observe(now - req.enqueued_at)
                    self._count("completed")
                pos += req.n
        OCCUPANCY.observe(total / float(bucket))
        with self._cond:
            self._batches += 1
            self._occ_sum += total / float(bucket)
            self._occ_n += 1
        BATCHES.inc()

    # ------------------------------------------------------------- forward
    def _forward(self, feats: np.ndarray):
        """One coalesced batch (live rows only), padded to its bucket,
        with bounded retry after a failure."""
        total = int(feats.shape[0])
        bucket = self._bucket_for(total)
        padded = feats
        if bucket > total:
            padded = np.concatenate(
                [feats, np.zeros((bucket - total,) + feats.shape[1:],
                                 feats.dtype)], axis=0)
        last = None
        for attempt in range(1, self.max_retries + 2):
            try:
                return _slice_rows(self._forward_raw(padded), 0, total)
            except Exception as e:
                last = e
                REPLICA_FAILURES.inc()
                warnings.warn(
                    f"serving dispatch failure (attempt {attempt}): "
                    f"{type(e).__name__}: {e} — retrying", stacklevel=2)
        raise InferenceFailedError(self.max_retries + 1, last)

    def _forward_raw(self, feats: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)
        with torch.inference_mode():
            out = self._fwd(x)
            if self._head_fn is not None:
                out = _map_arrays(self._head_fn, out)
            host = _to_host(out)            # THE per-batch D2H copy
        D2H_BYTES.inc(_nbytes(host))
        return host

    # --------------------------------------------------------------- drain
    def drain(self, timeout: float = None) -> "ModelServer":
        """Stop admissions, let the in-flight batch complete, fail every
        queued-but-undispatched request with the retriable
        :class:`ServerDrainingError`, and stop the serve loop. Safe to
        call from any thread and idempotent."""
        self._drain_requested.set()
        with self._cond:
            self._cond.notify_all()
        if threading.current_thread() is not self._worker:
            self._worker.join(timeout if timeout is not None
                              else self.drain_timeout)
            if self._worker.is_alive():
                warnings.warn("drain: serve loop still busy after "
                              "timeout — failing queued requests directly",
                              stacklevel=2)
                self._finish_drain()
        return self

    def _finish_drain(self):
        with self._cond:
            self._draining = True
            queued = list(self._dq)
            self._dq.clear()
            self._queue_gauge.set(0)
            self._cond.notify_all()
        for req in queued:
            if req._resolve(error=ServerDrainingError()):
                self._count("shed_draining")
        with self._cond:
            self._drained = True

    def close(self):
        """Drain, then refuse every later submit. Idempotent; also the
        context-manager exit."""
        if self._closed:
            return
        self.drain()
        with self._cond:
            self._closed = True

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc):
        self.close()
