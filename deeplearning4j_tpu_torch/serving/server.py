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
- **Bucketed, captured warmup.** Coalesced batches pad to power-of-two
  buckets (data width 1 on one device). On the card the forward and its
  head run as one CUDA graph per bucket x feature shape
  (:class:`~deeplearning4j_tpu_torch.nn.compilecache.CachedDispatch`,
  scope ``"serving:forward"``, one memory pool per server):
  :meth:`ModelServer.warmup` captures every one before ``ready`` flips
  true, and each signature is reported to the recompile-churn detector
  so zero steady-state captures is a *measured* property
  (:meth:`ModelServer.recompiles_after_warmup`). Before warmup the
  forward runs eagerly; unwarmed shapes are refused at ``submit``.
- **Supervised dispatch, bounded retry and a circuit breaker.** Each
  forward runs under a
  :class:`~deeplearning4j_tpu_torch.parallel.elastic.DispatchWatchdog`
  (``replica_timeout``); a failed or timed-out dispatch is retried up to
  ``max_retries`` times; :class:`CircuitBreaker` trips after
  ``breaker_threshold`` consecutive failures and admissions fail fast
  with :class:`~.errors.ServerUnhealthyError` until a half-open probe
  batch succeeds.
- **Graceful drain.** SIGTERM (``preemption=True``, through
  :class:`~deeplearning4j_tpu_torch.train.resilience.SignalPreemption`)
  or :meth:`drain` stops admissions, completes the in-flight batch,
  fails queued requests with the retriable
  :class:`~.errors.ServerDrainingError`, and exits the serve loop.
- **Results-only device->host copy.** ``head="argmax" | "softmax" |
  "top_k[:k]"`` (or any callable) runs on the device inside the graph;
  the one ``.cpu()`` copy per batch moves the head's output, billed to
  ``dl4j_serving_d2h_bytes_total``.
- **Observability.** ``serve:admission``/``queue``/``coalesce``/
  ``dispatch``/``retry``/``terminal`` spans under each request's
  :class:`~deeplearning4j_tpu_torch.profiler.tracecontext.TraceContext`
  (recorded while tracing is on), flight-recorder events at every
  dispatch and failure, and an instrumented ``"serving"`` condition.

The forward of a batch is: numpy -> tensor on ``device`` (outside the
graph) -> the captured forward + head under ``torch.inference_mode()``
-> one copy to the host.

``validate(shapes=, hbm_gb=, check_cache=, cost=)`` lints the bucket
ladder statically (``analysis.serving.lint_serving``, with
``check_cache=True`` the DL4J-W112 disk-tier check and, with ``cost=``,
the E121/E122 cost-model codes). ``warmup(shapes, strict=, cost=)`` runs
that lint with ``check_cache=True`` first (``strict=True`` raises on an
E-code, else each finding warns), then captures; with the compile cache's
disk tier configured it adds the shapes the model's manifest names.

``capture=`` (a :class:`~deeplearning4j_tpu_torch.lifecycle.capture.
TrafficCapture`) records each validated request before admission.

Not ported yet (ROADMAP.md): meshes, sharding and mesh shrink (on one
card a failed dispatch retries on the same card).
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

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.analysis import churn as _churn
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import compilecache as _cc
from deeplearning4j_tpu_torch.parallel.elastic import (DispatchTimeoutError,
                                                       DispatchWatchdog)
from deeplearning4j_tpu_torch.profiler import flightrec as _flightrec
from deeplearning4j_tpu_torch.profiler import tracecontext as _tracectx
from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     ServerClosedError,
                                                     ServerDrainingError,
                                                     ServerOverloadedError,
                                                     ServerUnhealthyError,
                                                     ServingError)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = _prof.get_registry()
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
    "Serving dispatches that raised or exceeded replica_timeout (each is "
    "retried up to max_retries)")
WARMUP_SECONDS = _REG.gauge(
    "dl4j_serving_warmup_seconds",
    "Wall time of the last warmup(): the capture of every bucket x shape")
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
def samediff_forward(sd, outputs, input_name=None):
    """Adapt a SameDiff graph to the callable-forward contract (ref:
    ``sd.batchOutput().input(...).output(...).exec()``): returns
    ``x -> tensor`` (one output) or ``x -> tuple`` (several). ``outputs``
    are SDVariables or names; ``input_name`` defaults to the graph's
    single placeholder (a graph with several must name it)."""
    names = [o.name if hasattr(o, "name") else str(o) for o in outputs]
    if not names:
        raise ValueError("samediff_forward needs at least one output name")
    if input_name is None:
        phs = list(getattr(sd, "_placeholders", {}))
        if len(phs) != 1:
            raise ValueError(
                f"SameDiff graph has {len(phs)} placeholders ({phs}) — "
                "pass input_name= to pick the request-features one")
        input_name = phs[0]

    def forward(x):
        out = sd.output({input_name: x}, names)
        if len(names) == 1:
            return out[names[0]]
        return tuple(out[n] for n in names)
    # the serving lint and the cost model read the graph through this
    forward._samediff = sd
    return forward


def resolve_forward(model):
    """The server's model contract: anything with ``.output(x)``, or any
    plain callable ``x -> predictions`` (e.g. ``TransformerLM.logits``).
    SameDiff graphs need :func:`samediff_forward` because their
    ``output`` wants ``(placeholders, output_names)``, not features."""
    if hasattr(model, "batchOutput") and hasattr(model, "_placeholders"):
        raise TypeError(
            "a SameDiff graph's output() takes (placeholders, outputs) — "
            "wrap it: ModelServer(samediff_forward(sd, ['out']), ...)")
    out = getattr(model, "output", None)
    if callable(out):
        return out
    if callable(model):
        return model
    raise TypeError(
        f"cannot serve {type(model).__name__}: pass a model exposing "
        "output(x), samediff_forward(sd, outputs), or any callable "
        "x -> predictions")


def _argmax(y):
    # int32 labels, as jnp.argmax returns them
    return torch.argmax(y, dim=-1).to(torch.int32)


def _make_head(head):
    """A results-only post-processing head run on the device, inside the
    captured forward: the device->host copy then moves the head's
    (small) output instead of full logits. Any callable on the logits
    is a head too."""
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
    if callable(head):
        return head
    raise ValueError(
        f"unknown head {head!r} (expected 'argmax', 'softmax', "
        "'top_k[:k]', or a callable)")


def _normalize_out(out):
    """Multi-output forwards may return lists; tuples are the canonical
    nested-result shape everywhere downstream."""
    if isinstance(out, (list, tuple)):
        return tuple(_normalize_out(o) for o in out)
    return out


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
                 "resolutions", "server", "trace", "_t0_us", "_event",
                 "_lock", "_resolved", "_result", "_error")

    def __init__(self, features: np.ndarray, deadline: Optional[float],
                 enqueued_at: float,
                 trace: Optional[_tracectx.TraceContext] = None):
        self.features = features
        self.n = int(features.shape[0])
        self.server: Optional[str] = None  # stamped at admission: which
        # server (and so which registry version) owns this request
        self.deadline = deadline          # absolute time.monotonic() or None
        self.enqueued_at = enqueued_at
        self.resolved_at: Optional[float] = None   # monotonic, set once
        self.resolutions = 0
        # every request carries a trace context even with tracing off
        # (IDs are cheap; span RECORDING stays gated) so responses can
        # always report their trace_id
        self.trace = (trace if trace is not None
                      else _tracectx.TraceContext.new())
        self._t0_us = _prof.now_us()
        self._event = threading.Event()
        # WitnessedLock, not InstrumentedLock: the exactly-once gate is
        # per-request hot path — witness coverage without the per-lock
        # metrics/TLS overhead
        self._lock = _prof.WitnessedLock("serving:request")
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
        # the request's terminal span: exactly one per request (this
        # call won), spanning admission -> resolution, outcome carried
        # as an arg — what the chaos sweep asserts every request has
        _tracectx.record_span(
            "serve:terminal", self.trace, self._t0_us,
            _prof.now_us() - self._t0_us,
            args={"outcome": ("completed" if error is None
                              else type(error).__name__),
                  "server": self.server})
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
        self._lock = _prof.InstrumentedLock("serving:breaker")
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
    max_retries : dispatch retries after a forward failure or timeout.
    replica_timeout : soft watchdog deadline per dispatch (None = no
        supervision); grace defaults to 4x.
    breaker_threshold / breaker_cooldown : circuit-breaker tuning.
    drain_timeout : how long ``drain()``/``close()`` waits for the
        in-flight batch before failing the queue itself.
    input_dtype : requests are cast to this dtype at admission, so the
        captured signature is pinned (dtype drift = a new capture).
    preemption : a :class:`~deeplearning4j_tpu_torch.train.resilience.
        PreemptionSignal` polled between batches — ``True`` installs
        :class:`~deeplearning4j_tpu_torch.train.resilience.
        SignalPreemption` (SIGTERM/SIGINT -> drain). Deterministic tests
        pass ``StepPreemption(n)`` (drain after n batches).
    faults : a :class:`~deeplearning4j_tpu_torch.faults.FaultPlan`
        wiring the serving fault seams (injected replica faults, slow and
        hung forwards) for chaos tests.
    name : stable label for this server's metrics; defaults to a
        process-unique ``serverN``.
    forward : explicit forward callable ``x -> predictions`` overriding
        the model contract (default: :func:`resolve_forward`).
    head : results-only post-processing on the device: ``"argmax"``,
        ``"softmax"``, ``"top_k"``/``"top_k:k"`` (-> ``(values,
        indices)``), or any callable on the logits.
    capture : a :class:`~deeplearning4j_tpu_torch.lifecycle.capture.
        TrafficCapture` (or any ``.record(features, deadline=)``)
        sampling live requests at admission into the ServingLoad replay
        format: the recorded stream is the lifecycle gate's eval set and
        deterministic chaos input. (It records traffic; it is not the
        CUDA-graph capture of the forward.)
    """

    def __init__(self, model, device=None, batch_limit: int = 32,
                 max_queue: int = 128, coalesce_ms: float = 2.0,
                 default_deadline: Optional[float] = None,
                 max_retries: int = 2,
                 replica_timeout: Optional[float] = None,
                 breaker_threshold: int = 5, breaker_cooldown: float = 5.0,
                 drain_timeout: float = 30.0, input_dtype=np.float32,
                 preemption=None, faults=None,
                 name: Optional[str] = None, forward=None, head=None,
                 capture=None):
        self.model = model
        self.device = resolve_device(device)
        self._fwd = forward if forward is not None else resolve_forward(model)
        self.head = head
        self._head_fn = _make_head(head)
        # forward + head as one captured graph per signature, the graphs
        # of this server in one pool
        self._dispatch = _cc.CachedDispatch(
            self._device_forward, "serving:forward",
            manifest=self._manifest_name)
        self.name = name if name is not None else f"server{next(_SERVER_SEQ)}"
        self.batch_limit = int(batch_limit)
        self.max_queue = int(max_queue)
        self.coalesce = float(coalesce_ms) / 1000.0
        self.default_deadline = default_deadline
        self.max_retries = int(max_retries)
        self.replica_timeout = replica_timeout
        self.drain_timeout = float(drain_timeout)
        self.input_dtype = np.dtype(input_dtype)
        self._faults = faults
        self._traffic_capture = capture
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown,
                                      name=self.name)
        self._queue_gauge = QUEUE_DEPTH.labels(server=self.name)
        # deadline=None -> unsupervised inline dispatch (fault holds still
        # honored); warmup=0 because warmup() captures every bucket — a
        # steady-state dispatch that captures IS a defect here
        self._watchdog = DispatchWatchdog(replica_timeout, plan=faults,
                                          warmup=0)
        self._churn = _churn.get_churn_detector()
        # instrumented: dl4j_lock_{wait,hold}_seconds{lock="serving"} +
        # contention counter under ProfilingMode (profiler.locks)
        self._cond = _prof.InstrumentedCondition("serving")
        self._dq: "collections.deque[ServingRequest]" = collections.deque()
        self._draining = False
        self._drained = False
        self._closed = False
        self._drain_requested = threading.Event()
        self._warmed = False
        self._warm_shapes: list = []
        self._warm_sig_count = 0
        self._warm_captures = 0
        self._died = False
        self._batches = 0
        self._occ_sum = 0.0         # live-rows/bucket ratios, for the
        self._occ_n = 0             # load_hints() occupancy mean
        self.counts: "collections.Counter[str]" = collections.Counter()
        self._preemption = None
        self._preemption_installed = False
        if preemption is not None and preemption is not False:
            from deeplearning4j_tpu_torch.train import resilience as _res
            self._preemption = _res.SignalPreemption(
                on_request=self._drain_requested.set) \
                if preemption is True else preemption
            install = getattr(self._preemption, "install", None)
            if install is not None:
                self._preemption_installed = bool(install())
        self._worker = threading.Thread(target=self._serve, daemon=True,
                                        name="dl4j-serving")
        self._worker.start()

    # ------------------------------------------------------------- buckets
    def buckets(self) -> list:
        """Padded batch sizes this server captures: powers of two from 1
        up to (at least) ``batch_limit``."""
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
    def submit(self, x, deadline: Optional[float] = None,
               trace: Optional[_tracectx.TraceContext] = None
               ) -> ServingRequest:
        """Queue one request. ``x``: [n, ...features] with n <=
        ``batch_limit``; ``deadline``: seconds from now (overrides
        ``default_deadline``); ``trace``: the caller's
        :class:`~deeplearning4j_tpu_torch.profiler.tracecontext.
        TraceContext` (the ingress passes the request's — minted fresh
        when absent). Raises the structured admission errors instead of
        ever blocking the caller; rejections carry a ``trace_id``
        attribute and a terminal span."""
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
                # a novel shape would capture under the steady-state
                # watchdog (warmup=0): past replica_timeout that reads as
                # a hung replica and feeds the breaker
                raise ValueError(
                    f"request feature shape {fshape} was not warmed "
                    f"(warmed: {self._warm_shapes}) — call "
                    "warmup([shape]) before serving it")
        now = time.monotonic()
        dl = self.default_deadline if deadline is None else deadline
        if self._traffic_capture is not None:
            # after validation (only servable traffic is worth replaying)
            # but BEFORE admission: a request shed under overload is
            # exactly the traffic a chaos replay wants to reproduce
            self._traffic_capture.record(x, deadline=dl)
        req = ServingRequest(x, now + dl if dl is not None else None, now,
                             trace=trace)
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
            # an admission rejection IS the request's terminal outcome:
            # resolve it (the serve:terminal span) and stamp the trace id
            # on the error so the caller can correlate
            e.trace_id = req.trace.trace_id
            req._resolve(error=e)
            _tracectx.record_span(
                "serve:admission", req.trace.child(), req._t0_us,
                _prof.now_us() - req._t0_us,
                args={"outcome": type(e).__name__, "server": self.name})
            raise
        _tracectx.record_span(
            "serve:admission", req.trace.child(), req._t0_us,
            _prof.now_us() - req._t0_us,
            args={"outcome": "admitted", "server": self.name,
                  "rows": req.n})
        return req

    def output(self, x, timeout: float = 30.0,
               deadline: Optional[float] = None) -> np.ndarray:
        """Synchronous single-request API."""
        return self.submit(x, deadline=deadline).get(timeout)

    def _count(self, outcome: str):
        # _cond wraps an RLock: callers already holding it re-enter
        with self._cond:
            self.counts[outcome] += 1
        REQUESTS.labels(outcome=outcome).inc()

    # ------------------------------------------------------------- warmup
    def warmup(self, shapes: Iterable[Sequence[int]], strict: bool = False,
               cost=None) -> "ModelServer":
        """Capture every bucket x feature shape BEFORE taking traffic:
        ``shapes`` are per-request feature shapes WITHOUT the leading
        batch dim, e.g. ``[(128,), (512,)]`` for token rows. On the card
        each becomes one CUDA graph of the forward and head; on the CPU
        each runs once. Each signature is reported to the churn detector;
        :meth:`recompiles_after_warmup` counts new ones since. Then flips
        ``ready`` true.

        First the serving lint runs with ``check_cache=True`` (the
        DL4J-W112 disk-tier check) and ``cost`` (a CostSpec, chip name or
        dict: the E121 bucket-peak and E122 capacity checks):
        ``strict=True`` raises on an E-code, otherwise each finding warns.
        With the disk tier configured, the shapes the model's manifest
        names are warmed too."""
        shapes = [tuple(int(d) for d in s) for s in shapes]
        report = self.validate(shapes=shapes, check_cache=True, cost=cost)
        if strict:
            report.raise_if_errors()
        for d in report.diagnostics:
            warnings.warn(f"serving config: {d.code}: {d.message}",
                          stacklevel=2)
        if _cc.cache_dir() is not None:
            for s in _cc.served_manifest_shapes(self.model):
                if s not in shapes:
                    shapes.append(s)
        elapsed = self._compile_buckets(shapes)
        WARMUP_SECONDS.set(elapsed)
        with self._cond:    # the serve thread reads both fields
            for s in shapes:
                if s not in self._warm_shapes:
                    self._warm_shapes.append(s)
            self._warmed = True
        logger.info("serving warmup: %d bucket(s) x %d shape(s) in %.3fs "
                    "on %s (%d captured)", len(self.buckets()), len(shapes),
                    elapsed, self.device, self._dispatch.warmed_signatures())
        return self

    def _compile_buckets(self, shapes) -> float:
        """Capture every bucket x feature shape and re-base the
        zero-recompile baselines. Returns the wall seconds spent."""
        t0 = time.perf_counter()
        for shape in shapes:
            for b in self.buckets():
                self._forward_raw(
                    np.zeros((b,) + tuple(shape), self.input_dtype),
                    capture=True)
        with self._cond:
            self._warm_sig_count = self._churn.signature_count(
                "serving:forward", owner=self)
            self._warm_captures = self._dispatch.captures()
        return time.perf_counter() - t0

    def recompiles_after_warmup(self) -> int:
        """Distinct forward signatures seen since the last ``warmup()``
        — the steady-state pin is 0."""
        if not self._warmed:
            return 0
        return self._churn.signature_count("serving:forward",
                                           owner=self) - self._warm_sig_count

    def validate(self, shapes=None, hbm_gb=None, check_cache: bool = False,
                 cost=None):
        """Static serving-config lint: the bucket ladder x HBM
        (``analysis.serving``: E110, E111, W110) plus any W201 churn
        findings recorded for this server. ``check_cache=True`` (what
        ``warmup`` passes) adds the DL4J-W112 disk-tier check. ``cost``
        (CostSpec / chip name / dict) adds the liveness-based E121
        bucket-peak and E122 capacity checks over this server's bucket
        ladder — declare ``qps=``/``p99_ms=`` on the CostSpec to size the
        fleet. One card serves, so no mesh is declared. Makes no
        tensor."""
        from deeplearning4j_tpu_torch.analysis import cost as _cost
        from deeplearning4j_tpu_torch.analysis.serving import lint_serving
        report = lint_serving(self.model, self.buckets(), shapes=shapes,
                              hbm_gb=hbm_gb, input_dtype=self.input_dtype,
                              check_cache=check_cache,
                              extra=self._churn.diagnostics_for(owner=self))
        sd = getattr(self.model, "_samediff", None)
        if sd is not None:      # samediff_forward's stamp: the graph lints
            from deeplearning4j_tpu_torch.analysis import analyze
            report.extend(analyze(sd).diagnostics)
        if cost is not None:
            spec = _cost.CostSpec.coerce(cost)
            spec = _cost.CostSpec(
                chip=spec.chip, qps=spec.qps, p99_ms=spec.p99_ms,
                replicas=spec.replicas, mfu_target=spec.mfu_target,
                buckets=spec.buckets or tuple(self.buckets()),
                steps_per_dispatch=spec.steps_per_dispatch,
                prefetch=spec.prefetch, precision=spec.precision)
            # serving surface: only the serving-relevant codes — the
            # training-step E120/W120/W121 family belongs to fit-side
            # validate(), not a replica's bucket ladder
            target = sd if sd is not None else self.model
            report.extend(d for d in _cost.lint_cost(target, spec)
                          if d.code in ("DL4J-E121", "DL4J-E122"))
        return report

    def captures_after_warmup(self) -> int:
        """CUDA-graph captures since the last ``warmup()`` (0 on the CPU,
        which never captures); agrees with
        :meth:`recompiles_after_warmup` on the card."""
        if not self._warmed:
            return 0
        return self._dispatch.captures() - self._warm_captures

    # ------------------------------------------------------- health surface
    @property
    def ready(self) -> bool:
        """True once warmed and still admitting (what /readyz serves)."""
        return (self._warmed and not self._draining and not self._closed
                and not self._drain_requested.is_set()
                and self._worker.is_alive()
                and self.breaker.admit())

    @property
    def healthy(self) -> bool:
        """True unless the breaker is open or the serve loop died (what
        /healthz serves)."""
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
            "recompiles_after_warmup": self.recompiles_after_warmup(),
            "latency_p50": LATENCY.quantile(0.5),
            "latency_p99": LATENCY.quantile(0.99),
        }

    _SHED_OUTCOMES = ("shed_overload", "shed_deadline", "shed_draining",
                      "rejected_unhealthy")

    def load_hints(self) -> dict:
        """Structured autoscaling / load-balancer hints (what the
        ingress serves at ``GET /v1/load``): queue depth and fill, shed
        rate over this server's terminal outcomes, breaker state, and
        mean bucket occupancy. Mirrored to the
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
            "recompiles_after_warmup": self.recompiles_after_warmup(),
        }

    # ------------------------------------------------------------ serve loop
    def _serve(self):
        try:
            while True:
                if self._preemption is not None \
                        and self._preemption.requested(self._batches):
                    self._drain_requested.set()
                with self._cond:
                    if self._closed or self._drain_requested.is_set():
                        return
                    if not self._dq:
                        # bounded wait so drain/preemption/breaker checks
                        # run even on an idle server
                        self._cond.wait(0.05)
                        continue
                if not self.breaker.allow_dispatch():
                    # failing fast: do not dispatch, but keep shedding
                    # requests whose deadlines expire while we wait
                    self._shed_expired()
                    time.sleep(0.005)
                    continue
                t0_us = _prof.now_us()
                batch = self._build_batch()
                if batch:
                    # the coalesce wait, attributed to the batch's trace
                    _tracectx.record_span(
                        "serve:coalesce", batch[0].trace.child(), t0_us,
                        _prof.now_us() - t0_us,
                        args={"requests": len(batch), "server": self.name})
                    self._dispatch_batch(batch)
        except BaseException as e:
            with self._cond:
                self._died = True
            # capture the ring + trace + metrics before the queued-request
            # failures scroll everything away
            _flightrec.get_flight_recorder().dump("serve_loop_death",
                                                  exc=e)
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

    def _dispatch_batch(self, batch: list):
        total = sum(r.n for r in batch)
        bucket = self._bucket_for(total)
        t0_us = _prof.now_us()
        if _prof.tracing_enabled():
            # per-request queue-wait spans: enqueue -> popped into this
            # batch (each under its own request's trace)
            for req in batch:
                _tracectx.record_span("serve:queue", req.trace.child(),
                                      req._t0_us, t0_us - req._t0_us,
                                      args={"rows": req.n})
        # ONE dispatch span serves the whole coalesced batch: it lives in
        # batch[0]'s trace and links to every member request's root span
        batch_ctx = batch[0].trace.child()
        _flightrec.get_flight_recorder().record(
            "serving:dispatch", server=self.name, rows=total,
            bucket=bucket, requests=len(batch),
            trace_id=batch_ctx.trace_id)
        err: Optional[BaseException] = None
        try:
            # inside the try: ANY failure building or running the batch
            # must resolve its requests, never kill the serve loop
            feats = np.concatenate([r.features for r in batch], axis=0)
            with _tracectx.use(batch_ctx):
                out = self._forward(feats)
        except Exception as e:
            err = e
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
                    LATENCY.observe(now - req.enqueued_at,
                                    exemplar=req.trace.trace_id)
                    self._count("completed")
                pos += req.n
        _tracectx.record_span(
            "serve:dispatch", batch_ctx, t0_us, _prof.now_us() - t0_us,
            args={"server": self.name, "rows": total, "bucket": bucket,
                  "requests": len(batch),
                  "outcome": ("completed" if err is None
                              else type(err).__name__)},
            links=[r.trace for r in batch])
        OCCUPANCY.observe(total / float(bucket))
        with self._cond:    # stats() readers race this increment
            self._batches += 1
            self._occ_sum += total / float(bucket)
            self._occ_n += 1
        BATCHES.inc()

    # ------------------------------------------------------------- forward
    def _forward(self, feats: np.ndarray):
        """One coalesced batch (live rows only), padded to its bucket,
        through the supervised forward with bounded retry after a failure
        or timeout. On one card a retry runs on the same card."""
        total = int(feats.shape[0])
        bucket = self._bucket_for(total)
        padded = feats
        if bucket > total:
            padded = np.concatenate(
                [feats, np.zeros((bucket - total,) + feats.shape[1:],
                                 feats.dtype)], axis=0)
        last = None
        attempts = 0
        ctx = _tracectx.current()   # the dispatch span's context
        for _ in range(self.max_retries + 1):
            attempts += 1
            t_attempt = _prof.now_us()
            if not self._warmed:
                # pre-warmup traffic legitimately runs cold; the
                # zero-leniency steady-state watchdog must not read it as
                # a hung replica and feed the breaker
                self._watchdog.begin_attempt(1)
            try:
                out = self._watchdog.run(
                    lambda p=padded: self._forward_once(p),
                    self._batches + 1)
                return _slice_rows(out, 0, total)
            except (Exception, DispatchTimeoutError) as e:
                last = e
                REPLICA_FAILURES.inc()
                rec = _flightrec.get_flight_recorder()
                rec.record("serving:dispatch_failure", server=self.name,
                           attempt=attempts, error=type(e).__name__,
                           detail=str(e)[:256])
                if isinstance(e, DispatchTimeoutError):
                    # a hung replica is a prime flight-recorder trigger
                    # (rate-limited — a retry storm makes one bundle)
                    rec.dump("dispatch_timeout", exc=e)
                _tracectx.record_span(
                    "serve:retry",
                    ctx.child() if ctx is not None else None,
                    t_attempt, _prof.now_us() - t_attempt,
                    args={"attempt": attempts,
                          "error": type(e).__name__})
                warnings.warn(
                    f"serving dispatch failure (attempt {attempts}): "
                    f"{type(e).__name__}: {e} — retrying", stacklevel=2)
        raise InferenceFailedError(attempts, last)

    def _forward_once(self, feats: np.ndarray):
        if self._faults is not None:
            self._faults.serving_forward(self._batches + 1,
                                         [self.device.index or 0])
        return self._forward_raw(feats)

    def _manifest_name(self, args):
        """The disk tier's name of a forward capture: the per-request
        feature shape and dtype (the bucket is the leading dim)."""
        x = args[0]
        return self.model, "serving:forward", {
            "shape": list(x.shape[1:]), "dtype": _cc._dtype_name(x.dtype)}

    def _device_forward(self, x):
        """What one graph holds: the forward and the head."""
        out = _normalize_out(self._fwd(x))
        if self._head_fn is not None:
            out = _map_arrays(self._head_fn, out)
        return out

    def _forward_raw(self, feats: np.ndarray, capture: bool = False):
        fp = (str(self.device), _churn.array_fingerprint(feats))
        self._churn.record("serving:forward", fp, owner=self)
        _flightrec.get_flight_recorder().record(
            "serving:forward", server=self.name, device=fp[0],
            signature=str(fp[1]))
        # the H2D copy stays outside the graph: the dispatch copies the
        # tensor into the graph's static input
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)
        with torch.inference_mode():
            if capture:
                self._dispatch.warm(x)
            host = _to_host(self._dispatch(x))   # THE per-batch D2H copy
        D2H_BYTES.inc(_nbytes(host))
        return host

    # --------------------------------------------------------------- drain
    def drain(self, timeout: float = None) -> "ModelServer":
        """Stop admissions, let the in-flight batch complete, fail every
        queued-but-undispatched request with the retriable
        :class:`ServerDrainingError`, and stop the serve loop. Safe to
        call from any thread and idempotent; SIGTERM triggers the same
        path through the preemption seam."""
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
        """Drain, then refuse every later submit, drop the captured
        graphs (their pool's memory goes back to the allocator) and the
        references to the model and its forward, and release the
        preemption handlers: a retired registry version closes so, and
        frees its graphs and weights. Idempotent; also the
        context-manager exit."""
        if self._closed:
            return
        self.drain()
        with self._cond:
            self._closed = True
        if not self._worker.is_alive():
            # a serve loop stuck past the drain timeout may still run the
            # forward: then it all stays. captures_after_warmup() keeps
            # its value
            with self._cond:
                self._warm_captures -= self._dispatch.release()
                self.model = self._fwd = None
        if self._preemption_installed:
            uninstall = getattr(self._preemption, "uninstall", None)
            if uninstall is not None:
                uninstall()
            self._preemption_installed = False

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc):
        self.close()
