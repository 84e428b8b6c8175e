"""Profiler: the process-wide Counter/Gauge/Histogram metrics registry
(:mod:`.metrics`), the span tracer with Chrome-trace export
(:mod:`.tracer`), W3C-``traceparent`` request tracing
(:mod:`.tracecontext`), the always-on crash flight recorder
(:mod:`.flightrec`), ``ProfilingMode`` (:mod:`.modes`), the
instrumented locks and queue with their lock-order witness
(:mod:`.locks`), and the fit loops' data-wait-against-dispatch split
(:func:`iter_with_data_wait`, :func:`timed_region`,
:func:`data_overlap_ratio`; the JAX package's ``profiler/__init__.py``).

Everything records only while :func:`instrumentation_active` (tracing on
or a ``ProfilingMode`` other than OFF): off, a region costs one flag and
one enum read."""

import time as _time

from deeplearning4j_tpu_torch.profiler.flightrec import (FlightRecorder,
                                                         get_flight_recorder)
from deeplearning4j_tpu_torch.profiler.locks import (
    InstrumentedCondition, InstrumentedLock, InstrumentedQueue,
    InstrumentedRLock,
    LockOrderInversionError, WitnessedLock, disable_lock_order_witness,
    enable_lock_order_witness, lock_order_edges)
from deeplearning4j_tpu_torch.profiler.metrics import (Counter, Gauge,
                                                       Histogram,
                                                       MetricsRegistry,
                                                       get_registry)
from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                     get_profiling_mode,
                                                     set_profiling_mode)
from deeplearning4j_tpu_torch.profiler.tracecontext import (
    TraceContext, current as current_trace, record_span, span,
    spans_for_trace)
from deeplearning4j_tpu_torch.profiler.tracer import (SpanTracer,
                                                      disable_tracing,
                                                      enable_tracing,
                                                      get_tracer, now_us,
                                                      trace_span,
                                                      tracing_enabled)


def instrumentation_active() -> bool:
    """True when instrumentation should record: tracing is on or the
    profiling mode is not OFF."""
    return tracing_enabled() or get_profiling_mode() is not ProfilingMode.OFF


def observe_region(span_name: str, metric_name: str, help_text: str,
                   started_us: float, seconds: float, **args) -> None:
    """Record one measured region: a histogram sample and, while tracing,
    a span on the tracer's timeline."""
    get_registry().histogram(metric_name, help_text).observe(seconds)
    if tracing_enabled():
        get_tracer().add_event(span_name, started_us, seconds * 1e6,
                               args or None)


class timed_region:
    """Context manager: time a region on the host clock and feed it to
    :func:`observe_region`; does nothing while instrumentation is off.
    On the card a region around a dispatch measures the host's dispatch
    time (the work is queued, not finished)."""

    __slots__ = ("span_name", "metric_name", "help_text", "args", "_t0",
                 "_t0u")

    def __init__(self, span_name: str, metric_name: str, help_text: str,
                 **args):
        self.span_name = span_name
        self.metric_name = metric_name
        self.help_text = help_text
        self.args = args
        self._t0 = None

    def __enter__(self):
        if instrumentation_active():
            self._t0u, self._t0 = now_us(), _time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is not None:
            observe_region(self.span_name, self.metric_name, self.help_text,
                           self._t0u, _time.perf_counter() - self._t0,
                           **self.args)
            self._t0 = None
        return False


_SENTINEL = object()

#: dispatch time as a share of dispatch + data wait: 1.0 = the input
#: pipeline hidden behind the dispatches, low = the card starves for data
_OVERLAP_RATIO = get_registry().gauge(
    "dl4j_train_overlap_ratio",
    "Train dispatch time as a fraction of dispatch + data-wait time "
    "(1.0 = input pipeline fully overlapped with compute; low values = "
    "the card is starving for data)")


def data_overlap_ratio():
    """Cumulative dispatch / (dispatch + data wait) from the fit loops'
    two histograms (``dl4j_train_step_seconds``,
    ``dl4j_train_data_wait_seconds``); None before any instrumented fit
    ran."""
    reg = get_registry()
    step = reg.get("dl4j_train_step_seconds")
    wait = reg.get("dl4j_train_data_wait_seconds")
    s = step.sum if step is not None else 0.0
    w = wait.sum if wait is not None else 0.0
    total = s + w
    return None if total == 0 else s / total


def iter_with_data_wait(batches):
    """Yield from ``batches``, each pull timed as ``train:data_wait``
    (histogram ``dl4j_train_data_wait_seconds`` and span): the data-wait
    half of the split the fit loops report (``dl4j_train_overlap_ratio``
    follows the running ratio). The final, exhausted pull is not
    recorded."""
    it = iter(batches)
    while True:
        active = instrumentation_active()
        if active:
            t0u, t0 = now_us(), _time.perf_counter()
        ds = next(it, _SENTINEL)
        if ds is _SENTINEL:
            return
        if active:
            observe_region("train:data_wait", "dl4j_train_data_wait_seconds",
                           "Host wait for the next training batch", t0u,
                           _time.perf_counter() - t0)
            ratio = data_overlap_ratio()
            if ratio is not None:
                _OVERLAP_RATIO.set(ratio)
        yield ds
