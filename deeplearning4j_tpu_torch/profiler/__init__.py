"""Profiler: the process-wide Counter/Gauge/Histogram metrics registry
(:mod:`.metrics`), the span tracer with Chrome-trace export
(:mod:`.tracer`), W3C-``traceparent`` request tracing
(:mod:`.tracecontext`), the always-on crash flight recorder
(:mod:`.flightrec`), ``ProfilingMode`` (:mod:`.modes`) and the
instrumented locks with their lock-order witness (:mod:`.locks`)."""

from deeplearning4j_tpu_torch.profiler.flightrec import (FlightRecorder,
                                                         get_flight_recorder)
from deeplearning4j_tpu_torch.profiler.locks import (
    InstrumentedCondition, InstrumentedLock, InstrumentedRLock,
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
