"""Profiler: the process-wide Counter/Gauge/Histogram metrics registry
(``profiler.metrics``)."""

from deeplearning4j_tpu_torch.profiler.metrics import (Counter, Gauge,
                                                       Histogram,
                                                       MetricsRegistry,
                                                       get_registry)
