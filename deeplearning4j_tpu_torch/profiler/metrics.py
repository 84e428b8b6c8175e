"""Metrics registry: counters, gauges, fixed-bucket histograms with label
support and Prometheus text-format exposition.

A copy of the JAX package's jax-free ``profiler/metrics.py`` (the port
imports nothing of that package). Every subsystem reports into ONE
process-wide registry (:func:`get_registry`); ``exposition()`` renders
it in Prometheus text format (v0.0.4) for any scraper.

Semantics follow prometheus_client (not imported — the environment is
egress-free and the dependency is unnecessary):

- ``Counter``: monotonically increasing; ``inc(v)`` with v >= 0.
- ``Gauge``: ``set``/``inc``/``dec``.
- ``Histogram``: fixed cumulative buckets chosen at creation, plus
  ``_sum``/``_count`` series; ``observe(v)``.
- Labels: declare ``labelnames`` at creation, then ``m.labels(op="add")``
  returns (creating on first use) the child to operate on. A metric with
  labelnames cannot be operated on directly; one without them can.

All operations are thread-safe; hot-path cost is one lock + dict/float
update.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# latency-shaped default: 100us .. 10s (seconds)
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _labels_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Base: a named family, optionally labelled (children per label set)."""

    typ = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        if not self.labelnames:
            self._init_value()

    def _init_value(self):
        raise NotImplementedError

    def _child(self) -> "_Metric":
        c = type(self)(self.name, self.help)
        return c

    def children(self) -> Dict[Tuple[str, ...], "_Metric"]:
        """Snapshot of the per-label-set children (empty for an
        unlabelled family). Lets readers — the analysis CLI's churn
        report, tests — enumerate which label sets exist without parsing
        the text exposition."""
        with self._lock:
            return dict(self._children)

    def labels(self, *values, **kv) -> "_Metric":
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            if set(kv) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {tuple(kv)}")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        with self._lock:
            c = self._children.get(values)
            if c is None:
                c = self._children[values] = self._child()
            return c

    def _check_unlabelled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "use .labels(...) first")

    def _samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """[(suffix, extra_labels, value)] for one (child) metric — a
        consistent snapshot taken under the metric's own lock (a scrape
        racing observe() must never emit non-monotone histogram buckets).
        Histograms may append a 4th element: an ``(exemplar_id, value)``
        pair rendered as an OpenMetrics exemplar when negotiated."""
        raise NotImplementedError

    def expose(self, openmetrics: bool = False) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.typ}"]
        with self._lock:
            items = (list(self._children.items()) if self.labelnames
                     else [((), self)])
        # child _samples() acquire their own lock — called OUTSIDE the
        # family lock above (for an unlabelled family, child IS self)
        for lvals, child in items:
            for sample in child._samples():
                suffix, extra, value = sample[0], sample[1], sample[2]
                names = list(self.labelnames) + list(extra)
                vals = list(lvals) + [extra[k] for k in extra]
                line = (f"{self.name}{suffix}"
                        f"{_labels_str(names, vals)} "
                        f"{_format_value(value)}")
                if openmetrics and len(sample) > 3 and sample[3] is not None:
                    # OpenMetrics exemplar: ties this bucket back to one
                    # concrete trace (tier-1 <-> tier-2 correlation)
                    ex_id, ex_val = sample[3]
                    line += (f' # {{trace_id="{_escape_label(ex_id)}"}} '
                             f"{_format_value(ex_val)}")
                lines.append(line)
        return "\n".join(lines)


class Counter(_Metric):
    """Monotonic counter (ref: prometheus counter semantics)."""

    typ = "counter"

    def _init_value(self):
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self._check_unlabelled()
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        self._check_unlabelled()
        with self._lock:
            return self._value

    def _samples(self):
        with self._lock:
            return [("", {}, self._value)]


class Gauge(_Metric):
    """Settable instantaneous value."""

    typ = "gauge"

    def _init_value(self):
        self._value = 0.0

    def set(self, value: float) -> None:
        self._check_unlabelled()
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._check_unlabelled()
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        self._check_unlabelled()
        with self._lock:
            return self._value

    def _samples(self):
        with self._lock:
            return [("", {}, self._value)]


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (+Inf bucket implicit)."""

    typ = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames)

    def _init_value(self):
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        # one exemplar per bucket (the latest observation that carried
        # one) — bounded by construction: len(buckets)+1 slots, ever
        self._exemplars: List[Optional[Tuple[str, float]]] = \
            [None] * (len(self.buckets) + 1)

    def _child(self):
        return Histogram(self.name, self.help, (), self.buckets)

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        """Record one observation. ``exemplar`` (typically a trace_id)
        is retained per owning bucket — latest wins, so retention is
        bounded at one exemplar per bucket — and rendered as an
        OpenMetrics ``# {trace_id="..."}`` annotation when the scrape
        negotiates the OpenMetrics exposition."""
        self._check_unlabelled()
        value = float(value)
        idx = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                self._exemplars[idx] = (str(exemplar)[:128], value)

    @property
    def count(self) -> int:
        self._check_unlabelled()
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        self._check_unlabelled()
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (0 <= q <= 1) from the cumulative
        buckets, linearly interpolated within the owning bucket —
        prometheus ``histogram_quantile`` semantics, computed locally
        so the serving stats / bench probes need no PromQL engine.
        Returns None for an empty histogram; observations landing in
        the +Inf bucket clamp to the highest finite bound."""
        self._check_unlabelled()
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return None
        rank = q * total
        cum = 0
        lo = 0.0
        for bound, c in zip(self.buckets, counts):
            if c and cum + c >= rank:
                frac = (rank - cum) / c
                return lo + (bound - lo) * max(min(frac, 1.0), 0.0)
            cum += c
            lo = bound
        return self.buckets[-1]

    def _samples(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            exemplars = list(self._exemplars)
        out = []
        cum = 0
        for i, (bound, c) in enumerate(zip(self.buckets, counts)):
            cum += c
            out.append(("_bucket", {"le": _format_value(bound)}, cum,
                        exemplars[i]))
        out.append(("_bucket", {"le": "+Inf"}, total, exemplars[-1]))
        out.append(("_sum", {}, s))
        out.append(("_count", {}, total))
        return out


class MetricsRegistry:
    """Named metric families with get-or-create semantics.

    ``registry.counter(name, ...)`` returns the existing family when the
    name is already registered (validating the type matches), so every
    call site can declare the metrics it needs without coordination —
    the same pattern as prometheus_client's default REGISTRY.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name} already registered as {m.typ}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def exposition(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format 0.0.4 (what /metrics
        serves). ``openmetrics=True`` renders the OpenMetrics dialect
        instead — histogram bucket lines carry their retained
        ``# {trace_id="..."}`` exemplars and the body ends with
        ``# EOF`` — for scrapers that negotiate it via ``Accept:
        application/openmetrics-text``."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        if not metrics:
            return "# EOF\n" if openmetrics else ""
        body = "\n".join(m.expose(openmetrics=openmetrics) for m in metrics)
        return body + ("\n# EOF\n" if openmetrics else "\n")


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """Process-wide registry singleton (what ``GET /metrics`` serves)."""
    return _REGISTRY
