"""Declarative SLOs with multi-window burn-rate gates.

The registry's rollout gate and the warmup verdicts are point-in-time
checks; an operator still has to eyeball ``/metrics`` to decide "is the
fleet healthy *enough*". This module turns the existing counter and
histogram series into declarative objectives evaluated the way SRE
burn-rate alerting does:

- :class:`SLOSpec` — one named objective over any subset of criteria:
  a latency bound at an objective quantile ("99% of requests under
  250ms"), a shed-rate ceiling, an availability target (non-``failed``
  terminal outcomes), and a step-time regression bound against a
  recorded baseline ("fit steps within 1.2x of the bench baseline").
- :class:`SLOEngine` — keeps a bounded ring of (timestamp, metric
  snapshot) pairs and, per spec, computes the **burn rate** over a
  fast and a slow window: ``burn = bad_fraction / allowed_fraction``
  (burn 1.0 = consuming error budget exactly at the rate that exhausts
  it by period end). A spec is *failing* only when burn exceeds the
  threshold in BOTH windows — the standard multi-window rule: the slow
  window filters blips, the fast window makes recovery visible
  immediately after a drain, so the gate flips back quickly.
  Each evaluation exports ``dl4j_slo_burn_rate{slo,window}``.
- :class:`SLOGate` — a callable verdict usable anywhere a canary judge
  fits: ``ModelRegistry.roll(..., judge=gate)`` style checks, CI
  thresholds, or the ingress ``GET /v1/slo`` endpoint.

Everything reads the process registry (or an injected one) — no new
instrumentation is required at the measured sites, and the injectable
``clock`` keeps window arithmetic deterministic under test.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.profiler import metrics as _metrics
from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock

# terminal outcomes counted as load shedding (mirrors
# ModelServer._SHED_OUTCOMES; duplicated here so the SLO layer does not
# import the serving stack it judges)
SHED_OUTCOMES = ("shed_overload", "shed_deadline", "shed_draining",
                 "rejected_unhealthy")

DEFAULT_LATENCY_METRIC = "dl4j_serving_latency_seconds"
DEFAULT_REQUESTS_METRIC = "dl4j_serving_requests_total"
DEFAULT_STEP_METRIC = "dl4j_train_iteration_seconds"


class SLOSpec:
    """One named objective. Any subset of the criteria may be set; the
    spec's burn rate is the max over its active criteria.

    - ``latency_bound`` (seconds) at ``objective`` (e.g. 0.99): the
      fraction of requests slower than the bound, divided by the
      allowed fraction ``1 - objective``.
    - ``shed_rate``: ceiling on the shed fraction of terminal outcomes;
      burn = shed_fraction / ceiling.
    - ``availability``: target fraction of non-``failed`` outcomes;
      burn = failed_fraction / (1 - availability).
    - ``step_time_baseline`` (seconds) with ``step_time_regression``
      factor: burn = windowed_mean_step / (baseline * regression).

    ``windows`` is (fast, slow) in seconds.
    """

    __slots__ = ("name", "objective", "latency_bound", "latency_metric",
                 "shed_rate", "availability", "requests_metric",
                 "step_time_baseline", "step_time_regression",
                 "step_metric", "windows")

    def __init__(self, name: str, objective: float = 0.99,
                 latency_bound: Optional[float] = None,
                 latency_metric: str = DEFAULT_LATENCY_METRIC,
                 shed_rate: Optional[float] = None,
                 availability: Optional[float] = None,
                 requests_metric: str = DEFAULT_REQUESTS_METRIC,
                 step_time_baseline: Optional[float] = None,
                 step_time_regression: float = 1.2,
                 step_metric: str = DEFAULT_STEP_METRIC,
                 windows: Tuple[float, float] = (60.0, 600.0)):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if shed_rate is not None and not 0.0 < shed_rate <= 1.0:
            raise ValueError(f"shed_rate ceiling must be in (0, 1], "
                             f"got {shed_rate}")
        if availability is not None and not 0.0 < availability < 1.0:
            raise ValueError(f"availability must be in (0, 1), "
                             f"got {availability}")
        if len(windows) != 2 or windows[0] >= windows[1]:
            raise ValueError(f"windows must be (fast, slow) with "
                             f"fast < slow, got {windows}")
        self.name = name
        self.objective = float(objective)
        self.latency_bound = latency_bound
        self.latency_metric = latency_metric
        self.shed_rate = shed_rate
        self.availability = availability
        self.requests_metric = requests_metric
        self.step_time_baseline = step_time_baseline
        self.step_time_regression = float(step_time_regression)
        self.step_metric = step_metric
        self.windows = (float(windows[0]), float(windows[1]))

    def metric_names(self) -> List[str]:
        names = []
        if self.latency_bound is not None:
            names.append(self.latency_metric)
        if self.shed_rate is not None or self.availability is not None:
            names.append(self.requests_metric)
        if self.step_time_baseline is not None:
            names.append(self.step_metric)
        return names


def _snapshot_metric(metric) -> Optional[dict]:
    """Capture one family's windowable state: cumulative histogram
    counts (summed over children) or per-child counter values."""
    if isinstance(metric, _metrics.Histogram):
        children = list(metric.children().values()) or [metric]
        bounds = metric.buckets
        counts = [0.0] * (len(bounds) + 1)
        total, s = 0.0, 0.0
        for child in children:
            with child._lock:
                for i, c in enumerate(child._counts):
                    counts[i] += c
                total += child._count
                s += child._sum
        return {"type": "histogram", "bounds": bounds, "counts": counts,
                "count": total, "sum": s}
    if isinstance(metric, _metrics.Counter):
        if metric.labelnames:
            children = {lvals: child.value for lvals, child
                        in metric.children().items()}
        else:
            children = {(): metric.value}
        return {"type": "counter", "children": children}
    return None


class SLOEngine:
    """Evaluate :class:`SLOSpec` burn rates from registry snapshots.

    Every :meth:`evaluate` call appends one (now, snapshot) sample to a
    bounded ring and computes each spec's burn over its fast and slow
    windows by differencing against the newest sample at least
    window-seconds old (falling back to the oldest sample while the
    ring is still shorter than the window — conservative: early burn
    reflects all data seen so far). Results are exported as
    ``dl4j_slo_burn_rate{slo,window}`` on the same registry.
    """

    def __init__(self, specs: Sequence[SLOSpec],
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 clock=time.monotonic, max_samples: int = 512,
                 threshold: float = 1.0):
        self.specs = list(specs)
        self.registry = registry or _metrics.get_registry()
        self.threshold = float(threshold)
        self._clock = clock
        self._max_samples = int(max_samples)
        self._samples: List[Tuple[float, Dict[str, dict]]] = []
        self._lock = InstrumentedLock("slo:engine")
        self._burn = self.registry.gauge(
            "dl4j_slo_burn_rate",
            "Error-budget burn rate per SLO and evaluation window "
            "(1.0 = consuming budget exactly at the exhaustion rate; "
            "failing = above threshold in BOTH windows)",
            labelnames=("slo", "window"))
        self._names = sorted({n for s in self.specs
                              for n in s.metric_names()})

    # --------------------------------------------------------- sampling
    def _capture(self) -> Dict[str, dict]:
        snap = {}
        for name in self._names:
            metric = self.registry.get(name)
            if metric is None:
                continue
            data = _snapshot_metric(metric)
            if data is not None:
                snap[name] = data
        return snap

    @staticmethod
    def _reference(samples, now: float, window: float
                   ) -> Optional[Tuple[float, Dict[str, dict]]]:
        """Newest sample at least ``window`` old; else the oldest."""
        ref = None
        for t, snap in samples:
            if now - t >= window:
                ref = (t, snap)
            else:
                break
        if ref is None and samples:
            ref = samples[0]
        return ref

    # ------------------------------------------------------------ burns
    @staticmethod
    def _hist_delta(cur: Optional[dict], ref: Optional[dict]):
        if cur is None or cur.get("type") != "histogram":
            return None
        counts = list(cur["counts"])
        count, s = cur["count"], cur["sum"]
        if ref is not None and ref.get("type") == "histogram" \
                and len(ref["counts"]) == len(counts):
            counts = [c - r for c, r in zip(counts, ref["counts"])]
            count -= ref["count"]
            s -= ref["sum"]
        return {"bounds": cur["bounds"], "counts": counts,
                "count": count, "sum": s}

    @staticmethod
    def _counter_delta(cur: Optional[dict], ref: Optional[dict]
                       ) -> Dict[Tuple, float]:
        if cur is None or cur.get("type") != "counter":
            return {}
        refc = (ref or {}).get("children", {}) \
            if (ref or {}).get("type") == "counter" else {}
        return {k: v - refc.get(k, 0.0)
                for k, v in cur["children"].items()}

    def _spec_burn(self, spec: SLOSpec, cur: Dict[str, dict],
                   ref: Optional[Dict[str, dict]]) -> Dict[str, float]:
        ref = ref or {}
        burns: Dict[str, float] = {}
        if spec.latency_bound is not None:
            h = self._hist_delta(cur.get(spec.latency_metric),
                                 ref.get(spec.latency_metric))
            if h is not None and h["count"] > 0:
                # observations above the bound = total minus cumulative
                # count at the smallest bucket bound >= the SLO bound
                cum = 0.0
                covered = 0.0
                matched = False
                for bound, c in zip(h["bounds"], h["counts"]):
                    cum += c
                    if bound >= spec.latency_bound:
                        covered, matched = cum, True
                        break
                if not matched:
                    covered = cum   # bound above all buckets: +Inf bad
                bad_frac = max(h["count"] - covered, 0.0) / h["count"]
                burns["latency"] = bad_frac / (1.0 - spec.objective)
        outcomes = None
        if spec.shed_rate is not None or spec.availability is not None:
            deltas = self._counter_delta(cur.get(spec.requests_metric),
                                         ref.get(spec.requests_metric))
            outcomes = {(k[0] if k else ""): v for k, v in deltas.items()}
        if outcomes:
            total = sum(outcomes.values())
            if total > 0:
                if spec.shed_rate is not None:
                    shed = sum(outcomes.get(o, 0.0) for o in SHED_OUTCOMES)
                    burns["shed"] = (shed / total) / spec.shed_rate
                if spec.availability is not None:
                    failed = outcomes.get("failed", 0.0)
                    burns["availability"] = (failed / total) / \
                        (1.0 - spec.availability)
        if spec.step_time_baseline is not None:
            h = self._hist_delta(cur.get(spec.step_metric),
                                 ref.get(spec.step_metric))
            if h is not None and h["count"] > 0:
                mean = h["sum"] / h["count"]
                burns["step_time"] = mean / (spec.step_time_baseline *
                                             spec.step_time_regression)
        return burns

    def burn_over(self, seconds: float) -> Dict[str, float]:
        """One-off burn per spec over an arbitrary lookback window —
        what the lifecycle driver's canary judge asks ("how did the
        fleet burn over THIS observation window?", which rarely matches
        the spec's alerting windows). Snapshots now but does NOT append
        a sample or export gauges, so interleaved calls never perturb
        :meth:`evaluate`'s multi-window series. Returns
        ``{spec_name: burn}`` (0.0 while the ring is empty)."""
        now = self._clock()
        snap = self._capture()
        with self._lock:
            samples_view = list(self._samples)
        out: Dict[str, float] = {}
        for spec in self.specs:
            ref = self._reference(samples_view, now, float(seconds))
            criteria = self._spec_burn(spec, snap, ref[1] if ref else None)
            out[spec.name] = max(criteria.values()) if criteria else 0.0
        return out

    def evaluate(self) -> dict:
        """Take a fresh snapshot, compute every spec's fast/slow burn,
        export the gauges, and return the full detail dict::

            {"failing": [names], "specs": {name: {
                "failing": bool,
                "windows": {"fast": {"seconds", "burn", "criteria"},
                            "slow": {...}}}}}
        """
        now = self._clock()
        snap = self._capture()
        with self._lock:
            self._samples.append((now, snap))
            if len(self._samples) > self._max_samples:
                del self._samples[:len(self._samples) - self._max_samples]
            samples_view = list(self._samples)
        detail: dict = {"failing": [], "specs": {}, "threshold":
                        self.threshold}
        for spec in self.specs:
            windows = {}
            over = []
            for label, seconds in zip(("fast", "slow"), spec.windows):
                ref = self._reference(samples_view, now, seconds)
                criteria = self._spec_burn(spec, snap,
                                           ref[1] if ref else None)
                burn = max(criteria.values()) if criteria else 0.0
                self._burn.labels(slo=spec.name, window=label).set(burn)
                windows[label] = {"seconds": seconds, "burn": burn,
                                  "criteria": criteria}
                over.append(burn > self.threshold)
            failing = all(over)
            detail["specs"][spec.name] = {"failing": failing,
                                          "windows": windows}
            if failing:
                detail["failing"].append(spec.name)
        return detail


class SLOVerdict:
    """The gate's answer: truthy when every spec is within budget."""

    __slots__ = ("passing", "failures", "detail")

    def __init__(self, passing: bool, failures: List[str], detail: dict):
        self.passing = passing
        self.failures = list(failures)
        self.detail = detail

    def __bool__(self) -> bool:
        return self.passing

    def __repr__(self):
        state = "passing" if self.passing else \
            f"FAILING({', '.join(self.failures)})"
        return f"SLOVerdict({state})"


class SLOGate:
    """Callable canary judge over an :class:`SLOEngine`: evaluates on
    call and returns an :class:`SLOVerdict` (truthy = healthy). Use as
    the accept/reject check around ``ModelRegistry.roll`` /
    ``rollback``, in CI, or behind ``GET /v1/slo``."""

    def __init__(self, engine: SLOEngine):
        self.engine = engine

    def __call__(self) -> SLOVerdict:
        detail = self.engine.evaluate()
        failing = detail["failing"]
        return SLOVerdict(not failing, failing, detail)
